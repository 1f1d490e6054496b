"""Rounding a rank-r solution back to SE(d), anchoring and ATE (torch).

Port of ``dpgo_ros_tpu/ops/rounding.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from dpgo_ros_tpu_torch.ops.lie import project_to_so, se_compose, se_inverse


def round_solution(X: torch.Tensor) -> torch.Tensor:
    """Round lifted X (n, r, d+1) to an SE(d) trajectory (n, d, d+1).

    SE-Sync rounding: the top-d left singular subspace U_d of the stacked
    r × n(d+1) matrix, X projected through it, the global reflection fixed
    by majority determinant vote, each rotation re-projected to SO(d).
    The result is defined up to a diagonal ±1 gauge of U_d's columns;
    :func:`anchor_to_first_pose` removes it.
    """
    n, r, dp1 = X.shape
    d = dp1 - 1
    M = X.permute(1, 0, 2).reshape(r, n * dp1)
    U, _, _ = torch.linalg.svd(M, full_matrices=False)
    Xd = torch.einsum("rd,nrk->ndk", U[:, :d], X)
    dets = torch.linalg.det(Xd[:, :, :d])
    flip = torch.where(torch.sum(torch.sign(dets)) < 0, -1.0, 1.0).to(X.dtype)
    Xd = torch.cat([Xd[:, : d - 1], Xd[:, d - 1:] * flip], dim=1)
    Rr = project_to_so(Xd[:, :, :d])
    return torch.cat([Rr, Xd[:, :, d:]], dim=-1)


def round_via_lifting(X: torch.Tensor, Ylift: torch.Tensor) -> torch.Tensor:
    """Per-pose world-frame recovery through the shared lifting matrix:
    R_i = proj_SO(YLiftᵀ Y_i), t_i = YLiftᵀ p_i — how a robot recovers its
    SE(d) poses mid-solve (the reference's ``getPoseInGlobalFrame``), with
    no global SVD. Exact when X = YLift·T; :func:`round_solution` is the
    final-answer variant."""
    d = X.shape[-1] - 1
    Z = torch.einsum("rd,nrk->ndk", Ylift, X)
    return torch.cat([project_to_so(Z[:, :, :d]), Z[:, :, d:]], dim=-1)


def anchor_to_first_pose(
    T: torch.Tensor, anchor: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """T'_i = anchor ∘ T_0⁻¹ ∘ T_i, so T'_0 is the anchor (identity by
    default)."""
    rel = se_compose(se_inverse(T[0])[None], T)
    if anchor is not None:
        rel = se_compose(anchor[None], rel)
    return rel


def align_umeyama(est: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """SE(d)-align est translations to ref (no scale); returns aligned est."""
    d = est.shape[1]
    te, tr = est[:, :, d], ref[:, :, d]
    mue, mur = te.mean(0), tr.mean(0)
    H = (te - mue).T @ (tr - mur)
    R = project_to_so(H.T)
    t = mur - R @ mue
    A = torch.cat([R, t[:, None]], dim=-1)
    return se_compose(A.expand(est.shape[0], d, d + 1), est)


def ate_translation(
    est: torch.Tensor, ref: torch.Tensor, align: bool = True
) -> torch.Tensor:
    """RMSE absolute trajectory error over translations."""
    d = est.shape[1]
    if align:
        est = align_umeyama(est, ref)
    diff = est[:, :, d] - ref[:, :, d]
    return torch.sqrt(torch.mean(torch.sum(diff * diff, dim=-1)))
