"""The lifted PGO quadratic form and its edge-parallel operators (torch).

Port of ``dpgo_ros_tpu/ops/quadratic.py``. The cost over lifted poses is

  f(X) = Σ_e w_e [ κ_e ‖Y_j − Y_i R_e‖_F² + τ_e ‖p_j − p_i − Y_i t_e‖² ],

a homogeneous quadratic, so the Euclidean gradient 2Q(X) is linear in X and
doubles as the Euclidean Hessian-vector product. Per-edge contributions are
accumulated into poses by the transpose-incidence *pull index* (a CSR-style
gather-sum in a fixed order), never by ``index_add_``: the sum order is the
same on every run and on every device, so results are deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from dpgo_ros_tpu_torch.ops import stiefel


@dataclasses.dataclass
class EdgeSet:
    """Struct-of-arrays edge data on one device.

    ``src``/``dst`` are flattened global pose indices. ``weight`` is the
    robust weight and ``mask`` zeroes padding edges. ``pull`` (n, D) int32
    is the gather index of :func:`build_pull_index`.
    """

    src: torch.Tensor  # (E,) int64
    dst: torch.Tensor  # (E,) int64
    R: torch.Tensor  # (E, d, d)
    t: torch.Tensor  # (E, d)
    kappa: torch.Tensor  # (E,)
    tau: torch.Tensor  # (E,)
    weight: torch.Tensor  # (E,)
    mask: torch.Tensor  # (E,) 1 real / 0 padding
    is_loop: torch.Tensor  # (E,) 1 if a GNC-adjustable loop closure
    pull: torch.Tensor  # (n, D) int32

    @property
    def d(self) -> int:
        return int(self.R.shape[-1])

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def effective_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(κ_eff, τ_eff) = mask · weight · (κ, τ)."""
        w = self.mask * self.weight
        return w * self.kappa, w * self.tau


def build_pull_index(src, dst, n: int) -> np.ndarray:
    """Host-side (n, D) transpose-incidence gather index.

    Row i lists the contribution rows of pose i in edge order: edge k as
    src ↦ k, edge k as dst ↦ E + k; padded with 2·E, the zero row that
    :func:`pull_sum` and the CUDA kernel append. D is the largest pose
    degree. Same index as the JAX package's ``build_pull_index`` (without
    its padded-row option), vectorized.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    E = src.shape[0]
    k = np.arange(E, dtype=np.int64)
    pose = np.concatenate([src, dst])
    rows = np.concatenate([k, E + k])
    order_key = np.concatenate([2 * k, 2 * k + 1])  # edge order, src first
    order = np.lexsort((order_key, pose))
    pose, rows = pose[order], rows[order]
    deg = np.bincount(pose, minlength=n)
    D = max(1, int(deg.max()) if deg.size else 1)
    start = np.concatenate([[0], np.cumsum(deg)[:-1]])
    slot = np.arange(pose.size) - start[pose]
    out = np.full((n, D), 2 * E, np.int32)
    out[pose, slot] = rows
    return out


def pull_sum(
    contrib_src: torch.Tensor, contrib_dst: torch.Tensor, pull: torch.Tensor
) -> torch.Tensor:
    """Accumulate (E, ...) per-edge src/dst contributions into (n, ...) per-
    pose sums through the pull index (row 2E is the zero row)."""
    zero = torch.zeros(
        (1,) + contrib_src.shape[1:], dtype=contrib_src.dtype,
        device=contrib_src.device,
    )
    C = torch.cat([contrib_src, contrib_dst, zero], dim=0)
    return C[pull.long()].sum(dim=1)


def residuals(X: torch.Tensor, e: EdgeSet) -> Tuple[torch.Tensor, torch.Tensor]:
    """r1 = Y_j − Y_i R_e (E, r, d), r2 = p_j − p_i − Y_i t_e (E, r)."""
    d = e.d
    Xi, Xj = X[e.src], X[e.dst]
    Yi, pi = Xi[..., :d], Xi[..., d]
    Yj, pj = Xj[..., :d], Xj[..., d]
    r1 = Yj - Yi @ e.R
    r2 = pj - pi - (Yi @ e.t[..., None])[..., 0]
    return r1, r2


def cost(X: torch.Tensor, e: EdgeSet) -> torch.Tensor:
    """f(X), the global objective."""
    r1, r2 = residuals(X, e)
    kw, tw = e.effective_weights()
    return torch.sum(kw * torch.sum(r1 * r1, dim=(-2, -1))) + torch.sum(
        tw * torch.sum(r2 * r2, dim=-1)
    )


def egrad(X: torch.Tensor, e: EdgeSet) -> torch.Tensor:
    """Euclidean gradient ∇f(X) = 2 Q(X), shape (n, r, d+1). Linear in X, so
    it is also the Euclidean Hessian-vector product."""
    r1, r2 = residuals(X, e)
    kw, tw = e.effective_weights()
    kr1 = 2.0 * kw[:, None, None] * r1  # (E, r, d)
    tr2 = 2.0 * tw[:, None] * r2  # (E, r)
    # src pose i: −kr1 Rᵀ − tr2 tᵀ on Y, −tr2 on p; dst pose j: +kr1, +tr2
    gYi = -(kr1 @ e.R.transpose(-1, -2)) - tr2[:, :, None] * e.t[:, None, :]
    gi = torch.cat([gYi, -tr2[..., None]], dim=-1)
    gj = torch.cat([kr1, tr2[..., None]], dim=-1)
    return pull_sum(gi, gj, e.pull)


def apply_Q(V: torch.Tensor, e: EdgeSet) -> torch.Tensor:
    """Q(V) = egrad(V) / 2."""
    return 0.5 * egrad(V, e)


def rgrad(
    X: torch.Tensor, e: EdgeSet, G: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Riemannian gradient: tangent projection of the Euclidean gradient."""
    if G is None:
        G = egrad(X, e)
    return stiefel.proj_tangent(X, G)


def rhess_vp(
    X: torch.Tensor, V: torch.Tensor, e: EdgeSet,
    G: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Riemannian Hessian-vector product:
    Proj( ehess[V] − [V_Y sym(Yᵀ G_Y), 0] )."""
    d = X.shape[-1] - 1
    if G is None:
        G = egrad(X, e)
    EH = egrad(V, e)
    S = stiefel.sym(X[..., :d].transpose(-1, -2) @ G[..., :d])
    corr = torch.cat([V[..., :d] @ S, torch.zeros_like(V[..., d:])], dim=-1)
    return stiefel.proj_tangent(X, EH - corr)


def precond_blocks(
    e: EdgeSet, n: int, damping: float = 1e-2
) -> torch.Tensor:
    """Per-pose damped (d+1)×(d+1) diagonal blocks of Q:
    D_i += [[κI + τ t tᵀ, τ t], [τ tᵀ, τ]] (src), D_j += diag(κI, τ) (dst)."""
    d = e.d
    kw, tw = e.effective_weights()
    kw = kw.to(e.R.dtype)
    tw = tw.to(e.R.dtype)
    E = e.num_edges
    I = torch.eye(d, dtype=e.R.dtype, device=e.R.device)
    ttT = e.t[:, :, None] * e.t[:, None, :]
    Dii = torch.zeros((E, d + 1, d + 1), dtype=e.R.dtype, device=e.R.device)
    Dii[:, :d, :d] = kw[:, None, None] * I + tw[:, None, None] * ttT
    Dii[:, :d, d] = tw[:, None] * e.t
    Dii[:, d, :d] = tw[:, None] * e.t
    Dii[:, d, d] = tw
    Djj = torch.zeros_like(Dii)
    Djj[:, :d, :d] = kw[:, None, None] * I
    Djj[:, d, d] = tw
    D = pull_sum(Dii, Djj, e.pull)
    scale = torch.clamp(
        torch.diagonal(D, dim1=-2, dim2=-1).sum(-1)[:, None, None] / (d + 1),
        min=1.0,
    )
    return D + damping * scale * torch.eye(
        d + 1, dtype=e.R.dtype, device=e.R.device
    )


def precond_solve(P: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """V_i ← V_i P_i⁻¹ by a batched Cholesky solve of the SPD blocks
    (row-vector convention). Hot loops use :func:`precond_inverse` once
    and :func:`precond_apply` instead."""
    L = torch.linalg.cholesky(P)
    Z = torch.linalg.solve_triangular(L, V.transpose(-1, -2), upper=False)
    Xt = torch.linalg.solve_triangular(L.transpose(-1, -2), Z, upper=True)
    return Xt.transpose(-1, -2)


def precond_inverse(P: torch.Tensor) -> torch.Tensor:
    """Batched inverse of the SPD blocks through Cholesky: L⁻ᵀ L⁻¹."""
    L = torch.linalg.cholesky(P)
    eye = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device).expand(
        P.shape
    )
    Z = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.einsum("nki,nkj->nij", Z, Z)


def precond_apply(Pinv: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """V_i ← V_i P_i⁻¹ (row-vector convention)."""
    return V @ Pinv
