"""Chordal initialization: rotation averaging + translation recovery (torch).

Port of ``dpgo_ros_tpu/ops/chordal.py``. Both stages are matrix-free
conjugate-gradient solves over the edge-parallel operators:

Stage 1: minimize Σ_e κ_e ‖R_j − R_i R_e‖_F² over unconstrained R_i with
R_0 = I, then project each block to SO(d).
Stage 2: with rotations fixed, minimize Σ_e τ_e ‖t_j − t_i − R_i t_e‖² with
t_0 = 0 (a weighted graph-Laplacian solve).
"""

from __future__ import annotations

import torch

from dpgo_ros_tpu_torch.ops.lie import project_to_so
from dpgo_ros_tpu_torch.ops.quadratic import EdgeSet, pull_sum
from dpgo_ros_tpu_torch.utils import profiling

# host syncs to test the CG stopping rule happen once per this many steps;
# steps past convergence are frozen, so the iterate equals a per-step test's
CHECK_EVERY = 16


def _rotation_operator(V: torch.Tensor, e: EdgeSet) -> torch.Tensor:
    """L(V)_i += κ (V_i − V_j R_eᵀ) at src; L(V)_j += κ (V_j − V_i R_e) at
    dst. V is (n, d, d)."""
    kw, _ = e.effective_weights()
    Vi, Vj = V[e.src], V[e.dst]
    ci = kw[:, None, None] * (Vi - Vj @ e.R.transpose(-1, -2))
    cj = kw[:, None, None] * (Vj - Vi @ e.R)
    return pull_sum(ci, cj, e.pull)


def _translation_operator(V: torch.Tensor, e: EdgeSet) -> torch.Tensor:
    """Weighted graph Laplacian on (n, d)."""
    _, tw = e.effective_weights()
    c = tw[:, None] * (V[e.src] - V[e.dst])
    return pull_sum(c, -c, e.pull)


@profiling.spanned("chordal.cg")
def _cg(matvec, b, x0, max_iters: int, tol: float):
    """Plain CG, stopping once ‖r‖² ≤ tol²‖b‖² or after max_iters steps.

    The stopping rule is evaluated on the device at every step (a step
    after convergence leaves the state unchanged) and read on the host
    every CHECK_EVERY steps, so the result is that of a per-step test.
    Counts its steps (``chordal.cg_steps``) and those reads
    (``chordal.host_syncs``)."""
    x = x0
    r = b - matvec(x0)
    p = r
    rs = torch.sum(r * r)
    thresh = tol * tol * torch.clamp(torch.sum(b * b), min=1e-30)
    steps = syncs = 0
    for it in range(max_iters):
        if it % CHECK_EVERY == 0:
            syncs += 1
            if not bool(rs > thresh):
                break
        steps += 1
        active = rs > thresh
        Ap = matvec(p)
        denom = torch.sum(p * Ap)
        alpha = torch.where(
            denom > 0, rs / torch.clamp(denom, min=1e-30),
            torch.zeros_like(denom),
        )
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        rs_n = torch.sum(r_n * r_n)
        beta = rs_n / torch.clamp(rs, min=1e-30)
        p_n = r_n + beta * p
        x = torch.where(active, x_n, x)
        r = torch.where(active, r_n, r)
        p = torch.where(active, p_n, p)
        rs = torch.where(active, rs_n, rs)
    profiling.count("chordal.cg_steps", steps)
    profiling.count("chordal.host_syncs", syncs)
    return x


def _anchor_mask(n: int, ndim: int, like: torch.Tensor) -> torch.Tensor:
    m = torch.ones((n,) + (1,) * (ndim - 1), dtype=like.dtype, device=like.device)
    m[0] = 0.0
    return m


def chordal_rotations(
    e: EdgeSet, n: int, max_iters: int = 200, tol: float = 1e-8
) -> torch.Tensor:
    """Chordal rotation initialization → (n, d, d) in SO(d), pose 0 = I.

    Solves L x = 0 with x_0 = I pinned: x = x_a + z with z off-anchor and
    M L(z) = −M L(x_a), M zeroing the anchor row."""
    d = e.d
    mask = _anchor_mask(n, 3, e.R)
    xa = torch.zeros((n, d, d), dtype=e.R.dtype, device=e.R.device)
    xa[0] = torch.eye(d, dtype=e.R.dtype, device=e.R.device)
    b = -mask * _rotation_operator(xa, e)
    z = _cg(
        lambda v: mask * _rotation_operator(mask * v, e), b,
        torch.zeros_like(xa), max_iters, tol,
    )
    return project_to_so(xa + mask * z)


def recover_translations(
    R: torch.Tensor, e: EdgeSet, max_iters: int = 200, tol: float = 1e-8
) -> torch.Tensor:
    """Translation recovery given rotations → (n, d), pose 0 = 0. Solves
    L(t) = −g with g_i = Σ_{src=i} τ R_i t_e, g_j = −Σ_{dst=j} τ R_i t_e."""
    n, d = R.shape[0], R.shape[-1]
    mask = _anchor_mask(n, 2, R)
    _, tw = e.effective_weights()
    Rt = tw[:, None] * (R[e.src] @ e.t[..., None])[..., 0]
    b = mask * pull_sum(-Rt, Rt, e.pull)
    t = _cg(
        lambda v: mask * _translation_operator(mask * v, e), b,
        torch.zeros((n, d), dtype=R.dtype, device=R.device), max_iters, tol,
    )
    return mask * t


def chordal_initialization(
    e: EdgeSet, n: int, max_iters: int = 200, tol: float = 1e-8
) -> torch.Tensor:
    """Full chordal init → (n, d, d+1) trajectory with pose 0 at identity."""
    R = chordal_rotations(e, n, max_iters, tol)
    t = recover_translations(R, e, max_iters, tol)
    return torch.cat([R, t[..., None]], dim=-1)
