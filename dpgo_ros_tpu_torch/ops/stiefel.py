"""The lifted pose manifold M = (St(d, r) × R^r)^n on torch tensors.

Port of ``dpgo_ros_tpu/ops/stiefel.py``. State layout ``X`` of shape
``(n, r, d+1)``: ``X[i, :, :d] = Y_i`` has orthonormal columns and
``X[i, :, d] = p_i`` is the lifted translation.
"""

from __future__ import annotations

from typing import Tuple

import torch


def split(X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, r, d+1) -> Y (n, r, d), p (n, r)."""
    d = X.shape[-1] - 1
    return X[..., :d], X[..., d]


def join(Y: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return torch.cat([Y, p[..., None]], dim=-1)


def sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + M.transpose(-1, -2))


def proj_tangent(X: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Tangent projection at X: V_Y − Y sym(Yᵀ V_Y); p component free."""
    Y, _ = split(X)
    VY, Vp = split(V)
    return join(VY - Y @ sym(Y.transpose(-1, -2) @ VY), Vp)


def retract_polar(X: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Polar retraction: A = Y + V_Y ↦ A (AᵀA)^{-1/2} through a batched
    d×d eigendecomposition (eigenvalues floored at 1e-12); the translation
    moves Euclidean."""
    Y, p = split(X)
    VY, Vp = split(V)
    A = Y + VY
    w, Q = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    w = torch.clamp(w, min=1e-12)
    Minvsqrt = torch.einsum("nab,nb,ncb->nac", Q, torch.rsqrt(w), Q)
    return join(A @ Minvsqrt, p + Vp)


def retract_polar_ns(
    X: torch.Tensor, V: torch.Tensor, iters: int = 20
) -> torch.Tensor:
    """Polar retraction by Newton–Schulz: Z ← ½ Z (3I − ZᵀZ), started from
    A = Y + V_Y scaled by 1/‖A‖_F (floor 1e-12) so σ_max ≤ 1; the
    translation moves Euclidean."""
    d = X.shape[-1] - 1
    Y, p = split(X)
    VY, Vp = split(V)
    A = Y + VY
    tr = torch.sum(A * A, dim=(-2, -1))
    s = torch.rsqrt(torch.clamp(tr, min=1e-12))[:, None, None]
    Z = A * s
    I3 = torch.eye(d, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        Z = 0.5 * (Z @ (3.0 * I3 - Z.transpose(-1, -2) @ Z))
    return join(Z, p + Vp)


def retract_qr(X: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """QR retraction (sign-fixed thin QR of the r×d blocks)."""
    Y, p = split(X)
    VY, Vp = split(V)
    Q, R = torch.linalg.qr(Y + VY)
    s = torch.sign(torch.diagonal(R, dim1=-2, dim2=-1))
    s = torch.where(s == 0, torch.ones_like(s), s)
    return join(Q * s[..., None, :], p + Vp)


def random_stiefel(
    generator: torch.Generator, n: int, r: int, d: int,
    *, dtype: torch.dtype = torch.float64, device="cpu",
) -> torch.Tensor:
    """Random point on St(d, r)^n (sign-fixed QR of a Gaussian). Sampled on
    the generator's device, then moved to ``device``."""
    A = torch.randn(
        (n, r, d), generator=generator, dtype=dtype,
        device=generator.device,
    )
    Q, R = torch.linalg.qr(A)
    s = torch.sign(torch.diagonal(R, dim1=-2, dim2=-1))
    s = torch.where(s == 0, torch.ones_like(s), s)
    return (Q * s[..., None, :]).to(device)


def random_lifting_matrix(
    generator: torch.Generator, r: int, d: int,
    *, dtype: torch.dtype = torch.float64, device="cpu",
) -> torch.Tensor:
    """The shared r×d lifting matrix YLift ∈ St(d, r)."""
    return random_stiefel(generator, 1, r, d, dtype=dtype, device=device)[0]


def lift_trajectory(T: torch.Tensor, Ylift: torch.Tensor) -> torch.Tensor:
    """Lift (n, d, d+1) SE(d) poses to (n, r, d+1): X_i = YLift T_i."""
    return torch.einsum("rd,ndk->nrk", Ylift, T)


def inner(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    return torch.sum(U * V)


def tangent_norm(V: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(V * V))


def check_on_manifold(X: torch.Tensor) -> torch.Tensor:
    """Max deviation of Y_iᵀ Y_i from the identity (diagnostic)."""
    Y, _ = split(X)
    I = torch.eye(Y.shape[-1], dtype=X.dtype, device=X.device)
    return torch.max(torch.abs(Y.transpose(-1, -2) @ Y - I))
