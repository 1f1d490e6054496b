"""Batched SO(d)/SE(d) operations on torch tensors.

Port of ``dpgo_ros_tpu/ops/lie.py``. Transforms are ``(..., d, d+1)``
``[R | t]`` blocks; every function is batched over leading axes.
"""

from __future__ import annotations

from typing import Optional

import torch


def project_to_so(M: torch.Tensor) -> torch.Tensor:
    """Project (..., d, d) matrices onto SO(d) (nearest rotation, Frobenius):
    R = U diag(1, ..., 1, det(U Vᵀ)) Vᵀ."""
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    d = M.shape[-1]
    S = torch.cat(
        [torch.ones(M.shape[:-2] + (d - 1,), dtype=M.dtype, device=M.device),
         det[..., None]],
        dim=-1,
    )
    return (U * S[..., None, :]) @ Vt


def se_compose(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """Compose (..., d, d+1) rigid transforms: (Ra, ta) ∘ (Rb, tb) =
    (Ra Rb, ta + Ra tb)."""
    d = Ta.shape[-2]
    Ra, ta = Ta[..., :d], Ta[..., d]
    Rb, tb = Tb[..., :d], Tb[..., d]
    R = Ra @ Rb
    t = ta + torch.einsum("...ij,...j->...i", Ra, tb)
    return torch.cat([R, t[..., None]], dim=-1)


def se_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., d, d+1) rigid transforms: (R, t) ↦ (Rᵀ, −Rᵀ t)."""
    d = T.shape[-2]
    R, t = T[..., :d], T[..., d]
    Rt = R.transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, t)
    return torch.cat([Rt, ti[..., None]], dim=-1)


def se_identity(d: int, *, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.cat(
        [torch.eye(d, dtype=dtype, device=device),
         torch.zeros((d, 1), dtype=dtype, device=device)],
        dim=-1,
    )


def rotation_geodesic_distance(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Angular distance (radians) between (..., d, d) rotations."""
    tr = torch.einsum("...ij,...ij->...", Ra, Rb)
    c = (tr - 1.0) / 2.0 if Ra.shape[-1] == 3 else tr / 2.0
    return torch.arccos(torch.clamp(c, -1.0, 1.0))


def odometry_chain(
    rel: torch.Tensor, T0: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Integrate (n-1, d, d+1) relative transforms into (n, d, d+1) absolute
    poses: pose i = T0 ∘ rel[0] ∘ … ∘ rel[i-1].

    Parallel prefix by recursive doubling (log₂ n batched composes), the
    counterpart of the JAX package's ``lax.associative_scan``.
    """
    d = rel.shape[-2]
    if T0 is None:
        T0 = se_identity(d, dtype=rel.dtype, device=rel.device)
    A = torch.cat([T0[None], rel], dim=0)
    s = 1
    while s < A.shape[0]:
        A = torch.cat([A[:s], se_compose(A[:-s], A[s:])], dim=0)
        s *= 2
    return A
