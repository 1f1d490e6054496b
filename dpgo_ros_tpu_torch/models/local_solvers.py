"""Riemannian trust-region block solve (RTR with Steihaug tCG), plain torch.

Port of ``dpgo_ros_tpu/models/local_solvers.py``: RTR, and preconditioned
RGD (the fleet's asynchronous agents and ``solver = RGD`` run
:func:`rgd_solve`, plain PyTorch on any device, as JAX's agents run XLA's;
the ASAPP engine's tick is the K3 kernel). Every tangent
vector is multiplied by a per-pose ``mask`` (n, 1, 1): mask∘Hess∘mask is
the block Hessian, so a masked solve on the global state is the local
(block) trust-region solve of RBCD.

This is the plain version of the CUDA block-solve kernel
(``ops/fused_rtr.py``): the same arithmetic, one torch op at a time, with
the loop tests read on the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from dpgo_ros_tpu_torch.ops import quadratic, stiefel
from dpgo_ros_tpu_torch.ops.quadratic import EdgeSet


@dataclasses.dataclass(frozen=True)
class RGDParams:
    """Riemannian gradient descent knobs (``RGD_stepsize``,
    ``RGD_use_preconditioner``, reference ``launch/PGOAgent.launch:17-18``)."""

    stepsize: float = 1e-3
    use_preconditioner: bool = True
    precond_damping: float = 1e-2


@dataclasses.dataclass(frozen=True)
class RTRParams:
    """Trust-region knobs (reference ``launch/PGOAgent.launch:19-21``)."""

    max_iterations: int = 3
    max_tcg_iterations: int = 50
    gradnorm_tol: float = 1e-2
    initial_radius: float = 1e1
    max_radius: float = 1e4
    use_preconditioner: bool = True
    tcg_kappa: float = 0.1
    tcg_theta: float = 1.0


class OptResult(NamedTuple):
    """Solve telemetry: fInit/fOpt/gradNormInit/gradNormOpt, TR iterations
    and the number of tCG iterations executed (Hessian applications)."""

    f_init: torch.Tensor
    f_opt: torch.Tensor
    gradnorm_init: torch.Tensor
    gradnorm_opt: torch.Tensor
    iterations: int
    tcg_iterations: int


def eps_for(dtype: torch.dtype) -> float:
    """Division guard: 1e-300 in fp64, 1e-30 (representable) in fp32."""
    return 1e-300 if dtype == torch.float64 else 1e-30


def _masked_rgrad(X, e: EdgeSet, mask):
    return mask * quadratic.rgrad(X, e)


def _masked_precond(Pinv, X, V, mask):
    return mask * stiefel.proj_tangent(X, quadratic.precond_apply(Pinv, V))


def rgd_step(
    X: torch.Tensor,
    e: EdgeSet,
    mask: torch.Tensor,
    Pinv: Optional[torch.Tensor],
    params: RGDParams,
) -> torch.Tensor:
    """One preconditioned Riemannian gradient step on the masked block."""
    g = _masked_rgrad(X, e, mask)
    if params.use_preconditioner and Pinv is not None:
        g = _masked_precond(Pinv, X, g, mask)
    return stiefel.retract_polar_ns(X, -params.stepsize * g)


def _tcg(X, e, mask, G, Pinv, radius, params: RTRParams):
    """Steihaug–Toint truncated CG for min_η <g,η> + ½<η,Hess[η]>,
    ‖η‖ ≤ radius, on the masked block. Returns (η, Hη, g, iterations)."""
    eps = eps_for(X.dtype)
    g = mask * stiefel.proj_tangent(X, G)

    def prec(v):
        if params.use_preconditioner and Pinv is not None:
            return _masked_precond(Pinv, X, v, mask)
        return v

    def hess(v):
        return mask * quadratic.rhess_vp(X, v, e, G)

    r = g
    z = prec(r)
    r_z = stiefel.inner(r, z)
    eta = torch.zeros_like(X)
    Heta = torch.zeros_like(X)
    delta = -z
    r0_norm = torch.sqrt(torch.clamp(stiefel.inner(r, r), min=eps))
    target = r0_norm * torch.clamp(r0_norm ** params.tcg_theta,
                                   max=params.tcg_kappa)
    k = 0
    while k < params.max_tcg_iterations:
        Hd = hess(delta)
        dHd = stiefel.inner(delta, Hd)
        alpha = r_z / torch.where(dHd > 0, dHd, torch.ones_like(dHd))
        eta_try = eta + alpha * delta
        hit = bool(dHd <= 0) or bool(
            stiefel.inner(eta_try, eta_try) >= radius * radius
        )
        k += 1
        if hit:
            ee = stiefel.inner(eta, eta)
            ed = stiefel.inner(eta, delta)
            dd = torch.clamp(stiefel.inner(delta, delta), min=eps)
            disc = torch.clamp(ed * ed + dd * (radius * radius - ee), min=0.0)
            tau = (-ed + torch.sqrt(disc)) / dd
            eta = eta + tau * delta
            Heta = Heta + tau * Hd
            break
        eta = eta_try
        Heta = Heta + alpha * Hd
        r = r + alpha * Hd
        if bool(torch.sqrt(torch.clamp(stiefel.inner(r, r), min=0.0)) <= target):
            break
        z = prec(r)
        r_z_new = stiefel.inner(r, z)
        beta = r_z_new / torch.clamp(r_z, min=eps)
        delta = -z + beta * delta
        r_z = r_z_new
    return eta, Heta, g, k


def rtr_solve(
    X: torch.Tensor,
    e: EdgeSet,
    mask: torch.Tensor,
    Pinv: Optional[torch.Tensor],
    params: RTRParams,
) -> Tuple[torch.Tensor, OptResult]:
    """Riemannian trust-region on the masked block: ρ-test with threshold
    0.1, radius ×¼ below ρ = 0.25, ×2 (capped) above ρ = 0.75 at the
    boundary; at most ``max_iterations`` steps, stopping once the masked
    Riemannian gradient norm is ≤ ``gradnorm_tol``."""
    eps = eps_for(X.dtype)
    f = quadratic.cost(X, e)
    G = quadratic.egrad(X, e)
    f0 = f
    gn0 = stiefel.tangent_norm(mask * stiefel.proj_tangent(X, G))
    gn = gn0
    radius = torch.tensor(params.initial_radius, dtype=X.dtype, device=X.device)
    k = ktot = 0
    while k < params.max_iterations and not bool(gn <= params.gradnorm_tol):
        eta, Heta, g, kt = _tcg(X, e, mask, G, Pinv, radius, params)
        ktot += kt
        pred = -(stiefel.inner(g, eta) + 0.5 * stiefel.inner(eta, Heta))
        X_try = stiefel.retract_polar_ns(X, eta)
        f_try = quadratic.cost(X_try, e)
        rho = (f - f_try) / torch.where(
            torch.abs(pred) > eps, pred, torch.full_like(pred, eps)
        )
        accept = bool(rho > 0.1) and bool(pred > 0)
        eta_norm = stiefel.tangent_norm(eta)
        if bool(rho < 0.25):
            radius = 0.25 * radius
        elif bool(rho > 0.75) and bool(eta_norm >= 0.99 * radius):
            radius = torch.clamp(2.0 * radius, max=params.max_radius)
        if accept:
            X, f, G = X_try, f_try, quadratic.egrad(X_try, e)
        gn = stiefel.tangent_norm(mask * stiefel.proj_tangent(X, G))
        k += 1
    return X, OptResult(
        f_init=f0, f_opt=f, gradnorm_init=gn0, gradnorm_opt=gn,
        iterations=k, tcg_iterations=ktot,
    )


def rgd_solve(
    X: torch.Tensor,
    e: EdgeSet,
    mask: torch.Tensor,
    Pinv: Optional[torch.Tensor],
    params: RGDParams,
    num_steps: int = 1,
) -> Tuple[torch.Tensor, OptResult]:
    """``num_steps`` preconditioned RGD steps (the ASAPP local loop,
    reference ``asynchronous_rate`` semantics); no tCG."""
    f0 = quadratic.cost(X, e)
    gn0 = stiefel.tangent_norm(_masked_rgrad(X, e, mask))
    Xn = X
    for _ in range(num_steps):
        Xn = rgd_step(Xn, e, mask, Pinv, params)
    return Xn, OptResult(
        f_init=f0, f_opt=quadratic.cost(Xn, e), gradnorm_init=gn0,
        gradnorm_opt=stiefel.tangent_norm(_masked_rgrad(Xn, e, mask)),
        iterations=num_steps, tcg_iterations=0,
    )
