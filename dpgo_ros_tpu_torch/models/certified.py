"""Certifiably correct centralized solve: the Riemannian staircase.

Port of ``dpgo_ros_tpu/models/certified.py``. Solve the rank-r relaxation
tight, run the dual certificate (``ops/certificate.py``), and where S has
negative curvature ascend one rank along the escape eigenvector and solve
again — ending at a certified global optimum of the SDP relaxation (and,
where rank(X) = d, of the SE(d) problem).

The solves are the plain ``models/local_solvers.rtr_solve`` on the tensors'
device (fp64 by default, as the JAX package's staircase runs XLA
``rtr_solve`` in fp64 and never its fp32 kernel), then a Riemannian Newton
polish whose KKT system scipy factors on the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from dpgo_ros_tpu_torch.models.local_solvers import RTRParams, rtr_solve
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import certificate, chordal, quadratic, rounding, stiefel


class CertifiedResult(NamedTuple):
    X: torch.Tensor  # final lifted solution (n, r_final, d+1)
    T: np.ndarray  # rounded (and refined) SE(d) trajectory (n, d, d+1)
    cost: float  # f(X): the certified SDP optimum when certified
    rounded_cost: float  # f of the raw rank-d rounding
    refined_cost: float  # f after a rank-d solve from the rounding; equal
    # to cost (to solver tolerance) iff the relaxation is tight
    certified: bool
    rank: int
    min_eig: float
    crit_residual: float
    ranks_tried: tuple
    min_eig_check: Optional[float] = None
    margin_verified: bool = True


def _gradnorm(X, e):
    g = quadratic.rgrad(X, e)
    return g, float(torch.linalg.vector_norm(g))


def _newton_polish(X, e, gradnorm_tol: float, max_newton: int = 25, verbose: bool = False):
    """Host sparse-KKT Riemannian Newton polish. The Riemannian Hessian of
    the lifted cost is Hess f[V] = 2·Proj_X(S V), S = Q − Λ̂, so a tangent
    Newton step is one sparse KKT solve

        [S ⊗ I_r + τI,  Cᵀ] [v]   [−proj(Q X)]
        [C,             0 ] [λ] = [0],

    C the per-pose tangency constraints sym(Yᵢᵀ V_Yᵢ) = 0 and τ a
    Levenberg damping raised ×100 until the retracted step lowers the
    gradient norm (at most 8 tries per step; the last accepted τ / 100
    starts the next step). Returns (X, gradnorm)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as sla

    n, r, dp1 = X.shape
    d = dp1 - 1
    N = n * dp1
    g, gn = _gradnorm(X, e)
    tau_carry = None
    for it in range(max_newton):
        if gn <= gradnorm_tol:
            break
        S = certificate.s_sparse(X, certificate.lambda_blocks(X, e), e)
        A = sp.kron(sp.identity(r, format="csr"), S, format="csr")
        # constraint (a, b), pose i: Σ_ρ Y[i,ρ,a] V[i,ρ,b] + Y[i,ρ,b] V[i,ρ,a];
        # V[i,ρ,c] is entry ρ·N + i·dp1 + c of v
        Xn = X.detach().cpu().numpy().astype(np.float64)
        rows, cols, vals = [], [], []
        ci = 0
        for a in range(d):
            for b in range(a, d):
                for rho in range(r):
                    base = rho * N + np.arange(n) * dp1
                    rows += [ci + np.arange(n)] * 2
                    cols += [base + b, base + a]
                    vals += [Xn[:, rho, a], Xn[:, rho, b]]
                ci += n
        C = sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                          shape=(ci, r * N)).tocsr()
        gp = g.detach().cpu().numpy().astype(np.float64) / 2.0  # g = 2·proj(QX)
        rhs = np.concatenate([-np.transpose(gp, (1, 0, 2)).reshape(r, N).ravel(),
                              np.zeros(ci)])
        scale = max(float(abs(S).max()), 1.0)
        tau = max(tau_carry / 100.0, 1e-10 * scale) if tau_carry is not None else 1e-10 * scale
        accepted = False
        for _ in range(8):
            K = sp.bmat([[A + tau * sp.identity(r * N, format="csr"), C.T], [C, None]],
                        format="csc")
            try:
                sol = sla.splu(K).solve(rhs)
            except RuntimeError:
                tau = max(tau * 100.0, 1e-8 * scale)
                continue
            v = sol[: r * N].reshape(r, n, dp1).transpose(1, 0, 2)
            V = stiefel.proj_tangent(X, torch.as_tensor(v, dtype=X.dtype, device=X.device))
            X_try = stiefel.retract_polar(X, V)
            g_try, gn_try = _gradnorm(X_try, e)
            if np.isfinite(gn_try) and gn_try < gn:
                X, g, gn = X_try, g_try, gn_try
                accepted, tau_carry = True, tau
                break
            tau = max(tau * 100.0, 1e-8 * scale)
        if verbose:
            print(f"[newton_polish] it={it} gn={gn:.3e} tau={tau:.1e} accepted={accepted}",
                  flush=True)
        if not accepted:
            break
    return X, gn


def _tight_rtr(X, e, params: RTRParams, rounds: int, use_newton: bool = True,
               verbose: bool = False):
    """Reach the gradient tolerance: full-width RTR rounds at a loose
    tolerance (4 orders below the initial gradient) into the Newton basin,
    the Newton polish, and full-budget RTR rounds as the fallback.
    Returns (X, OptResult of the last phase)."""
    n = X.shape[0]
    mask = torch.ones((n, 1, 1), dtype=X.dtype, device=X.device)
    Pinv = quadratic.precond_inverse(quadratic.precond_blocks(e, n, damping=1e-2))
    _, g0 = _gradnorm(X, e)
    loose_tol = max(params.gradnorm_tol, 1e-4 * max(g0, 1.0))
    lp = dataclasses.replace(params, gradnorm_tol=loose_tol)
    res = None
    for rd in range(rounds):
        X, res = rtr_solve(X, e, mask, Pinv, lp)
        if verbose:
            print(f"[tight_rtr] loose round {rd}: f={float(res.f_opt):.6f} "
                  f"gn={float(res.gradnorm_opt):.3e}", flush=True)
        if float(res.gradnorm_opt) <= loose_tol:
            break
    if use_newton and float(res.gradnorm_opt) > params.gradnorm_tol:
        X, gn = _newton_polish(X, e, params.gradnorm_tol, verbose=verbose)
        res = res._replace(gradnorm_opt=torch.tensor(gn, dtype=X.dtype),
                           f_opt=quadratic.cost(X, e))
    if float(res.gradnorm_opt) > params.gradnorm_tol:
        for _ in range(rounds):
            X, res = rtr_solve(X, e, mask, Pinv, params)
            if float(res.gradnorm_opt) <= params.gradnorm_tol:
                break
    return X, res


def initial_point(prob: LiftedProblem, init: str = "chordal", init_seed: int = 0,
                  ylift=None) -> torch.Tensor:
    """The staircase's starting point at rank ``prob.r``: the chordal
    initialization lifted through YLift (``"chordal"``), the same with a
    large tangent kick (``"perturbed"``: lands in suboptimal basins at r =
    d), or a random point (``"random"``). Draws come from a CPU
    ``torch.Generator`` seeded with ``init_seed`` (0 for chordal's YLift,
    as the JAX package's key 0); ``ylift`` (r, d) replaces YLift."""
    n, r, d = prob.n, prob.r, prob.d
    dt, dev = prob.dtype, prob.device
    gen = torch.Generator().manual_seed(0 if init == "chordal" else init_seed)
    on = lambda t: t.to(device=dev)
    if init == "random":
        Y0 = stiefel.random_stiefel(gen, n, r, d, dtype=dt, device=dev)
        p0 = 2.0 * on(torch.randn((n, r, 1), generator=gen, dtype=dt))
        return torch.cat([Y0, p0], dim=-1)
    if init not in ("chordal", "perturbed"):
        raise ValueError(f"init={init!r}")
    T0 = rounding.anchor_to_first_pose(chordal.chordal_initialization(prob.edges, n))
    if ylift is not None:
        Yl = torch.as_tensor(np.asarray(ylift), dtype=dt, device=dev)
    elif r == d:
        Yl = torch.eye(d, dtype=dt, device=dev)
    else:
        Yl = stiefel.random_lifting_matrix(gen, r, d, dtype=dt, device=dev)
    X = stiefel.lift_trajectory(T0, Yl)
    if init == "perturbed":
        noise = on(torch.randn(tuple(X.shape), generator=gen, dtype=dt))
        X = stiefel.retract_polar(X, 3.0 * stiefel.proj_tangent(X, noise))
    return X


def certified_solve(
    data,
    r0: Optional[int] = None,
    max_rank: Optional[int] = None,
    gradnorm_tol: float = 1e-6,
    eig_tol: float = 1e-5,
    crit_tol: float = 1e-4,
    rtr_iterations: int = 200,
    rtr_tcg_iterations: int = 400,
    rtr_rounds: int = 20,
    escape_step: float = 1e-2,
    dtype: torch.dtype = torch.float64,
    verbose: bool = False,
    lanczos_maxiter: Optional[int] = None,
    init: str = "chordal",
    init_seed: int = 0,
    device="cuda",
    ylift=None,
    X0=None,
) -> CertifiedResult:
    """Centralized certified solve of a ``PoseGraphData`` on ``device``
    (the card unless the caller names another): start at rank ``r0``
    (default d + 2, SE-Sync's first rung) from :func:`initial_point` (or
    from ``X0``, an (n, r0, d+1) array or tensor), solve tight, certify, and
    on failure ascend one rank along the negative eigenvector with a
    backtracking step (halved up to 30 times until the cost drops) and solve
    again, up to ``max_rank`` (default d + 6). A point not yet critical to
    ``crit_tol`` is solved again at the same rank (up to 5 times)."""
    d = data.d
    r = r0 or d + 2
    max_rank = max_rank or d + 6
    prob = LiftedProblem.from_data(data, r=r, dtype=dtype, device=device)
    e = prob.edges
    params = RTRParams(max_iterations=rtr_iterations, max_tcg_iterations=rtr_tcg_iterations,
                       gradnorm_tol=gradnorm_tol)
    if X0 is not None:
        X = torch.as_tensor(np.asarray(X0) if not isinstance(X0, torch.Tensor) else X0,
                            dtype=dtype, device=prob.device)
    else:
        X = initial_point(prob, init, init_seed, ylift)
    ranks, cert, crit_retries = [], None, 0
    while True:
        if not ranks or ranks[-1] != X.shape[1]:
            ranks.append(X.shape[1])
        X, res = _tight_rtr(X, e, params, rtr_rounds, verbose=verbose)
        cert = certificate.certify(X, e, eig_tol=eig_tol, crit_tol=crit_tol,
                                   maxiter=lanczos_maxiter)
        if verbose:
            print(f"[certified_solve] rank={X.shape[1]} f={float(quadratic.cost(X, e)):.6f} "
                  f"gradnorm={float(res.gradnorm_opt):.2e} crit={cert.crit_residual:.2e} "
                  f"min_eig={cert.min_eig:.3e} global={cert.is_global}", flush=True)
        if cert.is_global or X.shape[1] >= max_rank:
            break
        if cert.eigvec is None:
            crit_retries += 1
            if crit_retries > 5:
                break  # report the uncertified point
            continue
        crit_retries = 0
        Xp, dirn = certificate.escape_direction(X, cert)
        f0 = float(quadratic.cost(Xp, e))
        alpha = escape_step * float(torch.linalg.vector_norm(X)) / max(
            1.0, float(torch.linalg.vector_norm(dirn)))
        for _ in range(30):
            X_try = stiefel.retract_polar(Xp, alpha * dirn)
            if float(quadratic.cost(X_try, e)) < f0:
                break
            alpha *= 0.5
        X = X_try

    T = rounding.anchor_to_first_pose(rounding.round_solution(X))
    # the rank-d rounding's cost, lifted by I_d (the cost is gauge-invariant)
    eye_d = torch.eye(d, dtype=dtype, device=prob.device)
    Xr = stiefel.lift_trajectory(T, eye_d)
    rounded_cost = float(quadratic.cost(Xr, e))
    # local refinement of the rounding at rank d: where the SDP face holds
    # optimizers of rank > d, the raw rounding is a nearby suboptimal point
    Xr, _ = _tight_rtr(Xr, e, params, rtr_rounds)
    refined_cost = float(quadratic.cost(Xr, e))
    if refined_cost < rounded_cost:
        T = rounding.anchor_to_first_pose(rounding.round_solution(Xr))
    return CertifiedResult(
        X=X, T=T.cpu().numpy(), cost=float(quadratic.cost(X, e)),
        rounded_cost=rounded_cost, refined_cost=refined_cost,
        certified=bool(cert.is_global), rank=int(X.shape[1]),
        min_eig=float(cert.min_eig), crit_residual=float(cert.crit_residual),
        ranks_tried=tuple(ranks),
        min_eig_check=None if cert.min_eig_check is None else float(cert.min_eig_check),
        margin_verified=bool(cert.margin_verified),
    )
