"""The plain reference of the accelerated configurations: Nesterov-
accelerated RoundRobin RBCD with RTR blocks, L2, in float64.

Written for the benchmark from the published description of accelerated
RBCD (mit-acl/dpgo's acceleration, launch/PGOAgent.launch's
``acceleration`` and ``restart_interval``), on ``benchmark/reference.py``'s
problem, block solver, chordal initialization, lift and rounding; it
imports nothing of the program. Update ``it`` (robot it mod R, in turn):

* the robot's block is solved against the auxiliary state V: its
  separators are read from V and its solve starts from V's block;
* X_acc is X with that block, and f_acc its world cost;
* the block's V is extrapolated: V_k = Retr(X_acc, β·proj(X_acc, X_acc −
  X_prev)), X_prev being the block's value before its last update, with β
  fixed (``acceleration_beta``) or from the θ-sequence (θ' = (1 +
  √(1 + 4θ²)) / 2, β = (θ − 1)/θ');
* with ``acceleration_safeguard``, if f_acc exceeds the cost the state
  holds, the update restarts: the block solved again from X, θ = 1 and
  V = X everywhere;
* every ``restart_interval`` updates θ is reset to 1;
* a robot's relative change is its block's Frobenius movement, passed to
  its neighbours as a lower bound; the solve stops once every change is
  under the tolerance, as ``reference.Schedule`` has it.

Departures from the program, each the exact form of an approximation it
makes: the extrapolation's retraction is the exact polar factor (an SVD),
where the program runs 20 Newton–Schulz iterations; the solve runs on the
host's or the card's float64, the program's in float32. The control
(``control=True``) computes the same in float32 with TF32 products
(``reference.Arith``), the SVD in float32.

It refuses what it does not implement: robust costs, the Parallel and
Uniform rules, RGD, a run without acceleration (``references/rbcd.py``'s)
and a relative change other than the block's Frobenius norm.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from benchmark import reference as ref
from benchmark.reference import lifting_matrix, rounded, state_cost  # noqa: F401

NUMBERS = ("traj", "cost", "state_cost", "rounding")
EXACT = ("schedule",)


def _checked(cfg: Dict) -> None:
    """Raises on a configuration this reference does not run."""
    if not cfg.get("acceleration", False):
        raise ValueError("this reference runs accelerated RBCD; references/rbcd.py runs "
                         "it without acceleration")
    if cfg["update_rule"] != "RoundRobin":
        raise ValueError("the accelerated reference runs the RoundRobin rule")
    if cfg.get("robust_cost_type", "L2") != "L2":
        raise ValueError("the accelerated reference runs the L2 cost")
    if cfg.get("solver") not in (None, "RTR") or cfg.get("asynchronous", False):
        raise ValueError("the accelerated reference runs RTR block solves")
    if cfg.get("relative_change_metric", "block_frobenius") != "block_frobenius":
        raise ValueError("the reference measures a block's change by its Frobenius norm")


class Schedule(ref.Schedule):
    """``reference.Schedule``'s stop rule for an L2 solve (no weight
    rounds): stop once every robot's relative change is under the
    tolerance, or at the budget of updates."""

    def __init__(self, cfg: Dict, R_n: int):
        _checked(cfg)
        self.gnc, self.R_n, self.K, self.inner_n, self.inner_tol = False, R_n, 0, 0, None
        self.tol = float(cfg["relative_change_tolerance"])
        self.max_iters = int(cfg["max_iteration_number"])


def _tf32_off() -> None:
    """float32 products stay float32 (the control rounds its operands to
    TF32 itself)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _extrapolate(ar: ref.Arith, Xb: torch.Tensor, Pb: torch.Tensor,
                 beta: float) -> torch.Tensor:
    """Retr(Xb, β·proj(Xb, Xb − Pb)) per pose: the tangent projection at
    the rotation part Y, then the exact polar factor of Y + β·proj (its
    SVD); the translation moves by β (Xb − Pb)."""
    d = Xb.shape[-1] - 1
    Y, D = Xb[..., :d], Xb[..., :d] - Pb[..., :d]
    S = ar.mm(Y.transpose(1, 2), D)
    A = Y + beta * (D - ar.mm(Y, 0.5 * (S + S.transpose(1, 2))))
    U, _, Vh = torch.linalg.svd(A, full_matrices=False)
    return torch.cat([ar.mm(U, Vh), Xb[..., d:] + beta * (Xb[..., d:] - Pb[..., d:])], -1)


def solve(g: Dict[str, np.ndarray], cfg: Dict, ylift: np.ndarray,
          control: bool = False, device="cpu") -> Dict:
    """One request's answer: ``T`` (n, d, d+1) rounded and anchored,
    ``cost`` (the world cost of the final ``X``), ``iterations`` (block
    updates), ``X`` and ``V`` (the final iterate and auxiliary state, on
    the host), ``restarted`` (per update) and ``w_pre`` (the graph's
    weights, which the cost is under); the block solves on ``device``."""
    _checked(cfg)
    _tf32_off()
    ar = ref.Arith(control, device)
    pb = ref.Problem(g, cfg, ar)
    p = ref._params(cfg)
    w = np.asarray(g["weight"], np.float64).copy()
    wt = ar.t(w)
    blocks = ref._solvers(pb, w)
    beta_fixed = cfg.get("acceleration_beta", 0.3)
    safeguard = bool(cfg.get("acceleration_safeguard", True))
    interval = int(cfg.get("restart_interval", 50))
    rule = Schedule(cfg, pb.R_n)
    X = ar.t(np.einsum("rd,ndk->nrk", ylift, ref.initial_trajectory(pb)))
    X_prev, V = X, X
    cost = float(pb.cost(X, wt))
    theta = 1.0
    rel = np.full(pb.R_n, np.inf)
    it = 0
    restarted = []
    while it < rule.max_iters:
        k = it % pb.R_n
        rows = blocks[k].rows
        theta_new = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * theta * theta))
        beta = float(beta_fixed) if beta_fixed is not None else (theta - 1.0) / theta_new
        Z, _ = blocks[k].solve(V, p)  # the block against V's separators, from V
        X_acc = X.clone()
        X_acc[rows] = Z[rows]
        f_acc = float(pb.cost(X_acc, wt))
        if safeguard and not f_acc <= cost:
            X_new, _ = blocks[k].solve(X, p)
            V_new, theta_next, cost_next = X_new, 1.0, float(pb.cost(X_new, wt))
            restarted.append(True)
        else:
            X_new, theta_next, cost_next = X_acc, theta_new, f_acc
            V_new = V.clone()
            V_new[rows] = _extrapolate(ar, X_acc[rows], X_prev[rows], beta)
            restarted.append(False)
        moved = math.sqrt(float(torch.sum((X_new - X) ** 2)))
        rel = np.where(pb.adj[k], np.maximum(rel, moved), rel)
        rel[k] = moved
        X_prev = X_prev.clone()
        X_prev[rows] = X[rows]
        X, V, theta, cost = X_new, V_new, theta_next, cost_next
        if (it + 1) % interval == 0:
            theta = 1.0
        it += 1
        if rule.stops(rel, 0):
            break
    cost = float(pb.cost(X, wt))
    Tr = ref.round_solution(X, ar)
    return dict(T=ref.anchor(Tr), cost=cost, iterations=it, w_pre=w, X=X.cpu().numpy(),
                V=V.cpu().numpy(), restarted=restarted)
