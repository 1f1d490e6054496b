"""The multi-robot RBCD engine (main-path subset), on torch tensors.

Port of ``dpgo_ros_tpu/parallel/rbcd.py``: synchronous Riemannian block-
coordinate descent over robot pose blocks on one global lifted state X.

* ``Uniform`` / ``RoundRobin`` — one robot optimizes its block per
  iteration (the reference's synchronous token passing): the robot drawn
  uniformly at random (from a ``torch.Generator`` seeded with
  ``config.seed``, or a schedule the caller passes), or the robots in turn.
* ``Parallel`` — robots are greedily colored (adjacent iff they share an
  edge); all robots of one color update at once as one masked solve on the
  union mask, whose Hessian is block-diagonal across the color class.

Two runners drive the same step semantics:

* :meth:`RBCDEngine.run` (``--mode engine``) — a host loop; each
  Uniform or RoundRobin update is one ``hbm_rtr.rtr_solve_hbm`` call (K4)
  on the robot's gathered window, each Parallel update one
  ``fused_rtr.rtr_solve_fused`` call (K1) on the colour class's window
  (:attr:`RBCDEngine._row_windows`, K2's). With ``solver = RGD`` each
  update, of any rule, is one ``fused_rtr.rtr_run_fused`` call (K2's RGD
  variant) of one step on the same window (:meth:`RBCDEngine._local_solve`).
* :meth:`RBCDEngine.make_fused_run` (``--mode fused``) — one
  ``fused_rtr.rtr_run_fused`` call (K2) per stretch between GNC weight
  rounds (an L2 run is one call), each step on its bank row's window, an
  RTR solve or an RGD step; with acceleration a host loop of the engine's
  accelerated steps instead.

Each call is the CUDA kernel on a CUDA device (float32 only) and its plain
version on the CPU. Robust costs run weight rounds between steps: GNC-TLS
(graduated non-convexity with truncated least squares) or plain IRLS for
L1/Huber/TLS/GM (reference ``commandCallback(UPDATE_WEIGHT)``,
``PGOAgentROS.cpp:1211-1233``). Nesterov acceleration
(``config.acceleration``) solves each block against the auxiliary state V
and extrapolates V, with an adaptive restart on a cost increase and a
periodic one (:meth:`RBCDEngine._accelerated_update`); weight rounds and
GNC resets drop the momentum.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dpgo_ros_tpu_torch.types import EdgeType
from dpgo_ros_tpu_torch.utils.config import (
    AgentConfig,
    InitMethod,
    RobustCostType,
    SolverMethod,
    UpdateRule,
)
from dpgo_ros_tpu_torch.models import robust
from dpgo_ros_tpu_torch.models.local_solvers import RTRParams
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import chordal as chordal_ops
from dpgo_ros_tpu_torch.ops import (
    fused_rtr,
    hbm_rtr,
    lie,
    nesterov,
    quadratic,
    rounding,
    stiefel,
)
from dpgo_ros_tpu_torch.ops.quadratic import EdgeSet, build_pull_index
from dpgo_ros_tpu_torch.utils import profiling

# Sequential block solves run on the robot's gathered window (K4): on the
# H100 it beat K1 (then full-width under the robot's mask) on every
# multi-robot world chip_smoke.py's gate phase times, from 2,500 poses and
# 2 robots up, and lost by 3 % only where the window is the whole world (1
# robot). False runs them on K1, now on the same window with the world's
# cost, the route the K4 one is held against.
SEQUENTIAL_ON_WINDOWS = True


class RBCDState(NamedTuple):
    """Solver state: tensors on the engine's device, counters on the host."""

    X: torch.Tensor  # (n, r, d+1) lifted iterate
    X_prev: torch.Tensor  # per-block previous iterate
    V: torch.Tensor  # auxiliary sequence (equals X without acceleration)
    theta: torch.Tensor
    iteration: int
    cost: torch.Tensor
    rel_change: torch.Tensor  # (num_robots,)
    weights: torch.Tensor  # (E,)
    fixed_mask: torch.Tensor  # (E,)
    mu: torch.Tensor
    weight_update_count: int


_INT_FIELDS = ("iteration", "weight_update_count")


def state_to_numpy(st: RBCDState) -> Dict[str, np.ndarray]:
    """Host copy of a state, keyed by field name."""
    return {
        k: (np.asarray(v) if k in _INT_FIELDS else v.detach().cpu().numpy())
        for k, v in st._asdict().items()
    }


def state_from_numpy(
    arrays: Mapping[str, np.ndarray], *, dtype: torch.dtype, device
) -> RBCDState:
    """State from host arrays keyed by field name — e.g. this package's
    :func:`state_to_numpy` or the JAX package's ``RBCDState._asdict()``
    passed through ``np.asarray``."""
    out = {}
    for k in RBCDState._fields:
        v = np.asarray(arrays[k])
        out[k] = (
            int(v) if k in _INT_FIELDS
            else torch.tensor(v, dtype=dtype, device=device)
        )
    return RBCDState(**out)


class RBCDEngine:
    def __init__(self, problem: LiftedProblem, config: AgentConfig):
        self.problem = problem
        self.config = cfg = config.resolve()
        self.device = problem.device
        self.dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
        if problem.dtype != self.dtype:
            raise ValueError(
                f"problem dtype {problem.dtype} != config dtype {cfg.dtype}"
            )
        if cfg.relative_change_metric not in ("block_frobenius", "max_pose"):
            raise ValueError(
                f"relative_change_metric={cfg.relative_change_metric!r}")
        if self.device.type == "cuda":
            # on the card every block solve is the CUDA kernel
            if self.dtype != torch.float32:
                raise ValueError("the CUDA block-solve kernel is float32 only")
            if cfg.use_fused_kernel is False:
                raise ValueError(
                    "use_fused_kernel=False: there is no plain solve path on CUDA"
                )
        self.rtr_params = RTRParams(
            max_iterations=cfg.RTR_iterations,
            max_tcg_iterations=cfg.RTR_tCG_iterations,
            gradnorm_tol=cfg.RTR_gradnorm_tol,
        )
        # an asynchronous config resolves to RGD; such an engine also
        # serves the ASAPP engine's initialization
        self._rgd = cfg.solver == SolverMethod.RGD
        nR = problem.num_robots
        rof = np.asarray(problem.robot_of_pose)
        onehot = np.stack([(rof == k) for k in range(nR)], axis=0)
        self._onehot = self._t(onehot)  # (R, n)
        self._masks = self._onehot[:, :, None, None]  # (R, n, 1, 1)
        self.robot_colors = self._color_robots()
        self.num_colors = int(self.robot_colors.max()) + 1
        self._color_masks = self._t(np.stack([
            onehot[self.robot_colors == c].any(axis=0)
            for c in range(self.num_colors)
        ]))[:, :, None, None]
        self._adjf = self._t(self._adj_np)
        bounds = np.concatenate([problem.offsets, [problem.n]])
        self._offsets = torch.as_tensor(
            bounds, dtype=torch.int32, device=self.device
        )
        self.Ylift: Optional[torch.Tensor] = None

    @functools.cached_property
    def _windows(self) -> hbm_rtr.Windows:
        """Every robot's window, built on the first windowed solve."""
        return hbm_rtr.prepare_windows(self.problem)

    @functools.cached_property
    def _row_windows(self) -> hbm_rtr.Windows:
        """One window per bank row of K2, built on the first fused run or
        Parallel update: Parallel's colour classes (K1's too), else the
        robots' windows (K4's)."""
        if self.config.update_rule != UpdateRule.PARALLEL:
            return self._windows
        rows = [np.flatnonzero(self.robot_colors == c) for c in range(self.num_colors)]
        return hbm_rtr.prepare_row_windows(self.problem, rows)

    @functools.cached_property
    def _bank(self) -> torch.Tensor:
        """(m, n) K2's mask bank: one row per window of
        :attr:`_row_windows` (colour unions for Parallel, else robots)."""
        bank = (self._color_masks if self.config.update_rule == UpdateRule.PARALLEL
                else self._masks)
        return bank[:, :, 0, 0].contiguous()

    @functools.cached_property
    def _row_sched(self) -> List[torch.Tensor]:
        """One-entry K2 schedules, one per bank row (an RGD update's): rows
        of one tensor, so that K2 keeps each row's operand checks."""
        rows = torch.arange(self._bank.shape[0], dtype=torch.int32, device=self.device)
        return [rows[k:k + 1] for k in range(rows.shape[0])]

    @functools.cached_property
    def _rel_zero(self) -> torch.Tensor:
        """K2's incoming rel change for a one-step RGD launch (the engine
        computes its own in :meth:`_finish_step`)."""
        return torch.zeros(self.problem.num_robots, dtype=self.dtype, device=self.device)

    @functools.cached_property
    def _fixed_beta(self) -> torch.Tensor:
        """(1,) the fixed ``acceleration_beta`` on the device, read there by
        the accelerated step's extrapolation (K7)."""
        return self._t([self.config.acceleration_beta])

    @functools.cached_property
    def _identity_pinv(self) -> torch.Tensor:
        """(n, d+1, d+1) identities: K2's P⁻¹ for RGD without the
        preconditioner (the step's direction is then mask · proj(X, grad),
        the masked Riemannian gradient, which is JAX's unpreconditioned
        ``rgd_step``)."""
        dp1 = self.problem.d + 1
        eye = torch.eye(dp1, dtype=self.dtype, device=self.device)
        return eye.expand(self.problem.n, dp1, dp1).contiguous()

    def update_schedule(self, upto: int, schedule=None) -> np.ndarray:
        """(upto,) int64 bank row of each absolute iteration 0..upto-1: the
        colour class for Parallel, the robot for RoundRobin (in turn) and
        Uniform (drawn from a CPU ``torch.Generator`` seeded with
        ``config.seed``; a longer draw extends a shorter one). A caller's
        ``schedule`` (an int sequence, at least ``upto`` long) replaces
        the rule's, e.g. the JAX package's ``randint(fold_in(key, it))``."""
        rows = (self.num_colors if self.config.update_rule == UpdateRule.PARALLEL
                else self.problem.num_robots)
        if schedule is not None:
            out = np.asarray(schedule, np.int64).reshape(-1)
            if out.size < upto or (out.size and (out.min() < 0 or out.max() >= rows)):
                raise ValueError(
                    f"schedule: {out.size} entries in 0..{rows - 1} needed for "
                    f"{upto} iterations")
            return out[:upto]
        if self.config.update_rule == UpdateRule.UNIFORM:
            gen = torch.Generator().manual_seed(self.config.seed)
            return torch.randint(0, rows, (upto,), generator=gen).numpy()
        return np.arange(upto, dtype=np.int64) % rows

    def _t(self, x) -> torch.Tensor:
        return torch.tensor(np.asarray(x), dtype=self.dtype, device=self.device)

    def _color_robots(self) -> np.ndarray:
        """Greedy coloring, highest degree first; robots are adjacent iff
        they share a measurement."""
        prob = self.problem
        nR = prob.num_robots
        he = prob.host_edges
        rof = np.asarray(prob.robot_of_pose)
        src_r, dst_r = rof[he.src], rof[he.dst]
        cross = (he.mask > 0) & (src_r != dst_r)
        adj = np.zeros((nR, nR), bool)
        adj[src_r[cross], dst_r[cross]] = True
        adj[dst_r[cross], src_r[cross]] = True
        self._adj_np = adj
        colors = -np.ones(nR, np.int32)
        for k in np.argsort(-adj.sum(1)):
            used = set(colors[adj[k]]) - {-1}
            c = 0
            while c in used:
                c += 1
            colors[k] = c
        return colors

    def mask_bank_and_schedule(
        self, max_iters: int, schedule=None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """K2's operands for the update rule: the (m, n) mask bank (robot
        blocks for RoundRobin and Uniform, colour unions for Parallel) and
        the (max_iters,) int32 bank row of each absolute iteration
        (:meth:`update_schedule`), built on the host."""
        sched = torch.as_tensor(
            self.update_schedule(max_iters, schedule), dtype=torch.int32,
            device=self.device,
        )
        return self._bank, sched

    # ------------------------------------------------------------------ init

    def _edges(self, weights: torch.Tensor) -> EdgeSet:
        return dataclasses.replace(self.problem.edges, weight=weights)

    def _local_subgraph_traj(self, robot: int) -> torch.Tensor:
        """Local initialization of one robot from its private subgraph
        (odometry + private loop closures)."""
        prob, cfg = self.problem, self.config
        m = prob.data.measurements
        nk = int(prob.num_poses[robot])
        d = prob.d
        mine = (m.src_robot == robot) & (m.dst_robot == robot)
        if cfg.local_initialization_method == InitMethod.ODOMETRY:
            odo = mine & (m.edge_type == EdgeType.ODOMETRY)
            idx = np.argsort(m.src_frame[odo])
            R, t, frames = m.R[odo][idx], m.t[odo][idx], m.src_frame[odo][idx]
            rel = np.zeros((nk - 1, d, d + 1))
            rel[:, :, :d] = np.eye(d)
            for a, f in enumerate(frames):
                if f < nk - 1:
                    rel[f, :, :d] = R[a]
                    rel[f, :, d] = t[a]
            return lie.odometry_chain(self._t(rel))
        sel = np.asarray(mine)
        odo = np.asarray(m.edge_type[sel] == EdgeType.ODOMETRY)
        E = int(sel.sum())
        es = EdgeSet(
            src=torch.as_tensor(m.src_frame[sel], dtype=torch.int64, device=self.device),
            dst=torch.as_tensor(m.dst_frame[sel], dtype=torch.int64, device=self.device),
            R=self._t(m.R[sel]),
            t=self._t(m.t[sel]),
            kappa=self._t(m.kappa[sel]),
            tau=self._t(m.tau[sel]),
            weight=self._t(m.weight[sel]),
            mask=self._t(np.ones(E)),
            is_loop=self._t(np.zeros(E)),
            pull=torch.as_tensor(
                build_pull_index(m.src_frame[sel], m.dst_frame[sel], nk),
                dtype=torch.int32, device=self.device,
            ),
        )
        T = chordal_ops.chordal_initialization(es, nk, max_iters=500)
        if cfg.local_initialization_method == InitMethod.GNC_TLS:
            # annealed truncation of private loop closures whose residual
            # exceeds a shrinking cutoff, re-solving chordally each round;
            # never below robust_init_min_inliers inlier loops (reference
            # PGOAgentROSNode.cpp:212-221)
            for factor in (10.0, 3.0, 1.5):
                r_e = robust.measurement_residuals(T, es).cpu().numpy()
                keep = odo | (r_e <= factor * cfg.GNC_barc)
                if int((keep & ~odo).sum()) < cfg.robust_init_min_inliers:
                    break
                es = dataclasses.replace(es, weight=self._t(keep.astype(np.float64)))
                T = chordal_ops.chordal_initialization(es, nk, max_iters=500)
        return T

    def _align_robot_frames(self, local_trajs: List[torch.Tensor]) -> torch.Tensor:
        """BFS frame alignment over the robot adjacency graph through shared
        loop closures; robot 0 anchors the global frame."""
        prob = self.problem
        m = prob.data.measurements
        nR = prob.num_robots
        ident = self._t(np.concatenate([np.eye(prob.d), np.zeros((prob.d, 1))], -1))
        G: List[Optional[torch.Tensor]] = [None] * nR
        G[0] = ident
        order = np.where(np.asarray(m.edge_type == EdgeType.SHARED_LOOP_CLOSURE))[0]
        frontier, visited = [0], {0}
        while frontier:
            a = frontier.pop(0)
            for k in order:
                ra, rb = int(m.src_robot[k]), int(m.dst_robot[k])
                if ra == a and rb not in visited:
                    G[rb] = self._align_pair(G[a], local_trajs[a], local_trajs[rb], m, k, True)
                    visited.add(rb)
                    frontier.append(rb)
                elif rb == a and ra not in visited:
                    G[ra] = self._align_pair(G[a], local_trajs[a], local_trajs[ra], m, k, False)
                    visited.add(ra)
                    frontier.append(ra)
        out = []
        for rb in range(nR):
            Gk = G[rb] if G[rb] is not None else ident
            Tk = local_trajs[rb]
            out.append(lie.se_compose(Gk.expand(Tk.shape[0], *Gk.shape), Tk))
        return torch.cat(out, dim=0)

    def _align_pair(self, Ga, traj_a, traj_b, m, k, src_side: bool):
        """Frame of robot b from one shared edge k: G_a T_i M_e = G_b T_j."""
        Me = self._t(np.concatenate([m.R[k], m.t[k][:, None]], axis=-1))
        i, j = int(m.src_frame[k]), int(m.dst_frame[k])
        comp, inv = lie.se_compose, lie.se_inverse
        if src_side:
            return comp(comp(comp(Ga, traj_a[i]), Me), inv(traj_b[j]))
        return comp(comp(Ga, traj_a[j]), inv(comp(traj_b[i], Me)))

    @profiling.spanned("rbcd.initialize")
    def initialize(
        self,
        trajectory: Optional[np.ndarray] = None,
        ylift=None,
    ) -> RBCDState:
        """Local init per robot → frame alignment → anchor → lift through
        the shared YLift. ``ylift`` (r, d), an array or a tensor, overrides
        the sampled lifting matrix (the only random input of the main
        path); otherwise it is drawn from a CPU ``torch.Generator`` seeded
        with ``config.seed``. Robust costs start with the loop closures'
        weights free (``fixed_mask = 1 − is_loop``), L2 with all fixed."""
        prob, cfg = self.problem, self.config
        if trajectory is None:
            locals_ = [self._local_subgraph_traj(k) for k in range(prob.num_robots)]
            if cfg.multirobot_initialization and prob.num_robots > 1:
                T = self._align_robot_frames(locals_)
            else:
                T = torch.cat(locals_, dim=0)
        else:
            T = self._t(trajectory)
        T = rounding.anchor_to_first_pose(T)
        if isinstance(ylift, torch.Tensor):
            self.Ylift = ylift.to(dtype=self.dtype, device=self.device)
        elif ylift is not None:
            self.Ylift = self._t(ylift)
        elif prob.r == prob.d:
            self.Ylift = torch.eye(prob.d, dtype=self.dtype, device=self.device)
        else:
            gen = torch.Generator().manual_seed(cfg.seed)
            self.Ylift = stiefel.random_lifting_matrix(
                gen, prob.r, prob.d, dtype=self.dtype, device=self.device
            )
        X = stiefel.lift_trajectory(T, self.Ylift).contiguous()
        weights = prob.edges.weight.clone()
        fixed = (
            torch.ones_like(weights)
            if cfg.robust_cost_type == RobustCostType.L2
            else 1.0 - prob.edges.is_loop
        )
        return RBCDState(
            X=X,
            X_prev=X,
            V=X,
            theta=self._t(1.0),
            iteration=0,
            cost=quadratic.cost(X, self._edges(weights)),
            rel_change=torch.full(
                (prob.num_robots,), float("inf"), dtype=self.dtype,
                device=self.device,
            ),
            weights=weights,
            fixed_mask=fixed,
            mu=self._t(cfg.GNC_init_mu),
            weight_update_count=0,
        )

    # ------------------------------------------------------------------ steps

    def _solver_cache(self, e: EdgeSet) -> torch.Tensor:
        """Damped block-Jacobi inverse for the current weights, computed
        once per weight set and passed to every block solve (identities for
        RGD without the preconditioner)."""
        if self._rgd and not self.config.RGD_use_preconditioner:
            return self._identity_pinv
        return quadratic.precond_inverse(
            quadratic.precond_blocks(e, self.problem.n)
        ).contiguous()

    def _local_solve(self, Xs, e, mask, Pinv, robot=None, color=None, cost=0.0):
        """One masked block solve from ``Xs`` → (X with the block solved,
        stats): K4 on robot ``robot``'s window for a sequential step, K1 on
        colour ``color``'s window for a Parallel one (each the kernel for
        CUDA tensors, its plain version, full-width under ``mask``, for CPU
        tensors). K4's f is its window's local cost, K1's the world's. Both
        read the window's separators from ``Xs``, so an accelerated step
        solves against the auxiliary state V by passing it here.

        With ``solver = RGD`` the update is one preconditioned RGD step (JAX
        ``rgd_solve``, one step) as one K2 launch of one step on the row's
        window (robot or colour), and stats are K2's: ``RUN_COST`` is
        ``cost`` (the cost of ``Xs``) moved by the step, the world's cost
        after it."""
        if self._rgd:
            row = robot if robot is not None else color
            X_new, _, stats = fused_rtr.rtr_run_fused(
                Xs, self._bank, self._row_sched[row], Pinv, e, self.rtr_params,
                adj=self._adjf, rel0=self._rel_zero, it0=0, last_wu=0,
                gnc_pending=False, cost0=cost, it_cap=1, tol=0.0, gnc=False,
                inner=1, inner_tol=None, rgd_stepsize=self.config.RGD_stepsize,
                rgd_cost=True, offsets=self._offsets, windows=self._row_windows,
            )
            return X_new, stats
        if robot is not None and SEQUENTIAL_ON_WINDOWS:
            return hbm_rtr.rtr_solve_hbm(
                Xs, robot, Pinv, e, self.rtr_params, self._windows
            )
        windows, row = ((self._windows, robot) if robot is not None
                        else (self._row_windows, color))
        Xk, stats = fused_rtr.rtr_solve_fused(
            Xs, mask, Pinv, e, self.rtr_params, windows=windows, row=row
        )
        return torch.where(mask > 0, Xk, Xs), stats

    def _plain_update(self, st: RBCDState, mask, e, Pinv, route):
        """One block update without acceleration: (state, rc, tCG). The
        windowed route (K4) carries the global cost as cost + (f − f0): only
        block poses move, so the world's cost moves by the window's; so
        does an RGD step (K2's cost)."""
        X_new, stats = self._local_solve(st.X, e, mask, Pinv, cost=st.cost, **route)
        if self._rgd:
            cost = stats[fused_rtr.RUN_COST].to(self.dtype)
        elif route.get("robot") is not None and SEQUENTIAL_ON_WINDOWS:
            dcost = stats[fused_rtr.S_F] - stats[fused_rtr.S_F0]
            cost = st.cost + dcost.to(self.dtype)
        else:
            cost = stats[fused_rtr.S_F].to(self.dtype)
        return self._finish_step(st, X_new, X_new, stats, st.theta, cost, mask)

    def _accelerated_update(self, st: RBCDState, mask, e, Pinv, route):
        """One Nesterov-accelerated block update (JAX ``_block_update``):
        (state, tCG, host read, restarted), as :meth:`_step` returns.

        The block is solved against the auxiliary state V (a solve from an
        extrapolated start alone would be a no-op: the block minimizer does
        not depend on its start), X_acc = the solved block over X, and the
        block's V is extrapolated as Retr(X_acc, β·proj(X_acc, X_acc −
        X_prev)) with β the fixed ``acceleration_beta`` or the θ-sequence's
        (θ − 1)/θ', both in ``ops/nesterov.py::extrapolate`` (K7 on the card,
        one launch; its plain version on the CPU). With
        ``acceleration_safeguard``, a step whose cost f_acc exceeds the
        state's restarts: a second block solve from X with θ = 1 and V = X,
        the world's cost of its result and one more host read. Every
        ``restart_interval`` iterations θ resets.

        f_acc is a full evaluation of X_acc over the world's edges, so the
        safeguard compares two full evaluations; a cost carried as cost +
        (f − f0) drifts from one in fp32 and could flip the test at its
        threshold. The test is read in the step's one host read
        (:meth:`_read`).

        Spans (:mod:`utils.profiling`): ``rbcd.extrapolate`` (the
        ``extrapolate`` call: X_acc's select, the tangent projection, the
        retraction and V's select), ``rbcd.safeguard`` (f_acc and the
        test's flag, launched; the read that carries it is the step's
        ``rbcd.read``), ``rbcd.restart`` (a restarted step's second solve,
        its cost and its read)."""
        cfg = self.config
        theta_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * st.theta ** 2))
        beta = (self._fixed_beta if cfg.acceleration_beta is not None
                else (st.theta - 1.0) / theta_new)
        Z, stats = self._local_solve(st.V, e, mask, Pinv, **route)
        with profiling.span("rbcd.extrapolate"):
            X_acc, V_new = nesterov.extrapolate(
                Z, st.X, st.X_prev, st.V, mask.reshape(-1), beta)
        if cfg.acceleration_safeguard:
            with profiling.span("rbcd.safeguard"):
                f_acc = quadratic.cost(X_acc, e)
                flags = (f_acc <= st.cost,)
        else:
            f_acc, flags = quadratic.cost(X_acc, e), ()
        out = self._finish_step(st, X_acc, V_new, stats, theta_new, f_acc, mask)
        host = self._read(out[0], out[1], *flags)
        restarted = bool(flags) and not host[3][0]
        if restarted:
            with profiling.span("rbcd.restart"):
                X_r, stats_r = self._local_solve(st.X, e, mask, Pinv, **route)
                st_r, rc_r, k_r = self._finish_step(
                    st, X_r, X_r, stats_r, torch.ones_like(st.theta),
                    quadratic.cost(X_r, e), mask)
                out = (st_r, rc_r, k_r + out[2])
                host = self._read(st_r, rc_r)
        st_new, _, k = out
        if (st.iteration + 1) % cfg.restart_interval == 0:
            st_new = st_new._replace(theta=torch.ones_like(st.theta))
        return st_new, k, host[:3], restarted

    @profiling.spanned("rbcd.read")
    def _read(self, st: RBCDState, rc, *flags):
        """The step's one host read: (rel change (R,), rc, cost, flags)."""
        R = st.rel_change.shape[0]
        v = torch.cat([st.rel_change, rc.reshape(1), st.cost.reshape(1)]
                      + [f.reshape(1).to(self.dtype) for f in flags])
        v = v.cpu().numpy().astype(np.float64)
        return v[:R], float(v[R]), float(v[R + 1]), v[R + 2:]

    def _finish_step(self, st: RBCDState, X_new, V_new, stats, theta, cost, mask):
        """Per-robot relative change, with the neighbour invalidation bump:
        a robot not updated this step keeps at least max_k adj[k, j] ·
        moved_k, so termination needs a quiescent neighbourhood. A robot's
        change is the Frobenius norm of its block's update
        (``relative_change_metric="block_frobenius"``) or its largest
        per-pose update norm (``"max_pose"``). Returns (state, rel change of
        this step, tCG iterations of the solve: none for an RGD step)."""
        per_pose2 = torch.sum((X_new - st.X) ** 2, dim=(-2, -1))
        sel = mask[:, 0, 0]
        if self.config.relative_change_metric == "max_pose":
            dpose = sel * torch.sqrt(per_pose2)
            moved = torch.amax(self._onehot * dpose, dim=1)
            rc = torch.max(dpose)
        else:
            moved = torch.sqrt(self._onehot @ (sel * per_pose2))
            rc = torch.sqrt(torch.sum(sel * per_pose2))
        updated = torch.amax(self._onehot * sel, dim=1)
        bump = (moved * updated) @ self._adjf
        rel_change = torch.where(
            updated > 0, moved, torch.maximum(st.rel_change, bump)
        )
        return st._replace(
            X=X_new,
            X_prev=torch.where(mask > 0, st.X, st.X_prev),
            V=V_new,
            theta=theta,
            iteration=st.iteration + 1,
            cost=cost,
            rel_change=rel_change,
        ), rc, 0 if self._rgd else stats[fused_rtr.S_TCG]

    @profiling.spanned("rbcd.step")
    def _step(self, st: RBCDState, row: int, Pinv=None):
        """One scheduled block update: the robot holding the update token
        (Uniform, RoundRobin) or every robot of colour ``row`` at once
        (Parallel, one union-mask solve). Returns (state, tCG iterations of
        its solves, (rel change (R,), rc, cost) read on the host, whether
        an accelerated step restarted)."""
        e = self._edges(st.weights)
        if self.config.update_rule == UpdateRule.PARALLEL:
            mask, route = self._color_masks[row], dict(color=row)
        else:
            mask, route = self._masks[row], dict(robot=row)
        Pinv = Pinv if Pinv is not None else self._solver_cache(e)
        if self.config.acceleration:
            return self._accelerated_update(st, mask, e, Pinv, route)
        st2, rc, k = self._plain_update(st, mask, e, Pinv, route)
        return st2, k, self._read(st2, rc)[:3], False

    def _weight_update_impl(self, st: RBCDState) -> RBCDState:
        """Robust weight round (reference UPDATE_WEIGHT): residuals on the
        rounded trajectory; GNC-TLS weights under the scheduled μ, or IRLS
        weights for L1/Huber/TLS/GM; optional freeze of weights that fell
        below ``weight_convergence_threshold`` (rejected and fixed, as the
        reference does). Drops the momentum and sets rel change to inf."""
        cfg = self.config
        e = self._edges(st.weights)
        r = robust.measurement_residuals(rounding.round_solution(st.X), e)
        if cfg.robust_cost_type == RobustCostType.GNC_TLS:
            mu_use, barc_use = robust.gnc_round_params(
                st.weight_update_count, cfg, st.mu, residuals=r,
                loop_mask=e.is_loop * e.mask, dtype=self.dtype,
            )
            w_new, _ = robust.update_weights_gnc(
                st.weights, st.fixed_mask, r, mu_use, barc_use, cfg.GNC_mu_step
            )
        else:
            w_irls = robust.robust_weight(cfg.robust_cost_type.value, r, cfg.GNC_barc)
            w_new = torch.where(st.fixed_mask > 0, st.weights, w_irls)
        fixed = st.fixed_mask
        if cfg.weight_convergence_threshold > 0:
            newly = (fixed == 0) & (w_new < cfg.weight_convergence_threshold)
            w_new = torch.where(newly, torch.zeros_like(w_new), w_new)
            fixed = torch.where(newly, torch.ones_like(fixed), fixed)
        return RBCDState(
            X=st.X,
            X_prev=st.X,
            V=st.X,
            theta=self._t(1.0),
            iteration=st.iteration,
            cost=quadratic.cost(st.X, self._edges(w_new)),
            rel_change=torch.full_like(st.rel_change, float("inf")),
            weights=w_new,
            fixed_mask=fixed,
            mu=st.mu * cfg.GNC_mu_step,
            weight_update_count=st.weight_update_count + 1,
        )

    def _reset(self, st: RBCDState) -> RBCDState:
        """Re-initialization after an early weight round (reference
        robustOptNumResets, PGOAgentROSNode.cpp:212-221): a fresh initial
        state lifted through the engine's current YLift, keeping the
        weights, the GNC state and the iteration counter."""
        st2 = self.initialize(ylift=self.Ylift)
        return st2._replace(
            weights=st.weights,
            fixed_mask=st.fixed_mask,
            mu=st.mu,
            weight_update_count=st.weight_update_count,
            iteration=st.iteration,
            cost=quadratic.cost(st2.X, self._edges(st.weights)),
        )

    @profiling.spanned("rbcd.weight_round")
    def _weight_round(self, st: RBCDState, X0: Optional[torch.Tensor] = None):
        """A weight round (:meth:`_weight_update_impl`), the reset after one
        of the first ``robust_opt_num_resets`` rounds, and the P⁻¹ of the
        new weights: (state, P⁻¹). The reset is :meth:`_reset`'s
        re-initialization, or, given ``X0`` (a fused runner's starting
        state), X0 with its cost under the new weights."""
        st = self._weight_update_impl(st)
        if st.weight_update_count <= self.config.robust_opt_num_resets:
            if X0 is None:
                st = self._reset(st)
            else:
                st = st._replace(X=X0, X_prev=X0, V=X0,
                                 cost=quadratic.cost(X0, self._edges(st.weights)))
        return st, self._solver_cache(self._edges(st.weights))

    def _round_due(self, it: int, last_wu: int, rel: np.ndarray, wuc: int) -> bool:
        """Whether a weight round fires before global iteration ``it``: on
        the fixed cadence, or, with ``robust_opt_inner_tol``, once every
        robot's rel change is below it (the cadence stays as a cap)."""
        cfg = self.config
        inner = cfg.robust_opt_inner_iters_per_robot * self.problem.num_robots
        if cfg.robust_opt_inner_tol is not None:
            fire = bool(np.all(rel < cfg.robust_opt_inner_tol)) or it - last_wu >= inner
        else:
            fire = it % inner == 0
        return it > 0 and fire and wuc < cfg.robust_opt_num_weight_updates

    # ------------------------------------------------------------------ run

    @profiling.spanned("rbcd.run")
    def run(
        self,
        state: Optional[RBCDState] = None,
        max_iters: Optional[int] = None,
        callback=None,
        schedule=None,
    ) -> Tuple[RBCDState, Dict]:
        """Scheduled block updates, with weight rounds for robust costs,
        until every robot's relative change is below
        ``relative_change_tolerance`` and no weight round is pending, or
        ``max_iters`` updates ran. ``schedule`` replaces the rule's
        (:meth:`update_schedule`; indexed by the absolute iteration).
        Returns (final_state, info) with the per-iteration history (its
        ``restarted``: whether each accelerated update restarted), the
        total tCG iterations (a restarted accelerated step counts both of
        its solves), the accelerated steps that restarted and, for robust
        costs, ``gnc_stats``."""
        cfg = self.config
        if state is None:
            state = self.initialize()
        max_iters = max_iters or cfg.max_iteration_number
        gnc = cfg.robust_cost_type != RobustCostType.L2
        history: Dict[str, list] = {
            "iteration": [], "cost": [], "rel_change": [],
            "rel_change_robots": [], "iter_time_sec": [], "event": [],
            "restarted": [],
        }
        t_start = time.time()
        sched = self.update_schedule(state.iteration + max_iters, schedule)
        Pinv = self._solver_cache(self._edges(state.weights))
        tcg = torch.zeros((), dtype=self.dtype, device=self.device)
        it = restarts = 0
        last_wu = state.iteration
        with profiling.span("rbcd.read"):
            rel = state.rel_change.cpu().numpy().astype(np.float64)
        while it < max_iters:
            if gnc and self._round_due(
                state.iteration, last_wu, rel, state.weight_update_count
            ):
                last_wu = state.iteration
                state, Pinv = self._weight_round(state)
                history["event"].append((it, "UPDATE_WEIGHT"))
            t0 = time.time()
            state, k, (rel, rc, cost), restarted = self._step(
                state, int(sched[state.iteration]), Pinv)
            tcg = tcg + k
            restarts += restarted
            it += 1
            history["iteration"].append(it)
            history["cost"].append(cost)
            history["rel_change"].append(rc)
            history["rel_change_robots"].append(rel)
            history["iter_time_sec"].append(time.time() - t0)
            history["restarted"].append(restarted)
            if callback is not None:
                callback(it, state)
            if self._terminated(rel, state.weight_update_count):
                break
        # the steps carry the cost by the windows' f − f0: end on the
        # world's cost of the final state
        state = state._replace(cost=quadratic.cost(state.X, self._edges(state.weights)))
        with profiling.span("rbcd.read"):
            info = {
                "history": history,
                "iterations": it,
                "total_time_sec": time.time() - t_start,
                "final_cost": float(state.cost),
                "converged": bool(np.all(rel < cfg.relative_change_tolerance)),
                "tcg_iterations": int(tcg),
                "restarts": restarts,
            }
            if gnc:
                info.update(self.gnc_info(state.weights))
        return state, info

    def _terminated(self, rel: np.ndarray, wuc: int) -> bool:
        """Every robot's rel change below tol and no weight round pending."""
        cfg = self.config
        ready = bool(np.all(rel < cfg.relative_change_tolerance))
        return ready and (
            cfg.robust_cost_type == RobustCostType.L2
            or wuc >= cfg.robust_opt_num_weight_updates
        )

    def gnc_info(self, weights: torch.Tensor) -> Dict:
        """``gnc_stats`` (accepted / rejected / undecided loop closures and
        the decided share) and ``gnc_converged`` (that share against
        ``robust_opt_min_convergence_ratio``)."""
        e = self.problem.edges
        acc, rej, und = robust.classify_weights(weights, e.is_loop, e.mask)
        ratio = (acc + rej) / max(acc + rej + und, 1)
        return {
            "gnc_stats": {"accepted": acc, "rejected": rej, "undecided": und,
                          "convergence_ratio": ratio},
            "gnc_converged": ratio >= self.config.robust_opt_min_convergence_ratio,
        }

    @profiling.spanned("rbcd.fused_prepare")
    def make_fused_run(self, max_iters: int, record: bool = False,
                       return_stats: bool = False, schedule=None):
        """A runner ``run(state)`` that executes the solve as K2 launches
        (``fused_rtr.rtr_run_fused``): one launch per stretch between GNC
        weight rounds, so an L2 run is one launch. The weight rounds run
        between launches, on the device, with the engine's own
        :meth:`_weight_update_impl`; a reset after one of the first
        ``robust_opt_num_resets`` rounds sets X back to the run's starting
        state. The schedule and mask bank are built on the host
        (:meth:`mask_bank_and_schedule`, ``schedule`` as in :meth:`run`)
        and ``max_iters`` is the absolute iteration cap. The kernel solves
        each step on its bank row's window (:attr:`_row_windows`), so it
        carries the cost by the windows' f − f0; the returned state's cost
        is the world's cost of its X, as :meth:`run`'s.

        ``record=True`` returns ``(state, rel_hist (max_iters, R) with NaN
        rows for iterations not run, event_hist (max_iters,) int8 with 1
        where a weight round fired)``; ``return_stats=True`` appends the
        total tCG iterations. K2 measures every robot's change as the
        block's Frobenius norm whatever ``relative_change_metric`` says, as
        the JAX package's multi-step kernel does.

        With ``acceleration`` the runner is :meth:`_accelerated_run`'s host
        loop of per-step solves instead (JAX's runner leaves its multi-step
        kernel the same way); ``return_stats=True`` then raises ValueError.
        """
        cfg, prob = self.config, self.problem
        if cfg.acceleration:
            if return_stats:
                raise ValueError("return_stats requires the multi-step fused runner")
            return self._accelerated_run(max_iters, record, schedule)
        gnc = cfg.robust_cost_type != RobustCostType.L2
        inner = cfg.robust_opt_inner_iters_per_robot * prob.num_robots
        bank, sched = self.mask_bank_and_schedule(max_iters, schedule)
        windows = self._row_windows
        R = prob.num_robots

        @profiling.spanned("rbcd.fused_run")
        def run(st: RBCDState):
            X0 = st.X
            X, it, cost, rel = st.X, st.iteration, st.cost, st.rel_change
            w, fixed, mu, wuc = st.weights, st.fixed_mask, st.mu, st.weight_update_count
            last_wu = it
            Pinv = self._solver_cache(self._edges(w))
            if record:
                rel_h = torch.full((max_iters, R), float("nan"), dtype=self.dtype,
                                   device=self.device)
                ev_h = torch.zeros((max_iters,), dtype=torch.int8)
            tcg = 0
            while it < max_iters:
                with profiling.span("rbcd.read"):
                    rel_np = rel.cpu().numpy().astype(np.float64)
                if self._terminated(rel_np, wuc):
                    break
                if gnc and self._round_due(it, last_wu, rel_np, wuc):
                    last_wu = it
                    s2, Pinv = self._weight_round(RBCDState(
                        X=X, X_prev=X, V=X, theta=st.theta, iteration=it,
                        cost=cost, rel_change=rel, weights=w, fixed_mask=fixed,
                        mu=mu, weight_update_count=wuc,
                    ), X0)
                    X, w, fixed, mu = s2.X, s2.weights, s2.fixed_mask, s2.mu
                    wuc, cost, rel = s2.weight_update_count, s2.cost, s2.rel_change
                    if record:
                        ev_h[it] = 1
                out = fused_rtr.rtr_run_fused(
                    X, bank, sched, Pinv, self._edges(w), self.rtr_params,
                    adj=self._adjf, rel0=rel, it0=it, last_wu=last_wu,
                    gnc_pending=gnc and wuc < cfg.robust_opt_num_weight_updates,
                    cost0=cost, it_cap=max_iters,
                    tol=cfg.relative_change_tolerance, gnc=gnc, inner=inner,
                    inner_tol=cfg.robust_opt_inner_tol, record=record,
                    rgd_stepsize=cfg.RGD_stepsize if self._rgd else 0.0,
                    offsets=self._offsets, windows=windows,
                )
                X, rel, stats = out[:3]
                cost = stats[fused_rtr.RUN_COST].to(self.dtype)
                with profiling.span("rbcd.read"):
                    _, it_f, _, tcg_f = stats.tolist()
                it, tcg = int(it_f), tcg + int(tcg_f)
                if record:
                    rel_h = torch.where(torch.isnan(out[3]), rel_h, out[3])
            state = RBCDState(
                X=X, X_prev=X, V=X, theta=st.theta, iteration=it,
                cost=quadratic.cost(X, self._edges(w)),
                rel_change=rel, weights=w, fixed_mask=fixed, mu=mu,
                weight_update_count=wuc,
            )
            extras = [rel_h, ev_h] if record else []
            if return_stats:
                extras.append(tcg)
            return (state, *extras) if extras else state

        return run

    def _accelerated_run(self, max_iters: int, record: bool, schedule):
        """The accelerated fused runner (JAX ``make_fused_run``'s while-loop
        of per-step solves): up to the absolute iteration ``max_iters``,
        stopping when every robot's rel change is below tolerance and no
        weight round is pending (tested before each step, the first
        included); weight rounds, resets to the run's starting state and
        ``record`` as the K2 runner. Each step is one K4 launch (Uniform,
        RoundRobin) or one K1 launch (Parallel), plus one more where it
        restarts; no K2 launch. After a call, ``run.last_stats`` holds its
        ``tcg_iterations`` and ``restarts``."""
        cfg, R = self.config, self.problem.num_robots
        gnc = cfg.robust_cost_type != RobustCostType.L2
        sched = self.update_schedule(max_iters, schedule)

        @profiling.spanned("rbcd.fused_run")
        def run(st: RBCDState):
            X0 = st.X
            Pinv = self._solver_cache(self._edges(st.weights))
            with profiling.span("rbcd.read"):
                rel = st.rel_change.cpu().numpy().astype(np.float64)
            rel_h = np.full((max_iters, R), np.nan)
            ev_h = torch.zeros((max_iters,), dtype=torch.int8)
            last_wu, tcg, restarts = st.iteration, 0.0, 0
            while st.iteration < max_iters and not self._terminated(
                    rel, st.weight_update_count):
                i = st.iteration
                fired = gnc and self._round_due(i, last_wu, rel, st.weight_update_count)
                if fired:
                    last_wu = i
                    st, Pinv = self._weight_round(st, X0)
                st, k, (rel, _, _), restarted = self._step(st, int(sched[i]), Pinv)
                tcg, restarts = tcg + k, restarts + restarted
                rel_h[i], ev_h[i] = rel, int(fired)
            run.last_stats = {"tcg_iterations": int(tcg), "restarts": restarts}
            if record:
                return st, torch.tensor(rel_h, dtype=self.dtype, device=self.device), ev_h
            return st

        return run

    @profiling.spanned("rbcd.finalize")
    def finalize(self, state: RBCDState) -> Tuple[np.ndarray, RBCDState]:
        """TERMINATE semantics (reference ``PGOAgentROS.cpp:1036-1082``):
        under GNC_TLS, settle the undecided loop-closure weights by final
        residual (``gnc_finalize_by_residual``) or reject them; then round
        to SE(d) and anchor the first pose."""
        cfg = self.config
        if cfg.robust_cost_type == RobustCostType.GNC_TLS:
            w = state.weights
            und = (self.problem.edges.is_loop > 0) & (w > 1e-6) & (w < 1.0 - 1e-6)
            if cfg.gnc_finalize_by_residual:
                r = robust.measurement_residuals(
                    rounding.round_solution(state.X), self._edges(w)
                )
                w = torch.where(und, (r <= cfg.GNC_barc).to(w.dtype), w)
            else:
                w = torch.where(und, torch.zeros_like(w), w)
            state = state._replace(weights=w)
        T = rounding.anchor_to_first_pose(rounding.round_solution(state.X))
        return T.cpu().numpy(), state
