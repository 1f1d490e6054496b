"""The multi-robot RBCD engine (main-path subset), on torch tensors.

Port of ``dpgo_ros_tpu/parallel/rbcd.py``: synchronous Riemannian block-
coordinate descent over robot pose blocks on one global lifted state X.

* ``RoundRobin`` — one robot optimizes its block per iteration (the
  reference's synchronous token passing).
* ``Parallel`` — robots are greedily colored (adjacent iff they share an
  edge); all robots of one color update at once as one masked solve on the
  union mask, whose Hessian is block-diagonal across the color class.

Each block update is one ``fused_rtr.rtr_solve_fused`` call: the CUDA
kernel on a CUDA device (float32 only), its plain version on the CPU.
Acceleration, robust costs (GNC) and the Uniform
rule are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dpgo_ros_tpu.types import EdgeType
from dpgo_ros_tpu.utils.config import (
    AgentConfig,
    InitMethod,
    RobustCostType,
    SolverMethod,
    UpdateRule,
)
from dpgo_ros_tpu_torch.models.local_solvers import RTRParams
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import chordal as chordal_ops
from dpgo_ros_tpu_torch.ops import fused_rtr, lie, quadratic, rounding, stiefel
from dpgo_ros_tpu_torch.ops.quadratic import EdgeSet, build_pull_index


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


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to dpgo_ros_tpu_torch yet")


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
        if cfg.acceleration:
            _not_ported("acceleration")
        if cfg.robust_cost_type != RobustCostType.L2:
            _not_ported(f"robust cost {cfg.robust_cost_type.value}")
        if cfg.update_rule == UpdateRule.UNIFORM:
            _not_ported("the Uniform update rule")
        if cfg.solver != SolverMethod.RTR:
            _not_ported(f"the {cfg.solver.value} local solver")
        if cfg.local_initialization_method == InitMethod.GNC_TLS:
            _not_ported("GNC_TLS local initialization")
        if cfg.relative_change_metric != "block_frobenius":
            _not_ported(f"relative_change_metric={cfg.relative_change_metric}")
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
        return chordal_ops.chordal_initialization(es, nk, max_iters=500)

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

    def initialize(
        self,
        trajectory: Optional[np.ndarray] = None,
        ylift: Optional[np.ndarray] = None,
    ) -> RBCDState:
        """Local init per robot → frame alignment → anchor → lift through
        the shared YLift. ``ylift`` (r, d) overrides the sampled lifting
        matrix (the only random input of the main path); otherwise it is
        drawn from a CPU ``torch.Generator`` seeded with ``config.seed``."""
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
        if ylift is not None:
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
            fixed_mask=torch.ones_like(weights),
            mu=self._t(cfg.GNC_init_mu),
            weight_update_count=0,
        )

    # ------------------------------------------------------------------ steps

    def _solver_cache(self, e: EdgeSet) -> torch.Tensor:
        """Damped block-Jacobi inverse for the current weights, computed
        once per weight set and passed to every block solve."""
        return quadratic.precond_inverse(
            quadratic.precond_blocks(e, self.problem.n)
        ).contiguous()

    def _local_solve(self, X, e, mask, Pinv) -> Tuple[torch.Tensor, torch.Tensor]:
        """One masked block solve → (X_new, f_opt): the kernel for CUDA
        tensors, its plain version for CPU tensors."""
        Xk, stats = fused_rtr.rtr_solve_fused(
            X, mask, Pinv, e, self.rtr_params, offsets=self._offsets
        )
        return torch.where(mask > 0, Xk, X), stats[fused_rtr.S_F].to(self.dtype)

    def _block_update(self, st: RBCDState, mask, e, Pinv):
        """One masked block update (no acceleration): (X_new, V_new, f, θ)."""
        X_new, f_opt = self._local_solve(st.X, e, mask, Pinv)
        return X_new, X_new, f_opt, st.theta

    def _finish_step(self, st: RBCDState, X_new, V_new, f_opt, theta, mask):
        """Per-robot block-Frobenius relative change, with the neighbour
        invalidation bump: a robot not updated this step keeps at least
        max_k adj[k, j] · moved_k, so termination needs a quiescent
        neighbourhood. Returns (state, rel change of this step)."""
        per_pose2 = torch.sum((X_new - st.X) ** 2, dim=(-2, -1))
        sel = mask[:, 0, 0]
        moved = torch.sqrt(self._onehot @ (sel * per_pose2))
        rc = torch.sqrt(torch.sum(sel * per_pose2))
        updated = torch.amax(self._onehot * sel, dim=1)
        bump = (moved * updated) @ self._adjf
        rel_change = torch.where(
            updated > 0, moved, torch.maximum(st.rel_change, bump)
        )
        return RBCDState(
            X=X_new,
            X_prev=torch.where(mask > 0, st.X, st.X_prev),
            V=V_new,
            theta=theta,
            iteration=st.iteration + 1,
            cost=f_opt,
            rel_change=rel_change,
            weights=st.weights,
            fixed_mask=st.fixed_mask,
            mu=st.mu,
            weight_update_count=st.weight_update_count,
        ), rc

    def _step_sequential_impl(self, st: RBCDState, robot: int, Pinv=None):
        """The robot holding the update token optimizes its block."""
        e = self._edges(st.weights)
        mask = self._masks[robot]
        Pinv = Pinv if Pinv is not None else self._solver_cache(e)
        return self._finish_step(st, *self._block_update(st, mask, e, Pinv), mask)

    def _step_parallel_impl(self, st: RBCDState, color: int, Pinv=None):
        """All robots of one color update at once (union-mask block solve)."""
        e = self._edges(st.weights)
        mask = self._color_masks[color]
        Pinv = Pinv if Pinv is not None else self._solver_cache(e)
        return self._finish_step(st, *self._block_update(st, mask, e, Pinv), mask)

    # ------------------------------------------------------------------ run

    def run(
        self,
        state: Optional[RBCDState] = None,
        max_iters: Optional[int] = None,
        callback=None,
    ) -> Tuple[RBCDState, Dict]:
        """Scheduled block updates until every robot's relative change is
        below ``relative_change_tolerance`` or ``max_iters`` updates ran.
        Returns (final_state, info) with the per-iteration history."""
        cfg, prob = self.config, self.problem
        if state is None:
            state = self.initialize()
        max_iters = max_iters or cfg.max_iteration_number
        history: Dict[str, list] = {
            "iteration": [], "cost": [], "rel_change": [],
            "rel_change_robots": [], "iter_time_sec": [],
        }
        t_start = time.time()
        Pinv = self._solver_cache(self._edges(state.weights))
        it = 0
        rel = np.asarray(state.rel_change.cpu())
        while it < max_iters:
            t0 = time.time()
            if cfg.update_rule == UpdateRule.PARALLEL:
                state, rc = self._step_parallel_impl(
                    state, state.iteration % self.num_colors, Pinv
                )
            else:
                state, rc = self._step_sequential_impl(
                    state, state.iteration % prob.num_robots, Pinv
                )
            rel = state.rel_change.cpu().numpy().astype(np.float64)
            it += 1
            history["iteration"].append(it)
            history["cost"].append(float(state.cost))
            history["rel_change"].append(float(rc))
            history["rel_change_robots"].append(rel)
            history["iter_time_sec"].append(time.time() - t0)
            if callback is not None:
                callback(it, state)
            if bool(np.all(rel < cfg.relative_change_tolerance)):
                break
        info = {
            "history": history,
            "iterations": it,
            "total_time_sec": time.time() - t_start,
            "final_cost": float(state.cost),
            "converged": bool(np.all(rel < cfg.relative_change_tolerance)),
        }
        return state, info

    def finalize(self, state: RBCDState) -> Tuple[np.ndarray, RBCDState]:
        """Round to SE(d) and anchor the first pose (L2 TERMINATE)."""
        T = rounding.anchor_to_first_pose(rounding.round_solution(state.X))
        return T.cpu().numpy(), state
