"""The spmd mesh program: robot blocks on mesh slots, one step per call.

Port of ``dpgo_ros_tpu/parallel/spmd.py``. The JAX package runs a fleet as
one ``shard_map`` program over a device mesh: one robot block per mesh
slot, the separator exchange (``msg/PublicPoses.msg``) one ``all_gather``,
GNC weights recomputed identically on every slot from the gathered state.
Here a process owns a contiguous range of slots
(``multihost.SlotMesh``): one process may own them all (the one-card
case), or several processes share the mesh and exchange through
``torch.distributed``.

Layout (as JAX's): with M slots and per-slot padding n_max,

* ``X`` (M, n_max, r, d+1) — each process holds its slots' rows;
* each slot's edges (E_max, ...) — every edge incident to its block
  (odometry, private loop closures and its copy of each shared one), with
  endpoints in the gathered pose space slot·n_max + frame.

One step (:func:`build_spmd_step`): the exchange (full blocks, or only the
separator slabs with inert template poses elsewhere), then for each active
slot of the colour class one masked RTR solve of its block against the
gathered state — K1, ``fused_rtr.rtr_solve_fused``, on the slot's window
(``hbm_rtr.prepare_slot_window``) — or, in stretch mode (S > 1 steps per
launch), one K2 launch (``fused_rtr.rtr_run_fused``) running S steps
against the separators of the launch; Nesterov acceleration, the rel
change and the GNC weight round as JAX's step. On the card the kernel
route is the default for fp32 (``use_fused_kernel`` None), as JAX's is on a
TPU; ``use_fused_kernel=False`` runs the plain ``rtr_solve``. On the CPU
the wrappers run their plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from dpgo_ros_tpu_torch.models import robust
from dpgo_ros_tpu_torch.models.local_solvers import RTRParams, rtr_solve
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import fused_rtr, hbm_rtr, quadratic, rounding, stiefel
from dpgo_ros_tpu_torch.ops.quadratic import EdgeSet, build_pull_index
from dpgo_ros_tpu_torch.parallel.multihost import SlotMesh, local_mesh
from dpgo_ros_tpu_torch.types import EdgeType, MeasurementBatch, PoseGraphData
from dpgo_ros_tpu_torch.utils.config import AgentConfig, RobustCostType


def _relabel(data, mb, src_robot, dst_robot, src_frame, dst_frame, same_order,
             num_poses, initial_guess):
    """PoseGraphData with the measurements relabeled and re-classified in
    the new robot coordinates: consecutive same-robot edges are odometry
    (``same_order``: consecutive in the global order), other same-robot
    edges private loop closures, the rest shared."""
    same = src_robot == dst_robot
    odo = same & same_order & (mb.edge_type != EdgeType.PRIVATE_LOOP_CLOSURE)
    et = np.where(
        odo, EdgeType.ODOMETRY,
        np.where(same, EdgeType.PRIVATE_LOOP_CLOSURE, EdgeType.SHARED_LOOP_CLOSURE),
    ).astype(np.int32)
    out = MeasurementBatch(
        src_robot=src_robot, src_frame=src_frame,
        dst_robot=dst_robot, dst_frame=dst_frame,
        R=mb.R, t=mb.t, kappa=mb.kappa, tau=mb.tau, weight=mb.weight,
        fixed_weight=mb.fixed_weight | (et == EdgeType.ODOMETRY),
        edge_type=et,
    )
    return PoseGraphData(measurements=out, num_poses=num_poses, d=data.d,
                         initial_guess=initial_guess)


def group_robots(data, num_groups: int):
    """Remap a fleet onto ``num_groups`` "super-robots" (contiguous robot
    ranges) so a fleet larger than the mesh fits: each slot owns one group
    and its masked solve optimizes the whole group's poses jointly.
    Odometry chains heal across original-robot boundaries inside a group.
    Returns a new PoseGraphData with robots relabeled to groups."""
    nR = data.num_robots
    assert 1 <= num_groups <= nR
    per = nR // num_groups
    group_of = np.minimum(np.arange(nR) // per, num_groups - 1)
    frame_off = np.zeros(nR, np.int64)  # each robot's frame offset in its group
    for g in range(num_groups):
        off = 0
        for m in np.where(group_of == g)[0]:
            frame_off[m] = off
            off += int(data.num_poses[m])
    mb = data.measurements
    src_frame = (frame_off[mb.src_robot] + mb.src_frame).astype(np.int32)
    dst_frame = (frame_off[mb.dst_robot] + mb.dst_frame).astype(np.int32)
    num_poses = np.array([
        int(sum(data.num_poses[m] for m in np.where(group_of == g)[0]))
        for g in range(num_groups)
    ], np.int64)
    return _relabel(
        data, mb, group_of[mb.src_robot].astype(np.int32),
        group_of[mb.dst_robot].astype(np.int32), src_frame, dst_frame,
        src_frame + 1 == dst_frame, num_poses, None,
    )


def repartition_slots(data, num_slots: int):
    """Work-balanced contiguous re-partition of the global pose sequence
    into ``num_slots`` slot blocks: splits hot robots across slots and
    co-schedules cold ones. Per-pose work is 1 + the edges sourced at the
    pose; the cut is the min-max contiguous partition (binary search of the
    block capacity, greedy fill), with the heaviest blocks split while the
    greedy fill uses fewer blocks than slots. Labels change only, so costs
    are partition-invariant; cross-slot edges become shared loop closures.
    Returns a new PoseGraphData with ``num_slots`` relabeled robots."""
    num_poses = np.asarray(data.num_poses, np.int64)
    offs = np.concatenate([[0], np.cumsum(num_poses)])
    n = int(offs[-1])
    assert 1 <= num_slots <= n
    mb = data.measurements
    gsrc = offs[mb.src_robot] + mb.src_frame
    gdst = offs[mb.dst_robot] + mb.dst_frame
    w = np.ones(n, np.float64)
    np.add.at(w, gsrc, 1.0)
    cw = np.concatenate([[0.0], np.cumsum(w)])

    def blocks_for(cap):
        bounds = [0]
        while bounds[-1] < n:
            s = bounds[-1]
            e = int(np.searchsorted(cw, cw[s] + cap, side="right")) - 1
            bounds.append(min(max(e, s + 1), n))
        return bounds

    lo, hi = float(w.max()), float(w.sum())
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if len(blocks_for(mid)) - 1 <= num_slots:
            hi = mid
        else:
            lo = mid
    bounds = blocks_for(hi)
    while len(bounds) - 1 < num_slots:
        loads = [cw[bounds[k + 1]] - cw[bounds[k]] for k in range(len(bounds) - 1)]
        k = int(np.argmax([ld if bounds[i + 1] - bounds[i] > 1 else -1.0
                           for i, ld in enumerate(loads)]))
        cut = int(np.searchsorted(cw, 0.5 * (cw[bounds[k]] + cw[bounds[k + 1]])))
        bounds.insert(k + 1, min(max(cut, bounds[k] + 1), bounds[k + 1] - 1))
    bounds = np.asarray(bounds, np.int64)
    slot_of = (np.searchsorted(bounds, np.arange(n), side="right") - 1).astype(np.int32)
    start_of = bounds[:-1]
    src_robot, dst_robot = slot_of[gsrc], slot_of[gdst]
    return _relabel(
        data, mb, src_robot, dst_robot,
        (gsrc - start_of[src_robot]).astype(np.int32),
        (gdst - start_of[dst_robot]).astype(np.int32),
        gsrc + 1 == gdst, (bounds[1:] - bounds[:-1]).astype(np.int64),
        getattr(data, "initial_guess", None),
    )


@dataclasses.dataclass
class ShardedProblem:
    """Host-side per-slot arrays (numpy), JAX's layout field for field."""

    X0: np.ndarray  # (M, n_max, r, d+1)
    src: np.ndarray  # (M, E_max) int32, gathered pose indices
    dst: np.ndarray  # (M, E_max)
    R: np.ndarray  # (M, E_max, d, d)
    t: np.ndarray  # (M, E_max, d)
    kappa: np.ndarray  # (M, E_max)
    tau: np.ndarray  # (M, E_max)
    weight: np.ndarray  # (M, E_max)
    mask: np.ndarray  # (M, E_max) 1 on real copies, 0 on padding
    is_loop: np.ndarray  # (M, E_max)
    gidx: np.ndarray  # (M, E_max) int32 global edge id, -1 on padding
    pose_valid: np.ndarray  # (M, n_max) 1 for real poses
    color: np.ndarray  # (M,) colour class of each slot's robot
    num_colors: int
    n_max: int
    M: int
    r: int
    d: int
    # per-slot LOCAL indices of the poses cross-slot edges touch, padded to
    # S_max (sep_valid marks real entries): the PublicPoses payload
    sep_idx: np.ndarray = None  # (M, S_max) int32
    sep_valid: np.ndarray = None  # (M, S_max)
    S_max: int = 0

    @staticmethod
    def build(
        problem: LiftedProblem,
        X0_global: np.ndarray,
        robot_colors: np.ndarray,
        num_devices: Optional[int] = None,
        dtype=np.float32,
    ) -> "ShardedProblem":
        """One robot per slot (slots past the robots are inert, with no
        poses). Shared edges go to both endpoint slots at full weight, as
        each reference robot stores every shared loop closure it takes part
        in; each copy only enters its owner's masked solve."""
        nR = problem.num_robots
        M = num_devices or nR
        assert M >= nR, "need at least one mesh slot per robot"
        n_max = int(np.max(problem.num_poses))
        e = problem.host_edges
        src, dst = np.asarray(e.src), np.asarray(e.dst)
        rop = np.asarray(problem.robot_of_pose)
        src_r, dst_r = rop[src], rop[dst]
        gpad_of = rop * n_max + (np.arange(problem.n) - problem.offsets[rop])

        per_slot = [[] for _ in range(M)]
        for k in np.where(np.asarray(e.mask) > 0)[0]:
            a, b = int(src_r[k]), int(dst_r[k])
            per_slot[a].append(k)
            if a != b:
                per_slot[b].append(k)
        E_max = max(1, max(len(v) for v in per_slot))
        S = dict(
            src=np.zeros((M, E_max), np.int32),
            dst=np.zeros((M, E_max), np.int32),
            gidx=np.full((M, E_max), -1, np.int32),
            R=np.zeros((M, E_max, problem.d, problem.d), dtype),
            t=np.zeros((M, E_max, problem.d), dtype),
            kappa=np.zeros((M, E_max), dtype),
            tau=np.zeros((M, E_max), dtype),
            weight=np.zeros((M, E_max), dtype),
            mask=np.zeros((M, E_max), dtype),
            is_loop=np.zeros((M, E_max), dtype),
        )
        fields = dict(src=gpad_of[src].astype(np.int32), dst=gpad_of[dst].astype(np.int32),
                      R=e.R, t=e.t, kappa=e.kappa, tau=e.tau, weight=e.weight,
                      is_loop=e.is_loop)
        for m in range(M):
            idxs = per_slot[m] if m < nR else []
            k = len(idxs)
            for name, arr in fields.items():
                S[name][m][:k] = np.asarray(arr)[idxs]
            S["gidx"][m][:k] = idxs
            S["mask"][m][:k] = 1.0

        X0 = np.zeros((M, n_max, problem.r, problem.d + 1), dtype)
        pv = np.zeros((M, n_max), dtype)
        for k in range(nR):
            nk, o = int(problem.num_poses[k]), int(problem.offsets[k])
            X0[k, :nk] = X0_global[o:o + nk]
            pv[k, :nk] = 1.0
        # padded rows and empty slots hold a valid Stiefel point
        eye = np.zeros((problem.r, problem.d), dtype)
        eye[:problem.d, :problem.d] = np.eye(problem.d)
        for k in range(M):
            X0[k, int(problem.num_poses[k]) if k < nR else 0:, :, :problem.d] = eye

        colors = np.zeros((M,), np.int32)
        colors[:nR] = robot_colors
        cross = (np.asarray(e.mask) > 0) & (src_r != dst_r)
        seps = [set() for _ in range(M)]
        for k in np.where(cross)[0]:
            seps[int(src_r[k])].add(int(gpad_of[src[k]]) % n_max)
            seps[int(dst_r[k])].add(int(gpad_of[dst[k]]) % n_max)
        S_max = max(1, max((len(s) for s in seps), default=1))
        sep_idx = np.zeros((M, S_max), np.int32)
        sep_valid = np.zeros((M, S_max), np.float32)
        for m in range(M):
            ids = sorted(seps[m])
            sep_idx[m, :len(ids)] = ids
            sep_valid[m, :len(ids)] = 1.0
        return ShardedProblem(
            X0=X0, pose_valid=pv, color=colors,
            num_colors=int(robot_colors.max()) + 1, n_max=n_max, M=M,
            r=problem.r, d=problem.d, sep_idx=sep_idx, sep_valid=sep_valid,
            S_max=S_max, **S,
        )


class SpmdState(NamedTuple):
    """Solver state of one process's slots (rows lo..hi of the mesh's M);
    JAX's fields, so each package reads the other's checkpoints
    (:func:`gather_state`). The counters are the same on every slot and
    live on the host."""

    X: torch.Tensor  # (L, n_max, r, d+1)
    X_prev: torch.Tensor
    V: torch.Tensor  # auxiliary blocks (the is_auxiliary PublicPoses)
    theta: torch.Tensor  # (L, 1) Nesterov scalar per slot
    iteration: int
    rel_change: torch.Tensor  # (L, 1)
    weights: torch.Tensor  # (L, E_max)
    mu: torch.Tensor  # (L, 1)
    wuc: int  # weight rounds so far


_INT_FIELDS = ("iteration", "wuc")


def _gather_slots(mesh: SlotMesh, x: torch.Tensor, M: int) -> torch.Tensor:
    """(M, ...) of every process's (L_p, ...) slot rows, in slot order.

    One process: no collective. Several: each sends ``mesh.local_slots``
    rows (zero-padded); NCCL gathers on the card; gloo gathers host copies
    with the list form of ``all_gather`` (several processes on one card
    cannot use NCCL, and gloo's CUDA support is not relied on). A failed
    collective raises."""
    if mesh.num_processes == 1:
        return x
    import torch.distributed as dist

    L = mesh.local_slots
    if x.shape[0] < L:
        x = torch.cat([x, x.new_zeros((L - x.shape[0],) + tuple(x.shape[1:]))])
    if mesh.backend == "nccl":
        out = x.new_empty((mesh.num_processes * L,) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous())
        return out[:M]
    h = x.detach().cpu().contiguous()
    parts = [torch.empty_like(h) for _ in range(mesh.num_processes)]
    dist.all_gather(parts, h)
    return torch.cat(parts)[:M].to(x.device)


def _live_pull(src: np.ndarray, dst: np.ndarray, live: np.ndarray, n: int) -> np.ndarray:
    """The pull index of a slot's edges over n poses, its padding copies
    (``live`` 0) left out: their terms are zero, and as (0, 0) self-loops
    they would give pose 0 a pull row as long as the padding."""
    ids = np.flatnonzero(live > 0)
    E = src.size
    p = build_pull_index(src[ids], dst[ids], n).astype(np.int64)
    full = np.concatenate([ids, E + ids, [2 * E]])
    return full[p].astype(np.int32)


class SpmdStep:
    """One process's step of the mesh program (:func:`build_spmd_step`).

    ``step(step_idx, do_weight_update, st)`` runs JAX's step on the
    process's slots. Counters since construction: ``solves`` (block solves
    of active slots, restarts included; K1 or K2 launches on the kernel
    route), ``restarts`` and ``exchange_bytes`` (bytes this process sends
    per separator exchange)."""

    def __init__(self, sp: ShardedProblem, config: AgentConfig, mesh: SlotMesh):
        cfg = self.config = config.resolve()
        self.sp, self.mesh = sp, mesh
        self.rtr = RTRParams(max_iterations=cfg.RTR_iterations,
                             max_tcg_iterations=cfg.RTR_tCG_iterations,
                             gradnorm_tol=cfg.RTR_gradnorm_tol)
        M, n_max = sp.M, sp.n_max
        self.n = M * n_max
        self.dev = mesh.device
        self.dtype = torch.float64 if sp.X0.dtype == np.float64 else torch.float32
        self.slots = mesh.slots(M)
        self.gnc = cfg.robust_cost_type == RobustCostType.GNC_TLS
        self.adaptive = self.gnc and cfg.GNC_schedule == "adaptive"
        S = max(1, int(cfg.spmd_steps_per_launch))
        stretch_rgd = cfg.spmd_stretch_rgd_stepsize
        # JAX's default: separator-only whenever the separator sets exist
        # (GNC rounds gather the full X themselves)
        self.sep_only = sp.sep_idx is not None and cfg.spmd_separator_only is not False
        if (self.dev.type == "cuda" and self.dtype != torch.float32
                and cfg.use_fused_kernel is not False):
            # on the card the slot solves are K1/K2, which are float32 only;
            # the plain route runs there only when the caller turns them off
            raise ValueError("the CUDA block-solve kernel is float32 only "
                             "(use_fused_kernel=False runs the plain solve)")
        auto = self.dtype == torch.float32 and self.dev.type == "cuda"
        self.use_kernel = (cfg.use_fused_kernel if cfg.use_fused_kernel is not None
                           else auto) and self.dtype == torch.float32
        if S > 1 and not self.use_kernel:
            S = 1  # stretches need the multi-step kernel (JAX's rule)
        if S > 1 and M > 1 and stretch_rgd is None:
            # multi-slot stretches: full block solves against S-step-stale
            # separators diverge; RGD ticks (ASAPP) tolerate the staleness
            stretch_rgd = float(cfg.RGD_stepsize)
        if S > 1 and stretch_rgd is None and sp.num_colors > 1:
            raise ValueError("an RTR stretch needs every slot active on every step")
        self.S, self.stretch_rgd = S, stretch_rgd
        self.solves = self.restarts = 0

        f = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.dev)
        self._edges: List[EdgeSet] = []
        self._windows: List[Optional[hbm_rtr.Windows]] = []
        self._own: List[torch.Tensor] = []  # (n, 1, 1) the block's mask
        for m in self.slots:
            live = sp.mask[m]
            self._edges.append(EdgeSet(
                src=torch.as_tensor(sp.src[m], dtype=torch.int64, device=self.dev),
                dst=torch.as_tensor(sp.dst[m], dtype=torch.int64, device=self.dev),
                R=f(sp.R[m]), t=f(sp.t[m]), kappa=f(sp.kappa[m]), tau=f(sp.tau[m]),
                weight=f(sp.weight[m]), mask=f(live), is_loop=f(sp.is_loop[m]),
                pull=torch.as_tensor(_live_pull(sp.src[m], sp.dst[m], live, self.n),
                                     device=self.dev),
            ))
            size = int(sp.pose_valid[m].sum())
            self._windows.append(
                hbm_rtr.prepare_slot_window(sp.src[m], sp.dst[m], live, m * n_max,
                                            size, self.n, self.dev)
                if size and self.use_kernel else None)
            own = np.zeros(self.n)
            own[m * n_max:(m + 1) * n_max] = sp.pose_valid[m]
            self._own.append(f(own)[:, None, None])
        self._has_block = [bool(sp.pose_valid[m].any()) for m in self.slots]
        self._Pinv = [None] * len(self.slots)
        self._Pinv_w = [None] * len(self.slots)
        if self.sep_only:
            gpos = (np.arange(M)[:, None] * n_max + sp.sep_idx).reshape(-1)
            gpos = np.where(sp.sep_valid.reshape(-1) > 0, gpos, self.n)  # dump row
            self._gpos = torch.as_tensor(gpos, dtype=torch.int64, device=self.dev)
            self._sep = [torch.as_tensor(sp.sep_idx[m], dtype=torch.int64, device=self.dev)
                         for m in self.slots]
            pad = torch.zeros((sp.r, sp.d + 1), dtype=self.dtype, device=self.dev)
            pad[:sp.d, :sp.d] = torch.eye(sp.d, dtype=self.dtype, device=self.dev)
            self._tmpl = pad.expand(self.n + 1, sp.r, sp.d + 1)
        width = sp.S_max if self.sep_only else n_max
        self.exchange_bytes = (2 * mesh.local_slots * width * sp.r * (sp.d + 1)
                               * torch.finfo(self.dtype).bits // 8)
        if S > 1:  # K2's one bank row and all-active schedule per slot
            self._sched = torch.zeros(S, dtype=torch.int32, device=self.dev)

    # ------------------------------------------------------------ state

    def init_state(self) -> SpmdState:
        sp, cfg = self.sp, self.config
        lo, hi = self.slots.start, self.slots.stop
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=self.dtype,
                                      device=self.dev)
        L = hi - lo
        return SpmdState(
            X=t(sp.X0[lo:hi]), X_prev=t(sp.X0[lo:hi]), V=t(sp.X0[lo:hi]),
            theta=t(np.ones((L, 1))), iteration=0,
            rel_change=t(np.full((L, 1), np.inf)), weights=t(sp.weight[lo:hi]),
            mu=t(np.full((L, 1), cfg.GNC_init_mu)), wuc=0,
        )

    def _pinv(self, l: int, W: torch.Tensor) -> torch.Tensor:
        """Slot l's damped block-Jacobi inverse under the state's weights
        ``W`` (L, E_max), recomputed when they are another tensor (after a
        weight round or a resume)."""
        if self._Pinv_w[l] is not W:
            e = dataclasses.replace(self._edges[l], weight=W[l])
            self._Pinv[l] = quadratic.precond_inverse(
                quadratic.precond_blocks(e, self.n)).contiguous()
            self._Pinv_w[l] = W
        return self._Pinv[l]

    # ------------------------------------------------------------ exchange

    def _exchange(self, st: SpmdState):
        """(Xg, Vg) per local slot, each (M·n_max, r, d+1): the gathered
        state (full exchange: one tensor for every slot), or the template
        with every slot's separator slab and the slot's own fresh block
        (separator-only exchange). (X, V) travel in one collective."""
        sp, M = self.sp, self.sp.M
        shape = (self.n, sp.r, sp.d + 1)
        if not self.sep_only:
            g = _gather_slots(self.mesh, torch.stack([st.X, st.V], 1), M)
            Xg, Vg = g[:, 0].reshape(shape), g[:, 1].reshape(shape)
            return [(Xg, Vg)] * len(self.slots)
        slabs = torch.stack([
            torch.stack([st.X[l][s], st.V[l][s]]) for l, s in enumerate(self._sep)
        ]) if len(self.slots) else st.X.new_zeros((0, 2, sp.S_max, sp.r, sp.d + 1))
        g = _gather_slots(self.mesh, slabs, M)
        base = []
        for k in range(2):
            b = self._tmpl.clone()
            b[self._gpos] = g[:, k].reshape(M * sp.S_max, sp.r, sp.d + 1)
            base.append(b[:self.n])
        out = []
        for l, m in enumerate(self.slots):
            a = m * sp.n_max
            Xg, Vg = base[0].clone(), base[1].clone()
            Xg[a:a + sp.n_max], Vg[a:a + sp.n_max] = st.X[l], st.V[l]
            out.append((Xg, Vg))
        return out

    # ------------------------------------------------------------ solves

    def _solve(self, l: int, Xfull: torch.Tensor, e: EdgeSet, Pinv) -> torch.Tensor:
        """Slot l's masked block solve from ``Xfull``: one K1 launch on its
        window, one K2 launch of S steps in stretch mode, or the plain
        ``rtr_solve`` with the kernel route off; other poses unchanged."""
        mask = self._own[l]
        self.solves += 1
        if not self.use_kernel:
            Z, _ = rtr_solve(Xfull, e, mask, Pinv, self.rtr)
        elif self.S == 1:
            Z, _ = fused_rtr.rtr_solve_fused(Xfull, mask, Pinv, e, self.rtr,
                                             windows=self._windows[l], row=0)
        else:
            w = self._windows[l]
            R = w.num_robots
            Z = fused_rtr.rtr_run_fused(
                Xfull, mask.reshape(1, -1).contiguous(), self._sched, Pinv, e, self.rtr,
                adj=Xfull.new_zeros((R, R)), rel0=Xfull.new_ones((R,)), it0=0,
                last_wu=0, gnc_pending=False, cost0=0.0, it_cap=self.S, tol=0.0,
                gnc=False, inner=self.S, inner_tol=None,
                rgd_stepsize=float(self.stretch_rgd) if self.stretch_rgd else 0.0,
                offsets=w.offsets, windows=w,
            )[0]
        return torch.where(mask > 0, Z, Xfull)

    def _accelerated(self, l, st, Xg, Vg, e, Pinv, solves):
        """JAX's accelerated slot update: solve on V, the safeguard over the
        slot's edges (one host read), V's retraction or a restart from X (a
        second solve). Returns (X_new full, V own block, θ)."""
        cfg, sp = self.config, self.sp
        a, b = self.slots[l] * sp.n_max, (self.slots[l] + 1) * sp.n_max
        theta = st.theta[l, 0]
        theta_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * theta ** 2))
        beta = (cfg.acceleration_beta if cfg.acceleration_beta is not None
                else (theta - 1.0) / theta_new)
        if not solves:  # nothing moves: f_acc == f_cur, the ok branch
            return Xg, None, theta_new
        X_acc = torch.where(self._own[l] > 0, self._solve(l, Vg, e, Pinv), Xg)
        if bool(quadratic.cost(X_acc, e) <= quadratic.cost(Xg, e)):
            Xa, m = X_acc[a:b], self._own[l][a:b]
            Vk = stiefel.retract_polar_ns(
                Xa, beta * stiefel.proj_tangent(Xa, m * (Xa - st.X_prev[l])))
            return X_acc, torch.where(m > 0, Vk, Xa), theta_new
        self.restarts += 1
        X_r = self._solve(l, Xg, e, Pinv)
        return X_r, X_r[a:b], torch.ones_like(theta)

    # ------------------------------------------------------------ step

    def __call__(self, step_idx: int, do_weight_update: int, st: SpmdState) -> SpmdState:
        cfg, sp = self.config, self.sp
        step_idx = int(step_idx)
        views = self._exchange(st)
        Xs, Xps, Vs, thetas, rcs = [], [], [], [], []
        for l, m in enumerate(self.slots):
            Xg, Vg = views[l]
            a, b = m * sp.n_max, (m + 1) * sp.n_max
            # a stretch updates every slot on every one of its steps
            active = self.S > 1 or int(sp.color[m]) == step_idx % sp.num_colors
            solves = active and self._has_block[l]
            e = dataclasses.replace(self._edges[l], weight=st.weights[l])
            Pinv = self._pinv(l, st.weights) if solves else None
            if cfg.acceleration:
                X_new, V_own, theta = self._accelerated(l, st, Xg, Vg, e, Pinv, solves)
                if (step_idx + 1) % cfg.restart_interval == 0:
                    theta = torch.ones_like(theta)
            else:
                X_new = self._solve(l, Xg, e, Pinv) if solves else Xg
                V_own, theta = None, st.theta[l, 0]
            X_own = X_new[a:b]
            if active:
                per_pose = torch.sqrt(torch.sum((X_own - Xg[a:b]) ** 2, dim=(-2, -1)))
                rc = torch.max(per_pose * self._own[l][a:b, 0, 0])
                X_prev = Xg[a:b]
                V_own = V_own if V_own is not None else X_own
            else:
                # nothing of the slot moved, nor did the other slots' poses
                # in its gathered view: the stale rel change stays
                rc = torch.clamp(st.rel_change[l, 0], min=0.0)
                X_prev = st.X_prev[l]
                V_own = st.V[l] if cfg.acceleration else X_own
            Xs.append(X_own)
            Xps.append(X_prev)
            Vs.append(V_own)
            thetas.append(theta.reshape(()))
            rcs.append(rc.reshape(()))
        stack = lambda xs, like: torch.stack(xs) if xs else like
        X = stack(Xs, st.X)
        weights, mu, wuc = st.weights, st.mu, st.wuc
        if self.gnc and do_weight_update:
            weights = self._weight_round(X, st)
            mu, wuc = st.mu * cfg.GNC_mu_step, wuc + 1
        return SpmdState(
            X=X, X_prev=stack(Xps, st.X_prev), V=stack(Vs, st.V),
            theta=stack(thetas, st.theta.reshape(-1)).reshape(-1, 1),
            iteration=st.iteration + self.S,
            rel_change=stack(rcs, st.rel_change.reshape(-1)).reshape(-1, 1),
            weights=weights, mu=mu, wuc=wuc,
        )

    def _weight_round(self, X: torch.Tensor, st: SpmdState) -> torch.Tensor:
        """JAX's GNC weight round: the full gathered X (not the separator
        slabs) rounded globally, each slot's copies re-weighted from its
        residuals. The adaptive schedule's residual scale is the mean over
        all M slots of their loop residuals' P90 (an inert slot's is
        GNC_barc), gathered in slot order so every process layout sums the
        same way."""
        cfg, sp = self.config, self.sp
        Xall = _gather_slots(self.mesh, X, sp.M).reshape(self.n, sp.r, sp.d + 1)
        T = rounding.round_solution(Xall)
        res = [robust.measurement_residuals(T, e) for e in self._edges]
        if self.adaptive:
            p90l = []
            for e, r in zip(self._edges, res):
                rn = torch.where(e.is_loop * e.mask > 0, r, torch.full_like(r, float("nan")))
                p90l.append(torch.nan_to_num(torch.nanquantile(rn, 0.9), nan=cfg.GNC_barc))
            p90s = _gather_slots(
                self.mesh, torch.stack(p90l) if p90l else X.new_zeros((0,)), sp.M)
            p90 = torch.clamp(torch.mean(p90s), min=cfg.GNC_barc)
            K = max(int(cfg.robust_opt_num_weight_updates), 1)
            alpha = (st.wuc + 1.0) / K
            barc = torch.clamp(torch.exp((1.0 - alpha) * torch.log(p90)
                                         + alpha * np.log(cfg.GNC_barc)), min=cfg.GNC_barc)
        out = []
        for l, (e, r) in enumerate(zip(self._edges, res)):
            if self.adaptive:
                mu, bc = torch.tensor(3.0, dtype=self.dtype, device=self.dev), barc
            else:
                mu, bc = st.mu[l, 0], cfg.GNC_barc
            w, _ = robust.update_weights_gnc(st.weights[l], 1.0 - e.is_loop, r, mu, bc,
                                             cfg.GNC_mu_step)
            out.append(w)
        return torch.stack(out) if out else st.weights


def build_spmd_step(sp: ShardedProblem, config: AgentConfig,
                    mesh: Optional[SlotMesh] = None):
    """(init_state, step) of the mesh program on ``mesh``'s slots (default:
    one process owning all M slots on the card). ``step(step_idx,
    do_weight_update, st)`` is one coloured-parallel RBCD iteration (S of
    them in stretch mode) plus the GNC weight round when
    ``do_weight_update`` is 1, as JAX's."""
    if mesh is None:
        mesh = local_mesh(sp.M)
    step = SpmdStep(sp, config, mesh)
    return step.init_state(), step


# ---------------------------------------------------------------- host helpers


def _mesh_of(st: SpmdState, mesh: Optional[SlotMesh], M: int) -> SlotMesh:
    if mesh is None:
        if st.X.shape[0] != M:
            raise ValueError(f"a state of {st.X.shape[0]} slots of {M} needs its mesh")
        mesh = SlotMesh(1, 0, M, st.X.device)
    return mesh


def gather_state(st: SpmdState, M: int, mesh: Optional[SlotMesh] = None) -> SpmdState:
    """Full host copy of the mesh's state (numpy, all M slots, JAX's shapes:
    ``iteration`` and ``wuc`` (M, 1) int32); every process returns the same
    arrays. The durable checkpoint of a multi-process run: any process can
    write it, every process can load it and :func:`place_state` it."""
    mesh = _mesh_of(st, mesh, M)
    out = {}
    for k, v in st._asdict().items():
        if k in _INT_FIELDS:
            out[k] = np.full((M, 1), v, np.int32)
        else:
            out[k] = _gather_slots(mesh, v, M).detach().cpu().numpy()
    return SpmdState(**out)


def place_state(st_host: SpmdState, like: SpmdState,
                mesh: Optional[SlotMesh] = None) -> SpmdState:
    """This process's slots of a host state (the resume side of
    :func:`gather_state`), on ``like``'s device and dtype."""
    M = int(np.asarray(st_host.X).shape[0])
    mesh = _mesh_of(like, mesh, M)
    sl = mesh.slots(M)
    out = {}
    for k, h in zip(SpmdState._fields, st_host):
        h = np.asarray(h)
        if k in _INT_FIELDS:
            out[k] = int(h.reshape(-1)[0])
        else:
            out[k] = torch.as_tensor(np.ascontiguousarray(h[sl.start:sl.stop]),
                                     dtype=like.X.dtype, device=like.X.device)
    return SpmdState(**out)


def gather_weights(sp: ShardedProblem, st: SpmdState, num_global_edges: int,
                   mesh: Optional[SlotMesh] = None) -> np.ndarray:
    """The global (E,) robust weights from the slots' edge copies through
    ``gidx`` (the copies of a shared edge hold identical weights: every
    slot computes them from the same gathered state)."""
    W = _gather_slots(_mesh_of(st, mesh, sp.M), st.weights, sp.M).cpu().numpy()
    out = np.ones((num_global_edges,), W.dtype)
    sel = sp.gidx >= 0
    out[sp.gidx[sel]] = W[sel]
    return out


def gather_trajectory(sp: ShardedProblem, st: SpmdState, num_poses,
                      mesh: Optional[SlotMesh] = None) -> np.ndarray:
    """The global lifted state (n, r, d+1) from the slots' real rows;
    every process returns it."""
    X = _gather_slots(_mesh_of(st, mesh, sp.M), st.X, sp.M).cpu().numpy()
    return np.concatenate([X[k, :int(nk)] for k, nk in enumerate(num_poses)], axis=0)
