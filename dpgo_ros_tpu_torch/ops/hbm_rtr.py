"""The windowed block solve (K4) as a hand-written CUDA kernel on a
gathered window, its plain version and the window tables. The engine runs
every RoundRobin and Uniform block solve through it (``parallel/rbcd.py``);
the fleet's agents run every synchronous RTR solve through it on their
local problem's window (:func:`prepare_local_window`); the other solver
kernels run on the same kind of window: K2 one per bank row
(:func:`prepare_row_windows`), K1 the window of its mask's block (a
colour class's row, or :func:`prepare_mask_window`; its windowed plain
version is :func:`rtr_solve_window_ref`), K3 every robot's
(:func:`prepare_windows`); K1 and K2 on an spmd mesh slot's window
(:func:`prepare_slot_window`).

K4 ports ``dpgo_ros_tpu/ops/hbm_rtr.py::rtr_solve_hbm`` (the Pallas kernel
built by ``_make_hbm_kernel``, with ``prepare_operands`` and
``window_width``): one masked RTR block solve of one robot's block that
touches only what the block needs, so its cost follows the block and not
the world. The JAX kernel copies a contiguous 256-aligned lane window with
a halo out of memory-resident operands and takes banded graphs only; here
:func:`prepare_windows` builds, once per problem, each robot's window as
a gather: its block's poses in order, then its separator poses (the far
endpoints of the edges that touch the block) sorted; the global ids of
those edges in global edge order; their local endpoints; and a local pull
index. Any graph works, banded or not. Because the edges keep their global
order, each block pose's local pull row lists the same contributions in
the same order as its global row, so the kernel's gather-sums add in K1's
order. The tables hold structure only: R, t and the effective weights are
read through the global edge ids at every call, so a GNC weight round
needs no rebuild.

:func:`rtr_solve_hbm` launches the kernel (``csrc/rtr_window.cu``, one
thread-block cluster of :func:`cluster_size` CTAs, each owning a slice of
the window's poses cut by :func:`partition`) for CUDA tensors and raises if
it cannot be built or launched, or if no such cluster fits; for CPU tensors
it runs the plain version :func:`rtr_solve_hbm_ref` (gather the local
``EdgeSet``, the ported ``rtr_solve`` on it, scatter the block back). No
path falls back from one to the other. On both devices each row's first
call builds its launch record (``Windows.records``; on the card it holds
the kernel's record with the row's sizes and tables), and
later calls check the operands again only where what the checks read has
changed; κ_eff/τ_eff are computed once per weight set
(``Windows.effective_weights``). Counters: ``k4.records`` per record
built, ``k4.weights`` per κ_eff/τ_eff computed, ``k4.launches`` per CUDA
launch.

Stats vector (length 7): ``[f0, f, gn0, gn, TR iterations, tCG iterations,
moved]``, the JAX kernel's first 7 entries. f is the window's LOCAL cost
(the edges incident to the block), not the world's; only block poses move,
so the global cost moves by f − f0. X_new is a copy of X in which only the
block's poses changed: separators and every other pose are bit-identical.
"""

from __future__ import annotations

import ctypes
import dataclasses
from ctypes import c_float, c_int, c_longlong, c_void_p
from typing import Tuple

import numpy as np
import torch

from dpgo_ros_tpu_torch.models.local_solvers import RTRParams, rtr_solve
from dpgo_ros_tpu_torch.ops import kernels, quadratic
from dpgo_ros_tpu_torch.ops.quadratic import EdgeSet, build_pull_index
from dpgo_ros_tpu_torch.utils import profiling

S_MOVED = 6
STATS_LEN = 7


# the cluster of one launch (csrc/rtr_cluster.cuh): about one window pose
# per thread of a 256-thread CTA, at least 2 and at most 16 CTAs (Hopper's
# non-portable cluster size)
POSES_PER_CTA = 256
CLUSTER_MIN, CLUSTER_MAX = 2, 16
# a pose's pose-local work in a solve (its share of every pass, the
# 20-step Newton–Schulz retraction) counted in incident edges: the slices
# are cut by incident edges + POSE_WORK. On the card, 32 beat 2, 8 and 128
# (chip_smoke.py's slice sweep, PERF.md)
POSE_WORK = 32


def cluster_size(max_poses: int) -> int:
    """CTAs of the cluster that solves windows of up to ``max_poses``
    poses."""
    return int(min(CLUSTER_MAX, max(CLUSTER_MIN, -(-max_poses // POSES_PER_CTA))))


def partition(work: np.ndarray, parts: int) -> np.ndarray:
    """(parts + 1,) bounds cutting the poses 0..len(work)-1 into ``parts``
    contiguous slices of about equal total ``work``."""
    cum = np.cumsum(work, dtype=np.float64)
    cuts = np.searchsorted(cum, cum[-1] * np.arange(1, parts) / parts, side="right")
    return np.concatenate([[0], cuts, [work.size]]).astype(np.int64)


@dataclasses.dataclass
class Windows:
    """One window per row, packed as CSR. A row names robots (``rows[k]``:
    one robot for RoundRobin and Uniform, a colour class for Parallel);
    its block is the union of their poses, in order. Row k's local poses
    are ``poses[pose_off[k]:pose_off[k+1]]`` (its ``num_poses[k]`` block
    poses first, then its sorted separators) with their pull rows at the
    same positions of ``pull``, and its local edges
    ``edges/src/dst[edge_off[k]:edge_off[k+1]]``. Local pull entries index
    the window's contributions (local edge j as src ↦ j, as dst ↦ E_k + j,
    padding 2·E_k for E_k local edges). ``part[k]`` cuts row k's local
    poses into the ``cluster`` CTA slices of one launch, by work;
    ``meta`` holds per row ``[pose_off, edge_off, block size, row_off]``
    on the device for K2, ``row_robots`` the rows' robots (CSR by
    ``row_off``)."""

    n: int
    num_edges: int
    num_poses: np.ndarray  # (m,) block sizes
    pose_off: np.ndarray  # (m+1,) host
    edge_off: np.ndarray  # (m+1,) host
    poses: torch.Tensor  # (Σ nw,) int32 global pose ids
    edges: torch.Tensor  # (Σ ew,) int32 global edge ids, global order
    src: torch.Tensor  # (Σ ew,) int32 local endpoints
    dst: torch.Tensor
    pull: torch.Tensor  # (Σ nw, D) int32
    offsets: torch.Tensor  # (R+1,) int32 robot block bounds
    rows: Tuple[Tuple[int, ...], ...]
    row_robots: torch.Tensor  # (Σ robots of the rows,) int32
    meta: torch.Tensor  # (m+1, 4) int32
    cluster: int  # CTAs of one launch
    part: torch.Tensor  # (m, cluster+1) int32 slice bounds
    slice_max: int  # most poses in one slice
    # K4's launch record (_Record) of each row it solved; what the checks
    # of K1 (under ("k1", row)), K2 (("k2", sched offset)) and K3 ("k3")
    # last passed (kernels.hit)
    records: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)
    # the last effective_weights: its guard key, the weights, κ_eff, τ_eff
    _weights: tuple = dataclasses.field(default=None, init=False, repr=False,
                                        compare=False)

    @property
    def num_robots(self) -> int:
        return int(self.offsets.shape[0]) - 1

    @property
    def num_rows(self) -> int:
        return len(self.rows)

    @property
    def max_poses(self) -> int:
        return int(np.diff(self.pose_off).max())

    @property
    def max_edges(self) -> int:
        return int(np.diff(self.edge_off).max())

    def window(self, row: int):
        """(poses, edges, src, dst, pull) of one row: views of the tables."""
        a, b = int(self.pose_off[row]), int(self.pose_off[row + 1])
        c, e = int(self.edge_off[row]), int(self.edge_off[row + 1])
        return (self.poses[a:b], self.edges[c:e], self.src[c:e],
                self.dst[c:e], self.pull[a:b])

    def check(self, who: str, X: torch.Tensor, edges: EdgeSet) -> None:
        """Raise unless these are windows of X's world (its poses and
        edges) with their tables contiguous int32 on X's device."""
        if self.n != X.shape[0] or self.num_edges != edges.num_edges:
            raise ValueError(
                f"{who}: windows of a world of {self.n} poses and "
                f"{self.num_edges} edges, got {X.shape[0]} and {edges.num_edges}")
        if self.poses.device != X.device:
            raise ValueError(f"{who}: windows on {self.poses.device}, X on {X.device}")
        tables = ("poses", "edges", "src", "dst", "pull", "meta", "part", "row_robots")
        kernels.check_tensors(who, X, {f"windows.{name}": getattr(self, name)
                                       for name in tables}, torch.int32)

    def effective_weights(self, edges: EdgeSet) -> Tuple[torch.Tensor, torch.Tensor]:
        """``edges.effective_weights()``, computed once per weight set: kept
        until ``weight``, ``mask``, ``kappa`` or ``tau`` is another tensor
        or changed in place (``kernels.guard``)."""
        key, held = kernels.guard((), (edges.weight, edges.mask, edges.kappa, edges.tau))
        if not kernels.hit(self._weights, key):
            self._weights = (key, held, *edges.effective_weights())
            profiling.count("k4.weights")
        return self._weights[2:]

    def robots_of(self, row: int) -> torch.Tensor:
        """The robots of one row (a view of ``row_robots``)."""
        a = sum(len(r) for r in self.rows[:row])
        return self.row_robots[a:a + len(self.rows[row])]


def prepare_windows(problem) -> Windows:
    """Every robot's window of ``problem`` (a ``LiftedProblem``), built on
    the host from its static structure and placed on its device: K4's
    tables. The counterpart of the JAX package's ``prepare_operands`` +
    ``window_width``."""
    return prepare_row_windows(problem, [(k,) for k in range(problem.num_robots)])


@profiling.spanned("k4.windows")
def prepare_row_windows(problem, rows) -> Windows:
    """One window per row of robots (``rows``: sequences of robot ids, in
    ascending order): the union of their blocks, the edges with an endpoint
    in it, in global order, and their far endpoints. K2's tables, one per
    bank row; :func:`prepare_windows` is the one-robot case."""
    he = problem.host_edges
    bounds = np.concatenate([problem.offsets, [problem.n]])
    return _row_windows(he.src, he.dst, bounds, rows, problem.device)


def prepare_local_window(src, dst, n_block: int, n_total: int, device) -> Windows:
    """The one window of a fleet agent's local problem
    (``parallel/agent_node.py``): poses [0, n_block) are the agent's block,
    [n_block, n_total) its neighbours' separator slots, and ``src``/``dst``
    the local edges' endpoints in the agent's order. One row (robot 0 of
    bounds [0, n_block, n_total]): the block, then the slots the edges
    touch, sorted. The edges keep their order, so K4's gather-sums add in
    the order of ``rtr_solve`` on the whole local problem, and its f is the
    agent's local cost. Rebuild it with the local problem: ``check`` sees
    only a change of size."""
    bounds = np.array([0, n_block, n_total], np.int64)
    return _row_windows(src, dst, bounds, [(0,)], device)


def prepare_slot_window(src, dst, live, start: int, size: int, n: int,
                        device) -> Windows:
    """The one window of an spmd mesh slot (``parallel/spmd.py``): the
    slot's copies of its edges (``src``/``dst`` in the gathered pose space
    of n = M·n_max poses, ``live`` 0 on the padding copies, which no window
    holds) and its real poses [start, start + size) as the block. The
    bounds cut the pose space into the pieces before the block, the block
    and after it (empty pieces dropped), so the slot's padded rows and the
    other slots' poses belong to no block; the row is the block's piece.
    K1 and K2 (one bank row) solve on it; separators are the other slots'
    poses the live edges touch."""
    cuts = sorted({0, int(start), int(start) + int(size), int(n)})
    return _row_windows(src, dst, cuts, [(cuts.index(int(start)),)], device,
                        live=live)


def _row_windows(src, dst, bounds, rows, device, live=None) -> Windows:
    """:func:`prepare_row_windows` on a graph given by its edges' endpoints
    ``src``/``dst`` and its robots' block ``bounds`` ((R+1,), the last the
    pose count), its tables placed on ``device``; edges with ``live`` 0
    belong to no window."""
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    keep = np.ones(src.size, bool) if live is None else np.asarray(live) > 0
    bounds = np.asarray(bounds, np.int64)
    n = int(bounds[-1])
    rows = tuple(tuple(int(k) for k in row) for row in rows)
    loc = np.full(n, -1, np.int64)
    inblk = np.zeros(n, bool)
    poses, edges, lsrc, ldst, pulls, sizes = [], [], [], [], [], []
    for row in rows:
        if not row or list(row) != sorted(set(row)):
            raise ValueError(f"prepare_row_windows: row {row} is not ascending robots")
        blk = np.concatenate([np.arange(bounds[k], bounds[k + 1]) for k in row])
        inblk[blk] = True
        eids = np.flatnonzero((inblk[src] | inblk[dst]) & keep)
        ends = np.concatenate([src[eids], dst[eids]])
        sep = np.unique(ends[~inblk[ends]])
        inblk[blk] = False
        pk = np.concatenate([blk, sep])
        loc[pk] = np.arange(pk.size)
        ls, ld = loc[src[eids]], loc[dst[eids]]
        loc[pk] = -1
        poses.append(pk)
        edges.append(eids)
        lsrc.append(ls)
        ldst.append(ld)
        pulls.append(build_pull_index(ls, ld, pk.size))
        sizes.append(blk.size)
    D = max(p.shape[1] for p in pulls)
    max_nw = max(p.size for p in poses)
    nc = cluster_size(max_nw)
    part = np.stack([
        partition((p < 2 * e.size).sum(1) + float(POSE_WORK), nc)
        for p, e in zip(pulls, edges)
    ])
    pull = np.concatenate([
        np.pad(p, ((0, 0), (0, D - p.shape[1])), constant_values=2 * e.size)
        for p, e in zip(pulls, edges)
    ])
    i32 = lambda a: torch.as_tensor(np.asarray(a).astype(np.int32), device=device)
    csr = lambda parts: np.concatenate([[0], np.cumsum([len(p) for p in parts])])
    pose_off, edge_off, row_off = csr(poses), csr(edges), csr(rows)
    meta = np.stack([pose_off, edge_off, np.append(sizes, 0), row_off], axis=1)
    return Windows(
        n=n, num_edges=int(src.size),
        num_poses=np.asarray(sizes, np.int64),
        pose_off=pose_off, edge_off=edge_off,
        poses=i32(np.concatenate(poses)), edges=i32(np.concatenate(edges)),
        src=i32(np.concatenate(lsrc)), dst=i32(np.concatenate(ldst)),
        pull=i32(pull), offsets=i32(bounds),
        rows=rows, row_robots=i32(np.concatenate([list(r) for r in rows])),
        meta=i32(meta), cluster=nc, part=i32(part),
        slice_max=int(np.diff(part, axis=1).max()),
    )


def prepare_mask_window(problem, mask) -> Windows:
    """The window of a mask's block, for callers that hold a mask and no
    robot rows (the roofline's all-ones mask, the kernel checks): the
    one-row case of :func:`prepare_row_windows`. ``mask`` (n,) or (n, 1,
    1), a tensor or an array, must be 0/1 with its support a union of
    robots' blocks (the blocks K1 solves), else ValueError."""
    m = np.asarray(torch.as_tensor(mask).detach().cpu().double()).reshape(-1)
    if m.shape != (problem.n,) or not np.isin(m, (0.0, 1.0)).all():
        raise ValueError("prepare_mask_window: the mask must be 0/1 over the poses")
    bounds = np.concatenate([problem.offsets, [problem.n]]).astype(np.int64)
    csum = np.concatenate([[0.0], np.cumsum(m)])
    sums = csum[bounds[1:]] - csum[bounds[:-1]]
    sizes = np.diff(bounds)
    robots = np.flatnonzero(sums > 0)
    if robots.size == 0 or not np.array_equal(sums[robots], sizes[robots]):
        raise ValueError(
            "prepare_mask_window: the mask's support is not a union of robots' blocks")
    return prepare_row_windows(problem, [robots])


@profiling.spanned("k4.launch")
def rtr_solve_hbm(
    X: torch.Tensor,
    robot: int,
    Pinv: torch.Tensor,
    edges: EdgeSet,
    params: RTRParams,
    windows: Windows,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One RTR solve of robot ``robot``'s block on its window.

    X (n, r, d+1), Pinv (n, d+1, d+1) the damped block-Jacobi inverse,
    ``edges`` the world's edges with their current weights, ``windows``
    from :func:`prepare_windows` of the same problem. Returns (X_new,
    stats) as the module docstring says. The operand checks run on both
    devices; the float32 requirement only where the kernel runs.

    Each row keeps a launch record (:class:`_Record`, in
    ``windows.records``) built on its first call. The checks run in full
    on that call and again whenever what they read has changed
    (``kernels.guard``, one tuple compare).
    """
    guard, held = kernels.guard((X,), kernels.solve_operands(Pinv, edges, windows.offsets),
                                params)
    rec = windows.records.get(robot) if type(robot) is int else None
    fresh = rec is None or guard is None or rec.guard != guard
    if fresh:
        kernels.checked_operands("rtr_solve_hbm", X, Pinv, edges, windows.offsets,
                                 torch.float32 if X.device.type == "cuda" else X.dtype,
                                 params)
        windows.check("rtr_solve_hbm", X, edges)
        robot = kernels.row_index("rtr_solve_hbm", robot, windows.num_rows, "robot")
        rec = windows.records.get(robot)
        if rec is None or rec.shape != X.shape[1:]:
            rec = windows.records[robot] = _Record(windows, robot, X)
        rec.guard, rec.held = guard, held
    if rec.card is None:
        return rtr_solve_hbm_ref(X, robot, Pinv, edges, params, windows)
    return rec.launch(X, Pinv, edges, params, windows, fresh)


# K4's C entries (csrc/rtr_window.cu), as kernels.load declares them
ENTRIES = {
    "dpgo_rtr_window_record_bytes": ([], c_longlong),
    "dpgo_rtr_window_record": ([c_void_p] + [c_int] * 9 + [c_void_p] * 6, c_int),
    "dpgo_rtr_window_bind": ([c_void_p] * 6 + [c_int] * 2 + [c_float] * 5, None),
    "dpgo_rtr_window_launch": ([c_void_p] * 6, c_int),
    "dpgo_rtr_window_workspace_floats": ([c_int] * 6, c_longlong),
    "dpgo_rtr_window_smem_bytes": ([c_int] * 3, c_longlong),
}


class _Record:
    """The launch of one window row for X of one (r, d+1), built once; on
    the card it holds the row's table views (their pointers are in the
    kernel's record), the workspace size and the kernel's record
    (``csrc/rtr_window.cu``: sizes, tables, kernel and card, the cluster's
    fit checked once), to which :meth:`launch` binds the world's operands
    and the params when the checks have just run or κ_eff/τ_eff changed.
    ``guard``/``held``: what the checks last passed, and the tensors it
    names by id; ``kw``: the bound (κ_eff, τ_eff)."""

    __slots__ = ("shape", "card", "views", "lib", "buf", "addr", "ws", "kw",
                 "guard", "held")

    def __init__(self, windows: Windows, row: int, X: torch.Tensor):
        profiling.count("k4.records")
        self.shape = X.shape[1:]
        self.card = X.device.index if X.device.type == "cuda" else None
        self.guard = self.held = None
        self.kw = (None, None)
        if self.card is None:
            return
        r, dp1 = self.shape
        d = dp1 - 1
        self.views = poses, eids, _, _, pull, _ = (*windows.window(row), windows.part[row])
        nc, P = windows.cluster, windows.slice_max
        self.lib = lib = kernels.load(kernels.WINDOW_SOURCE, ENTRIES)
        self.ws = lib.dpgo_rtr_window_workspace_floats(
            d, r, windows.max_poses, windows.max_edges, nc, P)
        self.buf = ctypes.create_string_buffer(lib.dpgo_rtr_window_record_bytes())
        self.addr = ctypes.addressof(self.buf)
        rc = lib.dpgo_rtr_window_record(
            self.addr, self.card, d, r, int(poses.shape[0]), int(eids.shape[0]),
            int(windows.num_poses[row]), int(pull.shape[1]), nc, P,
            *(t.data_ptr() for t in self.views))
        kernels.check_launch("rtr_window_solve", rc, nc)

    def launch(self, X, Pinv, edges, params, windows, bind):
        kw, tw = windows.effective_weights(edges)
        if bind or kw is not self.kw[0]:
            self.kw = kw, tw
            self.lib.dpgo_rtr_window_bind(
                self.addr, Pinv.data_ptr(), edges.R.data_ptr(), edges.t.data_ptr(),
                kw.data_ptr(), tw.data_ptr(),
                int(params.max_iterations), int(params.max_tcg_iterations),
                float(params.gradnorm_tol), float(params.initial_radius),
                float(params.max_radius), float(params.tcg_kappa),
                float(params.tcg_theta))
        X_out = X.clone()
        stats = torch.empty(STATS_LEN, dtype=torch.float32, device=X.device)
        work = torch.empty(self.ws, dtype=torch.float32, device=X.device)
        rc = self.lib.dpgo_rtr_window_launch(
            self.addr, X.data_ptr(), X_out.data_ptr(), stats.data_ptr(),
            work.data_ptr(), kernels.stream(self.card))
        kernels.check_launch("rtr_window_solve", rc)
        profiling.count("k4.launches")  # the CUDA kernel's (not the plain version's)
        return X_out, stats


def window_edges(edges: EdgeSet, windows: Windows, row: int) -> EdgeSet:
    """Row ``row``'s local ``EdgeSet``: its edges' data gathered through
    their global ids, with the local endpoints and pull index."""
    _, eids, lsrc, ldst, pull = windows.window(row)
    el = eids.long()
    return EdgeSet(
        src=lsrc.long(), dst=ldst.long(), R=edges.R[el], t=edges.t[el],
        kappa=edges.kappa[el], tau=edges.tau[el], weight=edges.weight[el],
        mask=edges.mask[el], is_loop=edges.is_loop[el], pull=pull,
    )


def _solve_window(X, row, Pinv, edges, params, windows):
    """``rtr_solve`` on row ``row``'s gathered window under its block mask,
    the block scattered back into a copy of X. Returns (X_out, result,
    the block's squared displacement per pose)."""
    nb = int(windows.num_poses[row])
    pl = windows.window(row)[0].long()
    local = window_edges(edges, windows, row)
    Xw = X[pl]
    m = torch.zeros((pl.shape[0], 1, 1), dtype=X.dtype, device=X.device)
    m[:nb] = 1.0
    Xw_new, res = rtr_solve(Xw, local, m, Pinv[pl], params)
    X_out = X.clone()
    X_out[pl[:nb]] = Xw_new[:nb]
    return X_out, res, ((Xw_new[:nb] - Xw[:nb]) ** 2).sum(dim=(-2, -1))


def stats_head(res, dtype, device) -> torch.Tensor:
    """The stats vector's head ``[f0, f, gn0, gn, TR iterations, tCG
    iterations]`` of an ``rtr_solve`` result, in ``dtype``."""
    count = lambda v: torch.tensor(float(v), dtype=dtype, device=device)
    return torch.stack([res.f_init, res.f_opt, res.gradnorm_init, res.gradnorm_opt,
                        count(res.iterations), count(res.tcg_iterations)])


def rtr_solve_hbm_ref(
    X: torch.Tensor,
    robot: int,
    Pinv: torch.Tensor,
    edges: EdgeSet,
    params: RTRParams,
    windows: Windows,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4: gather the window's ``EdgeSet``, run
    ``rtr_solve`` on it under the block mask, scatter the block back; the
    same stats vector (in X's dtype). Runs on any device."""
    X_out, res, d2 = _solve_window(X, robot, Pinv, edges, params, windows)
    return X_out, torch.cat([stats_head(res, X.dtype, X.device), torch.sqrt(d2.sum())[None]])


def rtr_solve_window_ref(
    X: torch.Tensor,
    row: int,
    Pinv: torch.Tensor,
    edges: EdgeSet,
    params: RTRParams,
    windows: Windows,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of what K1 computes on row ``row``'s window:
    the solve of :func:`rtr_solve_hbm_ref`, f0 and f raised by the cost of
    the world's edges with no endpoint in the block (a constant of the
    solve) to the world's cost, and K1's stats vector (``fused_rtr``'s
    layout over the windows' robots: moved over each row robot's block,
    updated 1 for the row's robots). Runs on any device."""
    X_out, res, d2 = _solve_window(X, row, Pinv, edges, params, windows)
    outside = torch.ones_like(edges.mask)
    outside[windows.window(row)[1].long()] = 0.0
    f_out = quadratic.cost(X, dataclasses.replace(edges, mask=edges.mask * outside))
    head = stats_head(res, X.dtype, X.device)
    head[:2] += f_out
    R = windows.num_robots
    bounds = windows.offsets.tolist()
    moved = torch.zeros(R, dtype=X.dtype, device=X.device)
    upd = torch.zeros(R, dtype=X.dtype, device=X.device)
    lb = 0
    for k in windows.rows[row]:
        nk = bounds[k + 1] - bounds[k]
        moved[k] = torch.sqrt(d2[lb:lb + nk].sum())
        upd[k] = 1.0
        lb += nk
    return X_out, torch.cat([head, moved, upd])
