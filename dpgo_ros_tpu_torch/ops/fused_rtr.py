"""The RTR block solve (K1) and the multi-step runner (K2) as hand-written
CUDA kernels.

K1 ports ``dpgo_ros_tpu/ops/fused_rtr.py::rtr_solve_fused`` (the Pallas
kernel built by ``_make_rtr_kernel``): one masked RTR block solve per
launch. The mask is a 0/1 union of robots' blocks, and the kernel solves
the window of that block (``ops/hbm_rtr.py``: ``prepare_row_windows`` for
robot or colour rows, ``prepare_mask_window`` for a mask) on a
thread-block cluster, adding the cost of the world's edges outside the
window so that f0 and f stay the world's (``csrc/rtr_block.cu``). K2
ports ``rtr_run_fused`` (``_make_rtr_multistep_kernel``): many solver
steps per launch, with the update schedule, the per-robot relative change,
termination and the GNC weight-round exit inside the kernel; each step
solves on its bank row's window (``csrc/rtr_run.cu``). Every solver kernel
(K1–K4) runs the cluster solve of ``csrc/rtr_cluster.cuh``. The sources
say what bounds them and how they are laid out; ``ops/kernels.py`` builds
and loads them.

:func:`rtr_solve_fused` and :func:`rtr_run_fused` launch their kernel for
CUDA tensors and raise if it cannot be built or launched, or if they are
given no windows; for CPU tensors they run the plain versions
:func:`rtr_solve_fused_ref` and :func:`rtr_run_fused_ref`, built on the
ported ``rtr_solve``, full-width (the same function). No path falls back
from one to the other. Given windows, each reruns its operand checks only
when what they read has changed (``kernels.guard``).

K1 stats vector (float32, length 6 + 2·R for R robots):
``[f0, f, gn0, gn, TR iterations, tCG iterations,
moved_0..moved_{R-1}, updated_0..updated_{R-1}]`` where f0 and f are the
world's cost, moved is the robot's masked block displacement
‖(X_new − X)·mask‖_F and updated is the largest mask value over its block.

K2 stats vector (length 4): ``[cost, iteration, steps taken in this
launch, tCG iterations of this launch]``.
"""

from __future__ import annotations

from ctypes import c_float, c_int, c_longlong, c_void_p
from typing import Optional, Tuple

import torch

from dpgo_ros_tpu_torch.models.local_solvers import (
    RGDParams,
    RTRParams,
    rgd_step,
    rtr_solve,
)
from dpgo_ros_tpu_torch.ops import hbm_rtr, kernels, quadratic
from dpgo_ros_tpu_torch.ops.quadratic import EdgeSet
from dpgo_ros_tpu_torch.utils import profiling

S_F0, S_F, S_GN0, S_GN, S_ITERS, S_TCG = range(6)
S_MOVED = 6  # [6 : 6+R] per-robot displacement; [6+R : 6+2R] updated flag
RUN_COST, RUN_ITER, RUN_STEPS, RUN_TCG = range(4)

# read by the benchmark's set-up (benchmark/harness.py, benchmark/runners/),
# which names the kernels it builds by these constants of this module
build_all = kernels.build_all
SOURCE = kernels.BLOCK_SOURCE
RUN_SOURCE = kernels.RUN_SOURCE
TICK_SOURCE = kernels.TICK_SOURCE
WINDOW_SOURCE = kernels.WINDOW_SOURCE
PEAK_SOURCE = kernels.PEAK_SOURCE
EXTRAP_SOURCE = kernels.EXTRAP_SOURCE


# the C entries of K1 (csrc/rtr_block.cu) and K2 (csrc/rtr_run.cu), as
# kernels.load declares them
BLOCK_ENTRIES = {
    "dpgo_rtr_block_solve": (
        [c_int] * 11 + [c_void_p] * 19 + [c_int] * 2 + [c_float] * 5 + [c_void_p], c_int),
    "dpgo_rtr_block_workspace_floats": ([c_int] * 6, c_longlong),
}
RUN_ENTRIES = {
    "dpgo_rtr_run": ([c_int] * 10 + [c_void_p] * 23 + [c_int] * 6 + [c_float] * 3
                     + [c_int] * 3 + [c_float] * 5 + [c_void_p], c_int),
    "dpgo_rtr_run_workspace_floats": ([c_int] * 7, c_longlong),
}


def rtr_solve_fused(
    X: torch.Tensor,
    mask: torch.Tensor,
    Pinv: torch.Tensor,
    edges: EdgeSet,
    params: RTRParams,
    offsets: Optional[torch.Tensor] = None,
    *,
    windows=None,
    row: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One masked RTR block solve.

    X (n, r, d+1), mask (n, 1, 1) or (n,), Pinv (n, d+1, d+1) the damped
    block-Jacobi inverse, ``offsets`` (R+1,) int32 robot block bounds for
    the per-robot stats (default: the windows' robots, else one robot).
    ``windows`` (``hbm_rtr.prepare_row_windows`` / ``prepare_mask_window``
    of the same problem) and ``row``: the kernel solves row ``row``'s
    window, so on the card both are required and the mask must be 0/1
    with its support the row's block (checked with one host read, on
    either device when given). Returns (X_new, stats): the kernel writes
    the block into a copy of X, the plain version returns every pose of its
    full-width solve; the block's poses agree.

    The kernel's operand checks (shapes, devices, layouts) run on both
    devices; the float32 requirement only where the kernel runs. Given
    windows and an int row, they rerun only when what they read has
    changed (``kernels.guard``: the mask row by the tensor it views).
    """
    on_card = X.device.type == "cuda"
    n = X.shape[0]
    m = mask.reshape(n).contiguous()
    if offsets is None:
        offsets = (windows.offsets if windows is not None
                   else torch.tensor([0, n], dtype=torch.int32, device=X.device))
    kept = windows.records.get(("k1", row)) if (
        windows is not None and type(row) is int) else None
    key, held = kernels.guard((X,), kernels.solve_operands(Pinv, edges, offsets),
                              params, rows=(m,))
    if not kernels.hit(kept, key):
        kernels.checked_operands("rtr_solve_fused", X, Pinv, edges, offsets,
                                 torch.float32 if on_card else X.dtype, params, mask=m)
        if on_card or windows is not None:
            row = _check_window(X, m, edges, offsets, windows, row)
            windows.records[("k1", row)] = key, held
    if not on_card:
        return rtr_solve_fused_ref(X, m, Pinv, edges, params, offsets)
    return _launch(X, Pinv, edges, params, windows, row)


def _check_window(X, m, edges, offsets, windows, row) -> int:
    """Raise unless ``windows`` holds row ``row`` of this world on X's
    device, the mask is 0/1 with its support exactly that row's block and
    ``offsets`` are the windows' robots (one host read); returns the row."""
    who = "rtr_solve_fused"
    if windows is None or row is None:
        raise ValueError(
            f"{who}: the kernel solves a window: pass windows= and row= "
            "(hbm_rtr.prepare_row_windows or prepare_mask_window)")
    row = kernels.row_index(who, row, windows.num_rows)
    windows.check(who, X, edges)
    if offsets.shape != windows.offsets.shape:
        raise ValueError(
            f"{who}: offsets for {offsets.shape[0] - 1} robots, the windows' "
            f"world has {windows.num_robots}")
    nb, a = int(windows.num_poses[row]), int(windows.pose_off[row])
    block = windows.poses[a:a + nb].long()
    inside, off_block, not01, other_offsets = torch.stack([
        (m > 0).sum(), (m[block] != 1).sum(), ((m != 0) & (m != 1)).sum(),
        (offsets != windows.offsets).sum(),
    ]).tolist()
    if not01:
        raise ValueError(f"{who}: the kernel takes 0/1 masks only")
    if inside != nb or off_block:
        raise ValueError(f"{who}: the mask's support is not row {row}'s block")
    if other_offsets:
        raise ValueError(f"{who}: offsets are not the windows' robot bounds")
    return row


def _launch(X, Pinv, edges, params, windows, row):
    _, r, dp1 = X.shape
    d = dp1 - 1
    R = windows.num_robots
    poses, eids, lsrc, ldst, pull = windows.window(row)
    robots = windows.robots_of(row)
    nc, P = windows.cluster, windows.slice_max
    kw, tw = windows.effective_weights(edges)
    lib = kernels.load(kernels.BLOCK_SOURCE, BLOCK_ENTRIES)
    ws = lib.dpgo_rtr_block_workspace_floats(
        d, r, windows.max_poses, windows.max_edges, nc, P)
    X_out = X.clone()  # the kernel writes the block
    stats = torch.empty(6 + 2 * R, dtype=torch.float32, device=X.device)
    work = torch.empty(ws, dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):  # launch on X's card, in its stream
        rc = lib.dpgo_rtr_block_solve(
            d, r, int(poses.shape[0]), int(eids.shape[0]), int(windows.num_poses[row]),
            int(pull.shape[1]), nc, P, edges.num_edges, int(robots.shape[0]), R,
            *(t.data_ptr() for t in (
                X, Pinv, edges.R, edges.t, kw, tw, edges.src, edges.dst, poses, eids,
                lsrc, ldst, pull, windows.part[row], windows.offsets, robots,
                X_out, stats, work)),
            int(params.max_iterations), int(params.max_tcg_iterations),
            float(params.gradnorm_tol), float(params.initial_radius),
            float(params.max_radius), float(params.tcg_kappa),
            float(params.tcg_theta), kernels.stream(X.device.index),
        )
    kernels.check_launch("rtr_block_solve", rc, nc)
    profiling.count("k1.launches")  # the CUDA kernel's (not the plain version's)
    return X_out, stats


def _moved_updated(X, Xf, m, bounds) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-robot masked displacement ‖(Xf − X)·m‖_F and largest mask value
    over each robot's block (``bounds`` = R+1 block bounds)."""
    D2 = (((Xf - X) * m[:, None, None]) ** 2).sum(dim=(-2, -1))
    pairs = list(zip(bounds[:-1], bounds[1:]))
    return (torch.stack([torch.sqrt(D2[a:b].sum()) for a, b in pairs]),
            torch.stack([m[a:b].max() for a, b in pairs]))


def rtr_solve_fused_ref(
    X: torch.Tensor,
    mask: torch.Tensor,
    Pinv: torch.Tensor,
    edges: EdgeSet,
    params: RTRParams,
    offsets: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: ``rtr_solve`` plus the same stats
    vector (in X's dtype). Runs on any device."""
    n = X.shape[0]
    m3 = mask.reshape(n, 1, 1)
    X_new, res = rtr_solve(X, edges, m3, Pinv, params)
    bounds = [0, n] if offsets is None else [int(o) for o in offsets.tolist()]
    moved, upd = _moved_updated(X, X_new, m3.reshape(n), bounds)
    return X_new, torch.cat([hbm_rtr.stats_head(res, X.dtype, X.device), moved, upd])


# ---------------------------------------------------------------- K2


def rtr_run_fused(
    X: torch.Tensor,
    mask_bank: torch.Tensor,
    sched: torch.Tensor,
    Pinv: torch.Tensor,
    edges: EdgeSet,
    params: RTRParams,
    *,
    adj: torch.Tensor,
    rel0: torch.Tensor,
    it0: int,
    last_wu: int,
    gnc_pending: bool,
    cost0,
    it_cap: int,
    tol: float,
    gnc: bool,
    inner: int,
    inner_tol: Optional[float],
    record: bool = False,
    rgd_stepsize: float = 0.0,
    rgd_cost: bool = False,
    offsets: Optional[torch.Tensor] = None,
    windows,
):
    """Up to ``it_cap − it0`` solver steps in one launch (K2).

    Step ``it`` solves the block ``mask_bank[sched[it]]`` (one masked RTR
    solve, or one preconditioned RGD step when ``rgd_stepsize > 0``; an
    RGD step keeps the carried cost, as the JAX package's kernel does,
    unless ``rgd_cost``: then the kernel moves it by the window's f − f0
    and the plain version takes the full-width cost after the step),
    restores the unmasked poses exactly, and updates the per-robot
    relative change: ``rel = updated ? moved : max(rel, (moved·updated) @
    adj)``. After each step, at ``it2 = it + 1``, the run stops when every
    robot's rel change is below ``tol`` and no GNC round is pending, at
    ``it_cap``, or when a GNC round must fire (``gnc_pending`` and
    ``inner_tol is not None ? max rel < inner_tol or it2 − last_wu ≥ inner
    : it2 % inner == 0``). An input that has already terminated runs zero
    steps.

    X (n, r, d+1); mask_bank (m, n); sched (it_cap,) int32 bank rows;
    Pinv (n, d+1, d+1); adj (R, R) robot adjacency; rel0 (R,); cost0 the
    cost of X; ``offsets`` (R+1,) int32 robot block bounds; ``windows``
    (``hbm_rtr.prepare_row_windows``) one window per bank row, whose
    block is the row's mask, always checked: the kernel solves each step
    on its row's window; the plain version solves full-width (the same
    function).

    Returns (X, rel (R,), stats (4,)[, rel_hist (it_cap, R)]) — stats
    ``[cost, iteration, steps taken, tCG iterations]``; rel_hist rows are
    written at the absolute iteration and the others stay NaN. The
    kernel's cost is ``cost0`` moved by each step's window f − f0, the
    plain version's the last solve's full-width f: the same value up to
    fp32 rounding.
    """
    on_card = X.device.type == "cuda"
    fdt = torch.float32 if on_card else X.dtype
    if offsets is None:
        offsets = torch.tensor([0, X.shape[0]], dtype=torch.int32, device=X.device)
    slot = ("k2", sched.storage_offset())
    key, held = kernels.guard(
        (X, rel0), (*kernels.solve_operands(Pinv, edges, offsets), mask_bank, adj),
        params, int(it0), int(it_cap), bool(gnc), int(inner), rows=(sched,))
    if not kernels.hit(windows.records.get(slot), key):
        _check_run(X, mask_bank, sched, Pinv, edges, params, adj, rel0, offsets,
                   it0, it_cap, gnc, inner, windows, fdt)
        windows.records[slot] = key, held
    cost0 = torch.as_tensor(cost0, dtype=fdt, device=X.device).reshape(1)
    run = dict(it0=int(it0), last_wu=int(last_wu), gnc_pending=bool(gnc_pending),
               it_cap=int(it_cap), tol=float(tol), gnc=bool(gnc),
               inner=int(inner), inner_tol=inner_tol, record=bool(record),
               rgd_stepsize=float(rgd_stepsize), rgd_cost=bool(rgd_cost))
    if not on_card:
        return rtr_run_fused_ref(
            X, mask_bank, sched, Pinv, edges, params, adj=adj, rel0=rel0,
            cost0=cost0, offsets=offsets, **run,
        )
    return _launch_run(X, mask_bank, sched, Pinv, edges, params, adj, rel0,
                       cost0, offsets, run, windows)


def _check_run(X, bank, sched, Pinv, edges, params, adj, rel0, offsets, it0, it_cap,
               gnc, inner, windows, fdt) -> None:
    """Raise on operands K2 cannot take: the cluster solve's, the bank, the
    schedule (every entry of ``sched[it0:it_cap]`` a bank row: one host
    read), the robots' adjacency and rel change, and ``windows`` with one
    window per bank row, of this world, on X's device, each block the size
    of its row's mask (one host read)."""
    who = "rtr_run_fused"
    kernels.checked_operands(who, X, Pinv, edges, offsets, fdt, params, mask_bank=bank,
                             sched=sched, adj=adj, rel0=rel0)
    n, R = X.shape[0], offsets.shape[0] - 1
    if bank.dim() != 2 or bank.shape[1] != n:
        raise ValueError(f"{who}: mask_bank shape {tuple(bank.shape)}")
    if sched.dim() != 1 or sched.shape[0] < it_cap:
        raise ValueError(f"{who}: sched shape {tuple(sched.shape)} for it_cap {it_cap}")
    if adj.shape != (R, R) or rel0.shape != (R,):
        raise ValueError(
            f"{who}: adj {tuple(adj.shape)} / rel0 {tuple(rel0.shape)} for {R} robots")
    if gnc and inner < 1:
        raise ValueError(f"{who}: inner={inner} (must be >= 1)")
    if windows.num_rows != bank.shape[0]:
        raise ValueError(
            f"{who}: {windows.num_rows} windows for {bank.shape[0]} bank rows")
    windows.check(who, X, edges)
    if (bank > 0).sum(1).tolist() != windows.num_poses.tolist():
        raise ValueError(f"{who}: the windows' blocks are not the bank rows")
    live = sched[it0:it_cap] if it0 < it_cap else sched[:0]
    if live.numel():
        lo, hi = torch.stack([live.min(), live.max()]).tolist()
        if lo < 0 or hi >= bank.shape[0]:
            raise ValueError(f"{who}: a sched entry is outside the mask bank")


def _launch_run(X, bank, sched, Pinv, edges, params, adj, rel0, cost0,
                offsets, run, windows):
    _, r, dp1 = X.shape
    d = dp1 - 1
    R = offsets.shape[0] - 1
    it_cap = run["it_cap"]
    nc, P = windows.cluster, windows.slice_max
    kw, tw = windows.effective_weights(edges)
    lib = kernels.load(kernels.RUN_SOURCE, RUN_ENTRIES)
    ws = lib.dpgo_rtr_run_workspace_floats(
        d, r, windows.max_poses, windows.max_edges, R, nc, P)
    X_out = X.clone()  # the kernel steps it in place
    rel = torch.empty_like(rel0)
    stats = torch.empty(4, dtype=torch.float32, device=X.device)
    rel_hist = (
        torch.full((it_cap, R), float("nan"), dtype=torch.float32, device=X.device)
        if run["record"] else None
    )
    work = torch.empty(ws, dtype=torch.float32, device=X.device)
    inner_tol = run["inner_tol"]
    with torch.cuda.device(X.device):  # launch on X's card, in its stream
        rc = lib.dpgo_rtr_run(
            d, r, int(windows.pull.shape[1]), R, int(bank.shape[0]), it_cap, nc, P,
            windows.max_poses, windows.max_edges,
            *(t.data_ptr() if t is not None else None for t in (
                X_out, sched, Pinv, edges.R, edges.t, kw, tw, offsets, windows.meta,
                windows.poses, windows.edges, windows.src, windows.dst, windows.pull,
                windows.part, windows.row_robots, adj, rel0, cost0, rel, stats,
                rel_hist, work)),
            run["it0"], run["last_wu"], int(run["gnc_pending"]), int(run["gnc"]),
            run["inner"], int(inner_tol is not None),
            float(inner_tol if inner_tol is not None else 0.0), run["tol"],
            run["rgd_stepsize"], int(run["rgd_cost"]),
            int(params.max_iterations), int(params.max_tcg_iterations),
            float(params.gradnorm_tol), float(params.initial_radius),
            float(params.max_radius), float(params.tcg_kappa),
            float(params.tcg_theta), kernels.stream(X.device.index),
        )
    kernels.check_launch("rtr_run", rc, nc)
    profiling.count("k2.launches")  # the CUDA kernel's (not the plain version's)
    out = (X_out, rel, stats)
    return out + (rel_hist,) if run["record"] else out


def _run_stops(maxrel: float, it2: int, run) -> bool:
    """K2's exit test after a step (or on entry, as termination only)."""
    ready = maxrel < run["tol"]
    if not run["gnc"]:
        return ready
    pending = run["gnc_pending"]
    if run["inner_tol"] is not None:
        fire = maxrel < run["inner_tol"] or it2 - run["last_wu"] >= run["inner"]
    else:
        fire = it2 % run["inner"] == 0
    return (ready and not pending) or (fire and pending)


def rtr_run_fused_ref(
    X, mask_bank, sched, Pinv, edges, params, *, adj, rel0, cost0, offsets,
    it0, last_wu, gnc_pending, it_cap, tol, gnc, inner, inner_tol, record,
    rgd_stepsize, rgd_cost=False,
):
    """Plain PyTorch version of K2: a Python loop over steps on the ported
    ``rtr_solve`` (or ``local_solvers.rgd_step``), with K2's step semantics; the exit
    tests are read on the host. Runs on any device."""
    run = dict(it0=it0, last_wu=last_wu, gnc_pending=gnc_pending, tol=tol,
               gnc=gnc, inner=inner, inner_tol=inner_tol)
    bounds = [int(o) for o in offsets.tolist()]
    sched_h = sched.tolist()
    rel = rel0.clone()
    cost = cost0.reshape(()).clone()
    R = rel.shape[0]
    rel_hist = (
        torch.full((it_cap, R), float("nan"), dtype=X.dtype, device=X.device)
        if record else None
    )
    it, tcg = it0, 0
    stop = float(rel.max()) < tol and not (gnc and gnc_pending)
    while not stop and it < it_cap:
        m = mask_bank[sched_h[it]]
        if rgd_stepsize > 0:
            Xf = rgd_step(X, edges, m.reshape(-1, 1, 1), Pinv,
                          RGDParams(stepsize=rgd_stepsize))
            k = 1
        else:
            Xf, res = rtr_solve(X, edges, m.reshape(-1, 1, 1), Pinv, params)
            cost, k = res.f_opt, res.tcg_iterations
        moved, upd = _moved_updated(X, Xf, m, bounds)
        X = torch.where(m[:, None, None] > 0, Xf, X)
        if rgd_stepsize > 0 and rgd_cost:
            cost = quadratic.cost(X, edges)
        rel = torch.where(upd > 0, moved, torch.maximum(rel, (moved * upd) @ adj))
        if record:
            rel_hist[it] = rel
        it += 1
        tcg += k
        stop = _run_stops(float(rel.max()), it, run)
    stats = torch.tensor([0.0, it, it - it0, tcg], dtype=X.dtype, device=X.device)
    stats[RUN_COST] = cost
    out = (X, rel, stats)
    return out + (rel_hist,) if record else out
