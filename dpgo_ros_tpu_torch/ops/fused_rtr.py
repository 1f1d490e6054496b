"""The RTR block solve (K1) and the multi-step runner (K2) as hand-written
CUDA kernels, and the build of every kernel of the package (K3's wrapper is
``ops/fused_asapp.py``, K4's ``ops/hbm_rtr.py``, K5's and K6's
``ops/peak_chains.py``, K7's ``ops/nesterov.py``).

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
say what bounds them and how they are laid out. Each is compiled with nvcc
at first use, from the checkout's sources, into ``build/dpgo_ros_tpu_torch/``
(keyed by a hash of the source, the shared header and the flags), and
bound through a plain C interface with ctypes.

:func:`rtr_solve_fused` and :func:`rtr_run_fused` launch their kernel for
CUDA tensors and raise if it cannot be built or launched, or if they are
given no windows; for CPU tensors they run the plain versions
:func:`rtr_solve_fused_ref` and :func:`rtr_run_fused_ref`, built on the
ported ``rtr_solve``, full-width (the same function). No path falls back
from one to the other.

K1 stats vector (float32, length 6 + 2·R for R robots):
``[f0, f, gn0, gn, TR iterations, tCG iterations,
moved_0..moved_{R-1}, updated_0..updated_{R-1}]`` where f0 and f are the
world's cost, moved is the robot's masked block displacement
‖(X_new − X)·mask‖_F and updated is the largest mask value over its block.

K2 stats vector (length 4): ``[cost, iteration, steps taken in this
launch, tCG iterations of this launch]``.
"""

from __future__ import annotations

import ctypes
import hashlib
import operator
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from dpgo_ros_tpu_torch.models.local_solvers import (
    RGDParams,
    RTRParams,
    rgd_step,
    rtr_solve,
)
from dpgo_ros_tpu_torch.ops import quadratic
from dpgo_ros_tpu_torch.ops.quadratic import EdgeSet
from dpgo_ros_tpu_torch.utils import profiling

S_F0, S_F, S_GN0, S_GN, S_ITERS, S_TCG = range(6)
S_MOVED = 6  # [6 : 6+R] per-robot displacement; [6+R : 6+2R] updated flag
RUN_COST, RUN_ITER, RUN_STEPS, RUN_TCG = range(4)
MAX_RANK = 8

_PKG = Path(__file__).resolve().parent.parent
HEADER = _PKG / "csrc" / "rtr_cluster.cuh"  # the cluster solve of K1–K4
SOURCE = _PKG / "csrc" / "rtr_block.cu"  # K1
RUN_SOURCE = _PKG / "csrc" / "rtr_run.cu"  # K2
TICK_SOURCE = _PKG / "csrc" / "asapp_tick.cu"  # K3, wrapped in ops/fused_asapp.py
WINDOW_SOURCE = _PKG / "csrc" / "rtr_window.cu"  # K4, wrapped in ops/hbm_rtr.py
PEAK_SOURCE = _PKG / "csrc" / "peak_chains.cu"  # K5, K6, wrapped in ops/peak_chains.py
EXTRAP_SOURCE = _PKG / "csrc" / "nesterov_extrapolate.cu"  # K7, wrapped in ops/nesterov.py
ALL_SOURCES = (SOURCE, RUN_SOURCE, TICK_SOURCE, WINDOW_SOURCE, PEAK_SOURCE, EXTRAP_SOURCE)
BUILD_DIR = _PKG.parent / "build" / "dpgo_ros_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(source: Path) -> Path:
    """Library path for ``source``, keyed by a hash of every file it
    compiles (the source and the shared header) and the flags."""
    key = hashlib.sha256(
        source.read_bytes() + HEADER.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{key}.so"


def build_all(sources: Optional[List[Path]] = None) -> List[Tuple[Path, str]]:
    """Compile every kernel source whose library is missing, one nvcc per
    source, all started together. Returns (library path, ptxas report) per
    source; raises if any nvcc fails."""
    sources = list(sources) if sources is not None else list(ALL_SOURCES)
    libs = [_lib_path(src) for src in sources]
    procs = []
    for src, lib in zip(sources, libs):
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs.append((src, lib, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )))
    failed = []
    for src, lib, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {src}:\n{err}")
            continue
        lib.with_suffix(".log").write_text(err)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [
        (lib, lib.with_suffix(".log").read_text()
         if lib.with_suffix(".log").exists() else "")
        for lib in libs
    ]


def build(source: Optional[Path] = None) -> Tuple[Path, str]:
    """Compile one kernel source (default K1's) unless its library exists.
    Returns (library path, ptxas report)."""
    return build_all([source if source is not None else SOURCE])[0]


def _library(source: Path) -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is None:
        path, _ = build(source)
        lib = ctypes.CDLL(str(path))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if source == EXTRAP_SOURCE:
            lib.dpgo_nesterov_extrapolate.argtypes = [ci] * 4 + [vp] * 9
            lib.dpgo_nesterov_extrapolate.restype = ci
        elif source == PEAK_SOURCE:
            for fn in (lib.dpgo_peak_chain, lib.dpgo_peak_chain_cml):
                fn.argtypes = [vp, vp, ci, ci, vp]
                fn.restype = ci
        elif source == WINDOW_SOURCE:
            lib.dpgo_rtr_window_record_bytes.argtypes = []
            lib.dpgo_rtr_window_record_bytes.restype = ctypes.c_longlong
            lib.dpgo_rtr_window_record.argtypes = [vp] + [ci] * 9 + [vp] * 6
            lib.dpgo_rtr_window_record.restype = ci
            lib.dpgo_rtr_window_bind.argtypes = [vp] * 6 + [ci, ci] + [cf] * 5
            lib.dpgo_rtr_window_bind.restype = None
            lib.dpgo_rtr_window_launch.argtypes = [vp] * 6
            lib.dpgo_rtr_window_launch.restype = ci
            lib.dpgo_rtr_window_workspace_floats.argtypes = [ci] * 6
            lib.dpgo_rtr_window_workspace_floats.restype = ctypes.c_longlong
            lib.dpgo_rtr_window_smem_bytes.argtypes = [ci] * 3
            lib.dpgo_rtr_window_smem_bytes.restype = ctypes.c_longlong
        elif source == TICK_SOURCE:
            lib.dpgo_asapp_tick.argtypes = [ci] * 12 + [vp] * 17 + [cf] + [vp] * 4
            lib.dpgo_asapp_tick.restype = ci
            lib.dpgo_asapp_tick_workspace_floats.argtypes = [ci] * 7
            lib.dpgo_asapp_tick_workspace_floats.restype = ctypes.c_longlong
        elif source == RUN_SOURCE:
            lib.dpgo_rtr_run.argtypes = (
                [ci] * 10 + [vp] * 23 + [ci] * 6 + [cf] * 3
                + [ci] + [ci, ci] + [cf] * 5 + [vp]
            )
            lib.dpgo_rtr_run.restype = ci
            lib.dpgo_rtr_run_workspace_floats.argtypes = [ci] * 7
            lib.dpgo_rtr_run_workspace_floats.restype = ctypes.c_longlong
        else:
            lib.dpgo_rtr_block_solve.argtypes = (
                [ci] * 11 + [vp] * 19 + [ci, ci] + [cf] * 5 + [vp]
            )
            lib.dpgo_rtr_block_solve.restype = ci
            lib.dpgo_rtr_block_workspace_floats.argtypes = [ci] * 6
            lib.dpgo_rtr_block_workspace_floats.restype = ctypes.c_longlong
        _libs[source] = lib
    return lib


def check_launch(who: str, rc: int, cluster: int = 0) -> None:
    """Raise unless a launch function returned 0 (cudaSuccess); -1 means no
    cluster of ``cluster`` CTAs fits on the card."""
    if rc == -1:
        raise RuntimeError(
            f"{who}: no cluster of {cluster} CTAs fits on this card "
            "(cudaOccupancyMaxActiveClusters is 0)")
    if rc != 0:
        raise RuntimeError(f"{who} launch failed: cudaError {rc}")


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
    devices; the float32 requirement only where the kernel runs.
    """
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rtr_solve_fused: unsupported device {X.device}")
    on_card = X.device.type == "cuda"
    if offsets is None and windows is not None:
        offsets = windows.offsets
    m, kw, tw, offsets = _checked_operands(
        "rtr_solve_fused", X, mask, Pinv, edges, params, offsets,
        torch.float32 if on_card else X.dtype,
    )
    if on_card or windows is not None:
        row = _check_window(X, m, edges, offsets, windows, row)
    if not on_card:
        return rtr_solve_fused_ref(X, m, Pinv, edges, params, offsets)
    return _launch(X, Pinv, edges, params, kw, tw, windows, row)


def _check_window(X, m, edges, offsets, windows, row) -> int:
    """Raise unless ``windows`` holds row ``row`` of this world on X's
    device, the mask is 0/1 with its support exactly that row's block and
    ``offsets`` are the windows' robots (one host read); returns the row."""
    who = "rtr_solve_fused"
    if windows is None or row is None:
        raise ValueError(
            f"{who}: the kernel solves a window: pass windows= and row= "
            "(hbm_rtr.prepare_row_windows or prepare_mask_window)")
    if isinstance(row, bool):
        raise TypeError(f"{who}: row must be an integer")
    row = operator.index(row)
    if not 0 <= row < windows.num_rows:
        raise ValueError(f"{who}: row {row} outside 0..{windows.num_rows - 1}")
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


def _checked_operands(who, X, mask, Pinv, edges, params, offsets, float_dtype):
    """Raise on operands the kernels cannot take (K1 passes its mask, K2
    None); returns (flat mask or None, κ_eff, τ_eff, offsets)."""
    n, r, dp1 = X.shape
    if dp1 - 1 not in (2, 3):
        raise ValueError(f"{who}: d={dp1 - 1} (kernel takes 2 or 3)")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"{who}: r={r} (kernel takes 1..{MAX_RANK})")
    if not params.use_preconditioner:
        raise ValueError(f"{who}: the kernel is preconditioned only")
    if Pinv.shape != (n, dp1, dp1):
        raise ValueError(f"{who}: Pinv shape {tuple(Pinv.shape)}")
    if edges.pull.dim() != 2 or edges.pull.shape[0] != n:
        raise ValueError(f"{who}: pull shape {tuple(edges.pull.shape)}")
    kw, tw = edges.effective_weights()
    if offsets is None:
        offsets = torch.tensor([0, n], dtype=torch.int32, device=X.device)
    m = mask.reshape(n).contiguous() if mask is not None else None
    tensors = {
        "X": X, "Pinv": Pinv, "src": edges.src, "dst": edges.dst,
        "R": edges.R, "t": edges.t, "kw": kw, "tw": tw, "pull": edges.pull,
        "offsets": offsets,
    }
    if m is not None:
        tensors["mask"] = m
    want = {"src": torch.int64, "dst": torch.int64, "pull": torch.int32,
            "offsets": torch.int32}
    for name, ten in tensors.items():
        if ten.device != X.device:
            raise ValueError(f"{who}: {name} on {ten.device}, X on {X.device}")
        if ten.dtype != want.get(name, float_dtype):
            raise TypeError(
                f"{who}: {name} is {ten.dtype}, expected "
                f"{want.get(name, float_dtype)}"
            )
        if not ten.is_contiguous():
            raise ValueError(f"{who}: {name} is not contiguous")
    return m, kw, tw, offsets


def _launch(X, Pinv, edges, params, kw, tw, windows, row):
    _, r, dp1 = X.shape
    d = dp1 - 1
    R = windows.num_robots
    poses, eids, lsrc, ldst, pull = windows.window(row)
    robots = windows.robots_of(row)
    nc, P = windows.cluster, windows.slice_max
    lib = _library(SOURCE)
    ws = lib.dpgo_rtr_block_workspace_floats(
        d, r, windows.max_poses, windows.max_edges, nc, P)
    X_out = X.clone()  # the kernel writes the block
    stats = torch.empty(6 + 2 * R, dtype=torch.float32, device=X.device)
    work = torch.empty(ws, dtype=torch.float32, device=X.device)
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(X.device):  # launch on X's card, in its stream
        rc = lib.dpgo_rtr_block_solve(
            d, r, int(poses.shape[0]), int(eids.shape[0]), int(windows.num_poses[row]),
            int(pull.shape[1]), nc, P, edges.num_edges, int(robots.shape[0]), R,
            p(X), p(Pinv), p(edges.R), p(edges.t), p(kw), p(tw),
            p(edges.src), p(edges.dst), p(poses), p(eids), p(lsrc), p(ldst), p(pull),
            p(windows.part[row]), p(windows.offsets), p(robots),
            p(X_out), p(stats), p(work),
            int(params.max_iterations), int(params.max_tcg_iterations),
            float(params.gradnorm_tol), float(params.initial_radius),
            float(params.max_radius), float(params.tcg_kappa),
            float(params.tcg_theta),
            ctypes.c_void_p(torch.cuda.current_stream(X.device).cuda_stream),
        )
    check_launch("rtr_block_solve", rc, nc)
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
    head = torch.stack([
        res.f_init, res.f_opt, res.gradnorm_init, res.gradnorm_opt,
        torch.tensor(float(res.iterations), dtype=X.dtype, device=X.device),
        torch.tensor(float(res.tcg_iterations), dtype=X.dtype, device=X.device),
    ])
    return X_new, torch.cat([head, moved, upd])


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
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rtr_run_fused: unsupported device {X.device}")
    on_card = X.device.type == "cuda"
    fdt = torch.float32 if on_card else X.dtype
    n = X.shape[0]
    _, kw, tw, offsets = _checked_operands(
        "rtr_run_fused", X, None, Pinv, edges, params, offsets, fdt,
    )
    R = offsets.shape[0] - 1
    if mask_bank.dim() != 2 or mask_bank.shape[1] != n:
        raise ValueError(f"rtr_run_fused: mask_bank shape {tuple(mask_bank.shape)}")
    if sched.dim() != 1 or sched.shape[0] < it_cap:
        raise ValueError(
            f"rtr_run_fused: sched shape {tuple(sched.shape)} for it_cap {it_cap}"
        )
    if adj.shape != (R, R) or rel0.shape != (R,):
        raise ValueError(
            f"rtr_run_fused: adj {tuple(adj.shape)} / rel0 {tuple(rel0.shape)} "
            f"for {R} robots"
        )
    if gnc and inner < 1:
        raise ValueError(f"rtr_run_fused: inner={inner} (must be >= 1)")
    want = {"mask_bank": (mask_bank, fdt), "sched": (sched, torch.int32),
            "adj": (adj, fdt), "rel0": (rel0, fdt)}
    for name, (ten, dt) in want.items():
        if ten.device != X.device:
            raise ValueError(f"rtr_run_fused: {name} on {ten.device}, X on {X.device}")
        if ten.dtype != dt:
            raise TypeError(f"rtr_run_fused: {name} is {ten.dtype}, expected {dt}")
        if not ten.is_contiguous():
            raise ValueError(f"rtr_run_fused: {name} is not contiguous")
    _check_row_windows(windows, mask_bank, X, edges)
    _check_sched(sched, it0, it_cap, mask_bank.shape[0])
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
                       cost0, offsets, kw, tw, run, windows)


# banks and schedules whose values were checked (by tensor identity, with
# the version counter an in-place write bumps, and what they were checked
# against), so that a caller launching K2 again on the same operands (the
# engine's one-step RGD updates) reads nothing back for the checks
_CHECKED = WeakIdKeyDictionary()


def _check_sched(sched, it0, it_cap, rows) -> None:
    """Raise unless every entry of ``sched[it0:it_cap]`` is a bank row (one
    host read, none for a schedule already checked at this range)."""
    key = (sched._version, int(it0), int(it_cap), int(rows))
    if _CHECKED.get(sched) == key:
        return
    live = sched[it0:it_cap] if it0 < it_cap else sched[:0]
    if live.numel():
        lo, hi = torch.stack([live.min(), live.max()]).tolist()
        if lo < 0 or hi >= rows:
            raise ValueError("rtr_run_fused: a sched entry is outside the mask bank")
    _CHECKED[sched] = key


def _check_row_windows(windows, bank, X, edges) -> None:
    """Raise unless ``windows`` has one window per bank row, of this world,
    on X's device, each block the size of its row's mask (one host read,
    none for a bank already checked against these windows)."""
    who = "rtr_run_fused"
    if windows.num_rows != bank.shape[0]:
        raise ValueError(
            f"{who}: {windows.num_rows} windows for {bank.shape[0]} bank rows")
    windows.check(who, X, edges)
    for name in ("poses", "edges", "src", "dst", "pull", "meta", "part", "row_robots"):
        ten = getattr(windows, name)
        if ten.device != X.device:
            raise ValueError(f"{who}: windows.{name} on {ten.device}, X on {X.device}")
        if ten.dtype != torch.int32 or not ten.is_contiguous():
            raise TypeError(f"{who}: windows.{name} must be contiguous int32")
    seen = _CHECKED.get(bank)
    if seen is not None and seen[0] == bank._version and seen[1] is windows:
        return
    if (bank > 0).sum(1).tolist() != windows.num_poses.tolist():
        raise ValueError(f"{who}: the windows' blocks are not the bank rows")
    _CHECKED[bank] = (bank._version, windows)


def _launch_run(X, bank, sched, Pinv, edges, params, adj, rel0, cost0,
                offsets, kw, tw, run, windows):
    _, r, dp1 = X.shape
    d = dp1 - 1
    R = offsets.shape[0] - 1
    it_cap = run["it_cap"]
    nc, P = windows.cluster, windows.slice_max
    lib = _library(RUN_SOURCE)
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
    p = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else None)
    inner_tol = run["inner_tol"]
    with torch.cuda.device(X.device):  # launch on X's card, in its stream
        rc = lib.dpgo_rtr_run(
            d, r, int(windows.pull.shape[1]), R, int(bank.shape[0]), it_cap, nc, P,
            windows.max_poses, windows.max_edges,
            p(X_out), p(sched), p(Pinv), p(edges.R), p(edges.t), p(kw), p(tw),
            p(offsets), p(windows.meta), p(windows.poses), p(windows.edges),
            p(windows.src), p(windows.dst), p(windows.pull), p(windows.part),
            p(windows.row_robots), p(adj), p(rel0), p(cost0),
            p(rel), p(stats), p(rel_hist), p(work),
            run["it0"], run["last_wu"], int(run["gnc_pending"]), int(run["gnc"]),
            run["inner"], int(inner_tol is not None),
            float(inner_tol if inner_tol is not None else 0.0), run["tol"],
            run["rgd_stepsize"], int(run["rgd_cost"]),
            int(params.max_iterations), int(params.max_tcg_iterations),
            float(params.gradnorm_tol), float(params.initial_radius),
            float(params.max_radius), float(params.tcg_kappa),
            float(params.tcg_theta),
            ctypes.c_void_p(torch.cuda.current_stream(X.device).cuda_stream),
        )
    check_launch("rtr_run", rc, nc)
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
