"""One RTR block solve as one hand-written CUDA kernel launch (K1).

Port of ``dpgo_ros_tpu/ops/fused_rtr.py::rtr_solve_fused`` (the Pallas
kernel built by ``_make_rtr_kernel``). The kernel source is
``csrc/rtr_block.cu``; its header says what bounds it and how it is laid
out. It is compiled with nvcc at first use, from the checkout's sources,
into ``build/dpgo_ros_tpu_torch/`` (keyed by a hash of source and flags),
and bound through a plain C interface with ctypes.

:func:`rtr_solve_fused` launches the kernel for CUDA tensors and raises if
it cannot be built or launched; for CPU tensors it runs the plain version
:func:`rtr_solve_fused_ref`, built on the ported ``rtr_solve``. No path
falls back from one to the other.

Stats vector (float32, length 6 + 2·R for R robots):
``[f0, f, gn0, gn, TR iterations, tCG iterations,
moved_0..moved_{R-1}, updated_0..updated_{R-1}]`` where moved is the
robot's masked block displacement ‖(X_new − X)·mask‖_F and updated is the
largest mask value over its block.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import torch

from dpgo_ros_tpu_torch.models.local_solvers import RTRParams, rtr_solve
from dpgo_ros_tpu_torch.ops.quadratic import EdgeSet

S_F0, S_F, S_GN0, S_GN, S_ITERS, S_TCG = range(6)
S_MOVED = 6  # [6 : 6+R] per-robot displacement; [6+R : 6+2R] updated flag
MAX_RANK = 8

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "rtr_block.cu"
BUILD_DIR = _PKG.parent / "build" / "dpgo_ros_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# launches of the CUDA kernel (not of the plain version)
LAUNCHES = 0

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA block-solve kernel cannot be built")


def build() -> Tuple[Path, str]:
    """Compile ``csrc/rtr_block.cu`` unless a library for this exact source
    and flag set exists. Returns (library path, ptxas report)."""
    key = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"rtr_block_{key}.so"
    log = lib.with_suffix(".log")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr}"
            )
        log.write_text(proc.stderr)
        os.replace(tmp, lib)
    return lib, log.read_text() if log.exists() else ""


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dpgo_rtr_block_solve.argtypes = (
            [ci] * 6 + [vp] * 14 + [ci, ci] + [cf] * 5 + [vp]
        )
        lib.dpgo_rtr_block_solve.restype = ci
        lib.dpgo_rtr_block_workspace_floats.argtypes = [ci] * 4
        lib.dpgo_rtr_block_workspace_floats.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def rtr_solve_fused(
    X: torch.Tensor,
    mask: torch.Tensor,
    Pinv: torch.Tensor,
    edges: EdgeSet,
    params: RTRParams,
    offsets: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One masked RTR block solve.

    X (n, r, d+1), mask (n, 1, 1) or (n,), Pinv (n, d+1, d+1) the damped
    block-Jacobi inverse, ``offsets`` (R+1,) int32 robot block bounds for
    the per-robot stats (default: one robot). Returns (X_new, stats).

    The kernel's operand checks (shapes, devices, layouts) run on both
    devices; the float32 requirement only where the kernel runs.
    """
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rtr_solve_fused: unsupported device {X.device}")
    on_card = X.device.type == "cuda"
    m, kw, tw, offsets = _checked_operands(
        X, mask, Pinv, edges, params, offsets,
        torch.float32 if on_card else X.dtype,
    )
    if not on_card:
        return rtr_solve_fused_ref(X, m, Pinv, edges, params, offsets)
    return _launch(X, m, Pinv, edges, params, offsets, kw, tw)


def _checked_operands(X, mask, Pinv, edges, params, offsets, float_dtype):
    n, r, dp1 = X.shape
    if dp1 - 1 not in (2, 3):
        raise ValueError(f"rtr_solve_fused: d={dp1 - 1} (kernel takes 2 or 3)")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rtr_solve_fused: r={r} (kernel takes 1..{MAX_RANK})")
    if not params.use_preconditioner:
        raise ValueError("rtr_solve_fused: the kernel is preconditioned only")
    if Pinv.shape != (n, dp1, dp1):
        raise ValueError(f"rtr_solve_fused: Pinv shape {tuple(Pinv.shape)}")
    if edges.pull.dim() != 2 or edges.pull.shape[0] != n:
        raise ValueError(f"rtr_solve_fused: pull shape {tuple(edges.pull.shape)}")
    kw, tw = edges.effective_weights()
    if offsets is None:
        offsets = torch.tensor([0, n], dtype=torch.int32, device=X.device)
    m = mask.reshape(n).contiguous()
    tensors = {
        "X": X, "mask": m, "Pinv": Pinv, "src": edges.src, "dst": edges.dst,
        "R": edges.R, "t": edges.t, "kw": kw, "tw": tw, "pull": edges.pull,
        "offsets": offsets,
    }
    want = {"src": torch.int64, "dst": torch.int64, "pull": torch.int32,
            "offsets": torch.int32}
    for name, ten in tensors.items():
        if ten.device != X.device:
            raise ValueError(f"rtr_solve_fused: {name} on {ten.device}, X on {X.device}")
        if ten.dtype != want.get(name, float_dtype):
            raise TypeError(
                f"rtr_solve_fused: {name} is {ten.dtype}, expected "
                f"{want.get(name, float_dtype)}"
            )
        if not ten.is_contiguous():
            raise ValueError(f"rtr_solve_fused: {name} is not contiguous")
    return m, kw, tw, offsets


def _launch(X, m, Pinv, edges, params, offsets, kw, tw):
    global LAUNCHES
    n, r, dp1 = X.shape
    d = dp1 - 1
    E = edges.num_edges
    num_robots = offsets.shape[0] - 1
    lib = _library()
    ws = lib.dpgo_rtr_block_workspace_floats(d, r, n, E)
    X_out = torch.empty_like(X)
    stats = torch.empty(6 + 2 * num_robots, dtype=torch.float32, device=X.device)
    work = torch.empty(ws, dtype=torch.float32, device=X.device)
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(X.device):  # launch on X's card, in its stream
        rc = lib.dpgo_rtr_block_solve(
            d, r, n, E, int(edges.pull.shape[1]), num_robots,
            p(X), p(m), p(Pinv), p(edges.src), p(edges.dst), p(edges.R),
            p(edges.t), p(kw), p(tw), p(edges.pull), p(offsets),
            p(X_out), p(stats), p(work),
            int(params.max_iterations), int(params.max_tcg_iterations),
            float(params.gradnorm_tol), float(params.initial_radius),
            float(params.max_radius), float(params.tcg_kappa),
            float(params.tcg_theta),
            ctypes.c_void_p(torch.cuda.current_stream(X.device).cuda_stream),
        )
    if rc != 0:
        raise RuntimeError(f"rtr_block_solve launch failed: cudaError {rc}")
    LAUNCHES += 1
    return X_out, stats


def rtr_solve_fused_ref(
    X: torch.Tensor,
    mask: torch.Tensor,
    Pinv: torch.Tensor,
    edges: EdgeSet,
    params: RTRParams,
    offsets: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``rtr_solve`` plus the same
    stats vector (in X's dtype). Runs on any device."""
    n = X.shape[0]
    m3 = mask.reshape(n, 1, 1)
    X_new, res = rtr_solve(X, edges, m3, Pinv, params)
    bounds = [0, n] if offsets is None else [int(o) for o in offsets.tolist()]
    D2 = (((X_new - X) * m3) ** 2).sum(dim=(-2, -1))
    mv = m3.reshape(n)
    moved = [torch.sqrt(D2[a:b].sum()) for a, b in zip(bounds[:-1], bounds[1:])]
    upd = [mv[a:b].max() for a, b in zip(bounds[:-1], bounds[1:])]
    head = torch.stack([
        res.f_init, res.f_opt, res.gradnorm_init, res.gradnorm_opt,
        torch.tensor(float(res.iterations), dtype=X.dtype, device=X.device),
        torch.tensor(float(res.tcg_iterations), dtype=X.dtype, device=X.device),
    ])
    return X_new, torch.cat([head, torch.stack(moved), torch.stack(upd)])
