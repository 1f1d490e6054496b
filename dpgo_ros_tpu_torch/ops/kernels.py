"""The kernel layer of the port: how the hand-written CUDA kernels K1–K7
(``csrc/``) are built, loaded, checked and launched. Their wrappers (K1 and
K2 ``fused_rtr``, K3 ``fused_asapp``, K4 ``hbm_rtr``, K5 and K6
``peak_chains``, K7 ``nesterov``) declare the C signatures of their own
entries and load their library through :func:`load`. This module imports
nothing of the package.

Each source is compiled with nvcc at first use, from the checkout's
sources, into :data:`BUILD_DIR` (keyed by a hash of the source, the shared
header and the flags) and bound through a plain C interface with ctypes.
A wrapper runs its full operand checks on its first call and again only
when what they read has changed (:func:`guard`, :func:`hit`).
"""

from __future__ import annotations

import ctypes
import hashlib
import operator
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
HEADER = CSRC / "rtr_cluster.cuh"  # the cluster solve of K1–K4
BLOCK_SOURCE = CSRC / "rtr_block.cu"  # K1
RUN_SOURCE = CSRC / "rtr_run.cu"  # K2
TICK_SOURCE = CSRC / "asapp_tick.cu"  # K3
WINDOW_SOURCE = CSRC / "rtr_window.cu"  # K4
PEAK_SOURCE = CSRC / "peak_chains.cu"  # K5, K6
EXTRAP_SOURCE = CSRC / "nesterov_extrapolate.cu"  # K7
ALL_SOURCES = (BLOCK_SOURCE, RUN_SOURCE, TICK_SOURCE, WINDOW_SOURCE, PEAK_SOURCE,
               EXTRAP_SOURCE)
BUILD_DIR = CSRC.parent.parent / "build" / "dpgo_ros_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MAX_RANK = 8  # the largest r the kernels are built for
# the dtypes of the kernels' index operands, by name (check_tensors)
INDEX_DTYPES = {"src": torch.int64, "dst": torch.int64, "pull": torch.int32,
                "offsets": torch.int32, "sched": torch.int32, "delays": torch.int32}

_libs: Dict[Path, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(source: Path) -> Path:
    """Library path for ``source`` in the build directory as it is now,
    keyed by a hash of every file it compiles (the source and the shared
    header) and the flags."""
    key = hashlib.sha256(
        source.read_bytes() + HEADER.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{key}.so"


def build_all(sources: Optional[Sequence[Path]] = None) -> List[Tuple[Path, str]]:
    """Compile every kernel source (default :data:`ALL_SOURCES`) whose
    library is missing, one nvcc per source, all started together. Returns
    (library path, ptxas report) per source; raises if any nvcc fails."""
    sources = list(sources) if sources is not None else list(ALL_SOURCES)
    libs = [lib_path(src) for src in sources]
    procs = []
    for src, lib in zip(sources, libs):
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs.append((src, lib, tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
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
    logs = [lib.with_suffix(".log") for lib in libs]
    return [(lib, log.read_text() if log.exists() else "") for lib, log in zip(libs, logs)]


def load(source: Path, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The library of ``source``, built if missing and loaded once, its
    entries declared on that load by ``signatures`` ({name: (argtypes,
    restype)}, the wrapper's own)."""
    lib = _libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([source])[0][0]))
        for name, (args, res) in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(args), res
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


def stream(card: int) -> int:
    """The handle of card ``card``'s current stream, which a launch on that
    card runs in. An entry that takes no card index is called inside
    ``torch.cuda.device`` of its operands' card."""
    return torch._C._cuda_getCurrentRawStream(card)


def guard(per_call: Sequence[torch.Tensor], held: Sequence[torch.Tensor], *static,
          rows: Sequence[torch.Tensor] = ()):
    """(key, held): the key of what a call's operand checks read, and the
    tensors it names by id. It holds each ``per_call`` operand's shape,
    dtype, device and strides, the ``static`` arguments, each ``held``
    tensor's id and version, and each of ``rows`` (a view taken afresh each
    call, such as a mask or schedule row) by its layout, the tensor it is a
    view of and its offset there. (None, None) where a tensor keeps no
    version (one made in inference mode): such calls are checked in full."""
    if rows:
        per_call = (*per_call, *rows)
        held = (*held, *[r if r._base is None else r._base for r in rows])
        static = (*static, *[r.storage_offset() for r in rows])
    try:
        return ([(t.shape, t.dtype, t.device, t.stride()) for t in per_call], static,
                [id(t) for t in held], [t._version for t in held]), held
    except RuntimeError:
        return None, None


def hit(kept: Optional[tuple], key: Optional[tuple]) -> bool:
    """Whether ``kept``, the (key, held) of the last call at a site whose
    checks passed (held so that no other tensor takes their ids meanwhile),
    has ``key``; a None key never has."""
    return key is not None and kept is not None and kept[0] == key


def solve_operands(Pinv, edges, offsets) -> tuple:
    """The long-lived operands of a cluster solve (K1–K4) that its checks
    read: P⁻¹, the edges' arrays and weights, the robot bounds."""
    return (Pinv, edges.R, edges.t, edges.src, edges.dst, edges.pull, offsets,
            edges.weight, edges.mask, edges.kappa, edges.tau)


def check_pose_shape(who: str, X: torch.Tensor) -> None:
    """Raise unless X is (n, r, d+1) with d 2 or 3 and r 1..:data:`MAX_RANK`."""
    if X.dim() != 3:
        raise ValueError(f"{who}: X shape {tuple(X.shape)}, expected (n, r, d+1)")
    _, r, dp1 = X.shape
    if dp1 - 1 not in (2, 3):
        raise ValueError(f"{who}: d={dp1 - 1} (kernel takes 2 or 3)")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"{who}: r={r} (kernel takes 1..{MAX_RANK})")


def check_tensors(who: str, X: torch.Tensor, tensors: Dict[str, torch.Tensor],
                  float_dtype: torch.dtype) -> None:
    """Raise unless each of ``tensors`` ({name: tensor}) is on X's device,
    contiguous and of its dtype: :data:`INDEX_DTYPES`' for its name, else
    ``float_dtype``."""
    for name, ten in tensors.items():
        if ten.device != X.device:
            raise ValueError(f"{who}: {name} on {ten.device}, X on {X.device}")
        want = INDEX_DTYPES.get(name, float_dtype)
        if ten.dtype != want:
            raise TypeError(f"{who}: {name} is {ten.dtype}, expected {want}")
        if not ten.is_contiguous():
            raise ValueError(f"{who}: {name} is not contiguous")


def checked_operands(who, X, Pinv, edges, offsets, float_dtype, params=None,
                     **tensors) -> None:
    """Raise on operands a cluster solve (K1–K4) cannot take: X on neither
    the CPU nor a card or refused by :func:`check_pose_shape`; P⁻¹ or the
    pull index not of X's poses; an unpreconditioned solve (where
    ``params`` are given); X, P⁻¹, the edges' arrays and effective
    weights, ``offsets`` or the kernel's own ``tensors`` refused by
    :func:`check_tensors`."""
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {X.device}")
    check_pose_shape(who, X)
    n, _, dp1 = X.shape
    if params is not None and not params.use_preconditioner:
        raise ValueError(f"{who}: the kernel is preconditioned only")
    if Pinv.shape != (n, dp1, dp1):
        raise ValueError(f"{who}: Pinv shape {tuple(Pinv.shape)}")
    if edges.pull.dim() != 2 or edges.pull.shape[0] != n:
        raise ValueError(f"{who}: pull shape {tuple(edges.pull.shape)}")
    kw, tw = edges.effective_weights()
    check_tensors(who, X, {
        "X": X, "Pinv": Pinv, "src": edges.src, "dst": edges.dst, "R": edges.R,
        "t": edges.t, "kw": kw, "tw": tw, "pull": edges.pull, "offsets": offsets,
        **tensors}, float_dtype)


def row_index(who: str, row, rows: int, what: str = "row") -> int:
    """``row`` (a window row, named ``what``) as an int in 0..rows-1, else
    raise."""
    if isinstance(row, bool):
        raise TypeError(f"{who}: {what} must be an integer")
    row = operator.index(row)
    if not 0 <= row < rows:
        raise ValueError(f"{who}: {what} {row} outside 0..{rows - 1}")
    return row
