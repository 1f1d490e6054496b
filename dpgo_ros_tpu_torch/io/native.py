"""ctypes binding to the native C++ ingestion library (``native/g2o_parser.cpp``).

Port of ``dpgo_ros_tpu/io/native.py``. The port builds its own copy of the
library from the checkout's unchanged source at first use, into
``build/dpgo_ros_tpu_torch/`` (keyed by a hash of the source and the
flags), and never writes under ``native/``. It is compiled without FMA
contraction (``-ffp-contract=off``, no ``-march=native``), so that its
arithmetic is the Python parsers' operation for operation.
:func:`dpgo_ros_tpu_torch.io.g2o.read_g2o` (3D files) and
:func:`dpgo_ros_tpu_torch.io.csv_loader.load_measurements_csv` use it when
it is available; ``DPGO_TPU_NO_NATIVE=1`` forces their Python path. A
failed build is not silent: :func:`available` is then false and
:func:`build_error` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from dpgo_ros_tpu_torch.types import EdgeType, MeasurementBatch

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "g2o_parser.cpp"
BUILD_DIR = _ROOT / "build" / "dpgo_ros_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-ffp-contract=off", "-shared")

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def lib_path() -> Path:
    """Where the library of this source and these flags is built."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdpgo_native_{key.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """Compile the library into ``path`` (through a temporary name, so that
    processes building at once never load a half-written file)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    try:
        path = lib_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        _error = f"{type(exc).__name__}: {exc}"
        return None
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.dpgo_g2o_parse.restype = vp
    lib.dpgo_g2o_parse.argtypes = [ctypes.c_char_p]
    lib.dpgo_csv_parse.restype = vp
    lib.dpgo_csv_parse.argtypes = [ctypes.c_char_p]
    for name in ("dpgo_num_edges", "dpgo_num_vertices", "dpgo_max_id"):
        fn = getattr(lib, name)
        fn.restype = i32
        fn.argtypes = [vp]
    lib.dpgo_get_edges.restype = None
    lib.dpgo_get_edges.argtypes = [vp] * 11
    lib.dpgo_get_vertices.restype = None
    lib.dpgo_get_vertices.argtypes = [vp] * 3
    lib.dpgo_free.restype = None
    lib.dpgo_free.argtypes = [vp]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library is built (building it on the first call)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is not available, or None."""
    _load()
    return _error


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _extract(lib, h) -> Tuple[MeasurementBatch, int, Optional[Dict[int, np.ndarray]]]:
    E = lib.dpgo_num_edges(h)
    V = lib.dpgo_num_vertices(h)
    max_id = lib.dpgo_max_id(h)
    src_robot = np.zeros(E, np.int32)
    src_frame = np.zeros(E, np.int32)
    dst_robot = np.zeros(E, np.int32)
    dst_frame = np.zeros(E, np.int32)
    R = np.zeros((E, 3, 3), np.float64)
    t = np.zeros((E, 3), np.float64)
    kappa = np.zeros(E, np.float64)
    tau = np.zeros(E, np.float64)
    weight = np.zeros(E, np.float64)
    fixed = np.zeros(E, np.uint8)
    lib.dpgo_get_edges(
        h, _ptr(src_robot), _ptr(src_frame), _ptr(dst_robot), _ptr(dst_frame),
        _ptr(R), _ptr(t), _ptr(kappa), _ptr(tau), _ptr(weight), _ptr(fixed),
    )
    vertices: Optional[Dict[int, np.ndarray]] = None
    if V > 0:
        ids = np.zeros(V, np.int32)
        T = np.zeros((V, 3, 4), np.float64)
        lib.dpgo_get_vertices(h, _ptr(ids), _ptr(T))
        vertices = {int(ids[k]): T[k] for k in range(V)}
    lib.dpgo_free(h)
    from dpgo_ros_tpu_torch.io.partition import classify_edge_types

    m = MeasurementBatch(
        src_robot=src_robot,
        src_frame=src_frame,
        dst_robot=dst_robot,
        dst_frame=dst_frame,
        R=R,
        t=t,
        kappa=kappa,
        tau=tau,
        weight=weight,
        fixed_weight=fixed.astype(bool),
        edge_type=classify_edge_types(src_robot, src_frame, dst_robot, dst_frame),
    )
    return m, max_id + 1, vertices


def read_g2o_native(path: str):
    """Native g2o parse (3D tags only); the same triple as
    ``io.g2o.read_g2o`` (edge types all zero before partitioning), or None
    if the library is unavailable. Raises FileNotFoundError for a file that
    cannot be opened."""
    lib = _load()
    if lib is None:
        return None
    h = lib.dpgo_g2o_parse(os.fsencode(path))
    if not h:
        raise FileNotFoundError(path)
    m, n, v = _extract(lib, h)
    m.edge_type[:] = 0
    m.weight[:] = 1.0
    return m, n, v


def read_csv_native(path: str) -> Optional[MeasurementBatch]:
    """Native ``measurements.csv`` parse (``fixed_weight |= odometry``, as
    the Python loader), or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    h = lib.dpgo_csv_parse(os.fsencode(path))
    if not h:
        raise FileNotFoundError(path)
    m, _, _ = _extract(lib, h)
    m.fixed_weight |= m.edge_type == EdgeType.ODOMETRY
    return m
