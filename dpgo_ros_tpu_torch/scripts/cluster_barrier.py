"""What the cluster solve's synchronisation costs on the card.

K2 and K4 run one window solve on a thread-block cluster
(``csrc/rtr_cluster.cuh``); a tCG iteration there is four dependent passes
over the window's poses separated by four cluster barriers, three of them
inside reductions (``cluster_sum``). This script times the barriers and
reductions alone, with the passes stubbed out (``csrc/cluster_barrier.cu``),
so that a measured tCG slope (``scripts/roofline.py``, K4 columns) splits
into synchronisation and passes. Run on a machine with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.cluster_barrier

For every cluster size in ``CLUSTERS`` and each body of the probe kernel
(four bare barriers; one tCG iteration's barrier and three reductions; one
reduction) it launches one cluster at each trip count of ``ITERS``, takes
the least of ``measure_peaks.TIMINGS`` CUDA-event timings per count, and
reports the slope between the two largest counts in µs per iteration.
Prints one JSON line with the card's name and power limit. Exits nonzero
without a card.
"""

from __future__ import annotations

import ctypes
import json
import sys
from typing import Dict

import torch

from dpgo_ros_tpu_torch.ops import fused_rtr
from dpgo_ros_tpu_torch.scripts import measure_peaks

SOURCE = fused_rtr._PKG / "csrc" / "cluster_barrier.cu"
# the clusters K2 and K4 take on chip_smoke's worlds (2–3 CTAs on the
# 2,500-pose robot windows, 7 on a Parallel colour, 14–15 at 50,000
# poses) and the portable and non-portable maxima
CLUSTERS = (2, 3, 4, 7, 8, 14, 15, 16)
ITERS = (200, 1000, 3000)
MODES = {"four_barriers": 0, "tcg_sync": 1, "one_reduction": 2}


def _lib() -> ctypes.CDLL:
    path, _ = fused_rtr.build(SOURCE)
    lib = ctypes.CDLL(str(path))
    lib.dpgo_cluster_barrier.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.dpgo_cluster_barrier.restype = ctypes.c_int
    return lib


def launch(lib: ctypes.CDLL, nc: int, iters: int, mode: int, out: torch.Tensor) -> None:
    """One probe cluster of ``nc`` CTAs; raises if it does not launch."""
    rc = lib.dpgo_cluster_barrier(
        nc, iters, mode, ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    fused_rtr.check_launch("cluster_barrier", rc, nc)


def slope_us(lib: ctypes.CDLL, nc: int, mode: int) -> Dict[str, float]:
    """µs per iteration between the two largest trip counts, and between
    the two smallest (their agreement says the time is linear)."""
    out = torch.zeros(nc, dtype=torch.float32, device="cuda")
    launch(lib, nc, ITERS[0], mode, out)  # warm-up
    times = {n: measure_peaks._launch_s(lambda _x, k: launch(lib, nc, k, mode, out), out, n)
             for n in ITERS}
    torch.cuda.synchronize()
    assert torch.isfinite(out).all(), out
    s1, s2 = measure_peaks.slopes(times, ITERS)
    return {"us_per_iter": s2 * 1e6, "us_per_iter_short": s1 * 1e6,
            "launch_us": {str(n): t * 1e6 for n, t in times.items()}}


def main() -> dict:
    measure_peaks.require_cuda("cluster_barrier")
    lib = _lib()
    rows = {str(nc): {name: slope_us(lib, nc, mode) for name, mode in MODES.items()}
            for nc in CLUSTERS}
    out = {"card": measure_peaks.card(), "iters": list(ITERS), "clusters": rows}
    for nc, row in rows.items():
        print(f"cluster {nc}: " + ", ".join(
            f"{k} {v['us_per_iter']:.3f} us" for k, v in row.items()), file=sys.stderr)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
