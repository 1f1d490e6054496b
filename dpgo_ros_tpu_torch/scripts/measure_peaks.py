"""Measured attainable fp32 rate of the card, from two calibration chains.

Port of ``scripts/measure_peaks.py`` (``measure_vpu_attainable``,
``measure_vpu_cml``). Run on a machine with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.measure_peaks

Each witness runs one kernel of ``ops/peak_chains.py`` on fixed random
slabs (8 × (256, 512) fp32 from a seeded numpy generator) at the trip
counts ``peak_chains.ITERS``: K5, logistic-map chains (3 flop per element
and step), and K6, a coupled-map lattice with another operation mix (6).
For each trip count the output's checksum is read back once before timing
(a chain that was folded away would give one checksum for all counts), and
the time of one launch is the least of 5 CUDA-event timings. The rate is
the flops of one step over the time per step, taken as the slope between
the two largest trip counts, so fixed launch costs cancel. A calibration
is valid only if both slopes are positive, they agree within a factor 2
(the time is linear in the trip count) and the checksums differ.

Prints one JSON line: the K5 calibration, with the K6 one and the two
witnesses' agreement beside it, and the card's name and power limit.
Exits nonzero without a card. ``scripts/roofline.py`` imports it.
"""

from __future__ import annotations

import json
import subprocess
import sys
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from dpgo_ros_tpu_torch.ops import peak_chains
from dpgo_ros_tpu_torch.ops.peak_chains import LANES, NCHAIN, ROWS

TIMINGS = 5  # launches timed per trip count; the least counts
# the JAX script's inputs: (numpy seed, low, high) of the uniform slabs
K5_INPUT, K6_INPUT = (7, 0.2, 0.8), (11, 0.1, 3.9)


def require_cuda(who: str) -> None:
    if not torch.cuda.is_available():
        raise SystemExit(f"{who}: needs a CUDA device (torch.cuda.is_available() "
                         "is false); it measures the card and has no CPU fallback")


def card_line() -> str:
    """The first card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def card() -> Dict[str, str]:
    """The card's name and power limit (nvidia-smi) and the versions of
    torch and CUDA."""
    name, limit = card_line().rsplit(", ", 1)
    return {"name": name, "power_limit": limit, "torch": torch.__version__,
            "cuda": torch.version.cuda}


def slopes(times: Dict[int, float], iters: Sequence[int]) -> Tuple[float, float]:
    """Seconds per step between the first two and the last two trip
    counts."""
    s1 = (times[iters[1]] - times[iters[0]]) / (iters[1] - iters[0])
    s2 = (times[iters[2]] - times[iters[1]]) / (iters[2] - iters[1])
    return s1, s2


def calibration_valid(s1: float, s2: float, sums: Dict[int, float]) -> bool:
    """The JAX package's rule: both slopes positive, within a factor 2 of
    each other, and the checksums not all equal (to 4 decimals)."""
    return (s1 > 0 and s2 > 0 and 0.5 < s1 / s2 < 2.0
            and len(set(round(v, 4) for v in sums.values())) > 1)


def _launch_s(fn: Callable, x: torch.Tensor, n_iter: int) -> float:
    """Least device time of one launch over TIMINGS launches, in seconds."""
    ts = []
    for _ in range(TIMINGS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn(x, n_iter)
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b) * 1e-3)
    return min(ts)


def measure(fn: Callable, x: torch.Tensor, flops_per_elem: int, method: str) -> dict:
    """One witness: checksums, times and slopes over ``peak_chains.ITERS``."""
    iters = peak_chains.ITERS
    times, sums = {}, {}
    for it in iters:
        sums[it] = float(fn(x, it).double().sum())  # read back before timing
        times[it] = _launch_s(fn, x, it)
    s1, s2 = slopes(times, iters)
    valid = calibration_valid(s1, s2, sums)
    flops_per_iter = flops_per_elem * NCHAIN * ROWS * LANES
    return {
        "fp32_attainable_flops": flops_per_iter / s2 if valid else None,
        "slope_us_per_iter": [s1 * 1e6, s2 * 1e6],
        "times_ms": {str(k): v * 1e3 for k, v in times.items()},
        "checksums": {str(k): v for k, v in sums.items()},
        "valid": valid,
        "iters": list(iters),
        "method": method,
    }


def slabs(seed: int, lo: float, hi: float, device="cuda") -> torch.Tensor:
    """(NCHAIN·ROWS, LANES) fp32 uniform in [lo, hi) from a numpy seed."""
    x = np.random.default_rng(seed).uniform(lo, hi, (NCHAIN * ROWS, LANES))
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def measure_attainable() -> dict:
    """K5, the logistic-map witness (the JAX ``measure_vpu_attainable``)."""
    return measure(peak_chains.chain_fused, slabs(*K5_INPUT), peak_chains.CHAIN_FLOPS,
                   "logistic-map chains, 8x(256,512) fp32 slabs, slope over trip counts")


def measure_cml() -> dict:
    """K6, the coupled-map-lattice witness (the JAX ``measure_vpu_cml``)."""
    return measure(peak_chains.chain_cml_fused, slabs(*K6_INPUT), peak_chains.CML_FLOPS,
                   "coupled-map-lattice chains (cross-chain mul/add + floor bound), "
                   "8x(256,512) fp32 slabs, slope over trip counts")


def agreement(cal: dict, cal2: dict) -> Tuple[float, bool]:
    """(K6 rate / K5 rate, whether both are valid and agree within a
    factor 2); the ratio is None unless both are valid."""
    if not (cal["valid"] and cal2["valid"]):
        return None, False
    ratio = cal2["fp32_attainable_flops"] / cal["fp32_attainable_flops"]
    return ratio, bool(0.5 < ratio < 2.0)


def main() -> dict:
    require_cuda("measure_peaks")
    r = measure_attainable()
    r2 = measure_cml()
    ratio, ok = agreement(r, r2)
    for name, c in (("logistic (K5)", r), ("coupled-map (K6)", r2)):
        print(f"fp32 attainable, {name}: "
              + (f"{c['fp32_attainable_flops'] / 1e12:.3f} TFLOP/s" if c["valid"]
                 else "INVALID (nonlinear timing or equal checksums)")
              + f" (slopes {c['slope_us_per_iter'][0]:.5f} / "
              f"{c['slope_us_per_iter'][1]:.5f} us per step)", file=sys.stderr)
    out = dict(r, cml_calibration=r2, witness_agreement_ratio=ratio,
               two_witness_valid=ok, card=card())
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
