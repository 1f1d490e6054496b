"""Whether a torch.profiler trace of a short kernel call keeps the call's
device intervals, with and without the host pad of ``roofline.padded_profile``.

The roofline (``scripts/roofline.py``) and ``chip_smoke.py`` read device
times from traces of calls that last well under a millisecond. The card's
timestamps in such a trace can jump against the host's, and the profiler
drops a device interval that falls outside the session's host window. This
script traces one and four forced K4 solves (K = 1, on sphere2500's robot 0
window, as the roofline's shortest chains) under each pad in turn for
``--seconds``, and counts the traces that hold fewer K4 intervals than the
solves launched. Run on a machine with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.trace_pad [--seconds 200] [--pads 0,0.02]

Prints one JSON line: the card's name and power limit, and per (solves,
pad) the traces, the short ones, and the range of the first K4 interval's
start minus its launch call's start (µs; negative means the card's clock
put the kernel before its launch). Exits nonzero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import kernels
from dpgo_ros_tpu_torch.scripts import measure_peaks, roofline


def trace(solve, X0, params, solves: int, pad: float) -> dict:
    """One padded trace of ``solves`` chained solves: its K4 intervals and
    the first one's start minus its launch call's start (µs)."""
    with roofline.padded_profile(pad=pad) as prof:
        X = X0
        for _ in range(solves):
            X, _ = solve(X, params)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    k4 = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
          and "rtr_window_kernel" in e.get("name", "")]
    out = {"k4": len(k4), "offset_us": None}
    if k4:
        c = k4[0].get("args", {}).get("correlation")
        calls = [e["ts"] for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and e.get("args", {}).get("correlation") == c]
        if calls:
            out["offset_us"] = k4[0]["ts"] - calls[0]
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seconds", type=float, default=200.0)
    p.add_argument("--pads", default="0,0.02", help="comma-separated seconds")
    a = p.parse_args(argv)
    measure_peaks.require_cuda("trace_pad")
    pads = [float(x) for x in a.pads.split(",")]
    kernels.build_all()
    data, _ = roofline.load_data("sphere2500")
    prob = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device="cuda")
    X0, Pinv = roofline.init_state(prob)
    solve, _ = roofline.solvers(prob, Pinv, ["k4"])["k4"]
    params = roofline.forced_params(1)
    rows = {f"{n}x{pad}": {"solves": n, "pad_s": pad, "traces": 0, "short": 0,
                           "offset_us_min": None, "offset_us_max": None}
            for n in (1, 4) for pad in pads}
    t0 = time.time()
    while time.time() - t0 < a.seconds:
        for row in rows.values():
            o = trace(solve, X0, params, row["solves"], row["pad_s"])
            row["traces"] += 1
            row["short"] += o["k4"] < row["solves"]
            if o["offset_us"] is not None:
                lo, hi = row["offset_us_min"], row["offset_us_max"]
                row["offset_us_min"] = o["offset_us"] if lo is None else min(lo, o["offset_us"])
                row["offset_us_max"] = o["offset_us"] if hi is None else max(hi, o["offset_us"])
    out = {"card": measure_peaks.card_line(), "seconds": time.time() - t0,
           "rows": list(rows.values())}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
