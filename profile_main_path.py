#!/usr/bin/env python3
"""Where the main path's time goes on the card (PyTorch/CUDA port).

Run from the repository root on a machine with one CUDA GPU:

    python3 profile_main_path.py [--top 12]

Runs the CLI main path (``--demo dpgo_demo --synthetic sphere
--synthetic_n 2500 --device cuda``) once to build the block-solve kernel
and load the CUDA libraries, then once more under ``torch.profiler``.
From the profiled run's trace it prints:

* the CLI's wall split (init / solve / rounding / export);
* device busy time: the union of the intervals of kernel, memcpy and
  memset events on the card;
* the block-solve kernel's device time, its share of busy time and its
  mean per launch;
* the idle share, 1 − busy / wall, where wall is the host time of the
  profiled ``cli.run`` call;
* the ``--top`` operators by device time.

The last stdout line is one JSON object holding these numbers. The
profiler adds host overhead per launch, so the wall and idle share of the
profiled run are upper bounds for an unprofiled one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from dpgo_ros_tpu_torch import cli
from dpgo_ros_tpu_torch.ops import fused_rtr

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
KERNEL_NAME = "rtr_block_kernel"
ARGV = ["--demo", "dpgo_demo", "--synthetic", "sphere", "--synthetic_n", "2500",
        "--device", "cuda"]


def busy_us(events) -> float:
    """Length of the union of [ts, ts + dur) over the events, in µs."""
    total, end = 0.0, -float("inf")
    for ts, dur in sorted((e["ts"], e["dur"]) for e in events):
        if ts + dur <= end:
            continue
        total += ts + dur - max(ts, end)
        end = ts + dur
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--top", type=int, default=12)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path: torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    summary, extras = cli.run(ARGV)  # build, library loads, allocator warm-up
    print("warm-up run: " + json.dumps(summary), flush=True)
    print("warm-up timing_sec " + json.dumps(extras["timing_sec"]), flush=True)

    fused_rtr.LAUNCHES = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        summary, extras = cli.run(ARGV)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    launches = fused_rtr.LAUNCHES
    print("profiled run: " + json.dumps(summary), flush=True)
    print("profiled timing_sec " + json.dumps(extras["timing_sec"]), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    dev = [e for e in trace.get("traceEvents", [])
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not dev:
        raise SystemExit("profile_main_path: the trace holds no device events")
    busy_ms = busy_us(dev) / 1e3
    k1 = [e for e in dev if KERNEL_NAME in e.get("name", "")]
    k1_ms = sum(e["dur"] for e in k1) / 1e3
    assert len(k1) == launches == extras["block_updates"] > 0, (
        len(k1), launches, extras["block_updates"])

    rows = sorted(prof.key_averages(), key=lambda r: -r.device_time_total)
    for r in rows[:a.top]:
        print(f"  {r.key[:70]:70s} calls {r.count:6d} device "
              f"{r.device_time_total / 1e3:10.3f} ms")
    out = {
        "card": card,
        "wall_ms": wall_ms,
        "timing_sec": extras["timing_sec"],
        "device_busy_ms": busy_ms,
        "k1_ms": k1_ms,
        "k1_launches": len(k1),
        "k1_ms_per_launch": k1_ms / len(k1),
        "k1_share_of_busy": k1_ms / busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "iterations": summary["iterations"],
        "final_cost": summary["final_cost"],
    }
    print(f"device busy {busy_ms:.3f} ms, K1 {k1_ms:.3f} ms "
          f"({100 * out['k1_share_of_busy']:.1f} %), wall {wall_ms:.1f} ms, "
          f"idle share {out['idle_share']:.3f}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
