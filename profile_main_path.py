#!/usr/bin/env python3
"""Where the main path's time goes on the card (PyTorch/CUDA port).

Run from the repository root on a machine with one CUDA GPU:

    python3 profile_main_path.py [--mode engine|fused|async] [--top 12]
    python3 profile_main_path.py --update_rule Parallel
    python3 profile_main_path.py --world sphere50k
    python3 profile_main_path.py --acceleration [--mode fused | --update_rule Parallel]

Runs the CLI main path (``--demo dpgo_demo --synthetic sphere
--synthetic_n 2500 --device cuda --mode MODE``; with ``--update_rule
Parallel`` the engine's Parallel route, one K1 launch per colour update;
for ``async`` the ``--demo asapp_demo`` path on the same world; with
``--world sphere50k``
the large-world engine route, ``--synthetic sphere --synthetic_n 50000
--num_robots 16`` with Odometry init, RoundRobin and at most 10 sweeps;
with ``--acceleration`` the dpgo_demo path with ``--acceleration true``,
one K4 (or K1) launch per update and per restart in either mode, and one
K7 launch per update)
once to build the kernels and load the CUDA libraries, then once more
under ``torch.profiler``.
From the profiled run's trace it prints:

* the CLI's wall split (init / solve / rounding / export);
* device busy time: the union of the intervals of kernel, memcpy and
  memset events on the card;
* the device time of the windowed block solve (K4, engine mode's
  RoundRobin updates), of the colour-window block solve (K1, the Parallel
  rule's updates), of the multi-step kernel (K2, fused mode) and of the
  ASAPP tick kernel (K3, async mode) and of the accelerated step's
  extrapolation (K7, with ``--acceleration``), each with its share of busy time,
  its launches and its mean per launch;
* the idle share, 1 − busy / wall, where wall is the host time of the
  profiled ``cli.run`` call;
* the device kernels launched in the profiled run (init included);
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
from dpgo_ros_tpu_torch.scripts.roofline import DEVICE_CATS, busy_us
from dpgo_ros_tpu_torch.utils import profiling

KERNELS = {"k1": "rtr_block_kernel", "k2": "rtr_run_kernel", "k3": "asapp_tick_kernel",
           "k4": "rtr_window_kernel", "k7": "nesterov_extrapolate_kernel"}
WORLDS = {
    "sphere2500": ["--synthetic", "sphere", "--synthetic_n", "2500"],
    # chip_smoke.py's large-world main path
    "sphere50k": ["--synthetic", "sphere", "--synthetic_n", "50000", "--num_robots", "16",
                  "--local_initialization_method", "Odometry", "--update_rule",
                  "RoundRobin", "--RTR_gradnorm_tol", "0.5",
                  "--relative_change_tolerance", "0.2", "--max_iteration_number", "160"],
}


def _launches():
    return {k: v for k, v in profiling.launches().items() if k in KERNELS}


def _zero_launches():
    profiling.set_counters({f"{k}.launches": 0 for k in profiling.KERNELS})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=["engine", "fused", "async"], default="engine")
    ap.add_argument("--world", choices=list(WORLDS), default="sphere2500")
    ap.add_argument("--update_rule", choices=["RoundRobin", "Parallel"], default=None,
                    help="engine mode only; default: the demo's (RoundRobin)")
    ap.add_argument("--acceleration", action="store_true",
                    help="the dpgo_demo path with --acceleration true (not async)")
    ap.add_argument("--top", type=int, default=12)
    a = ap.parse_args(argv)
    if a.acceleration and (a.mode == "async" or a.world != "sphere2500"):
        ap.error("--acceleration goes with the sphere2500 engine and fused routes only")
    if a.world == "sphere50k" and a.mode != "engine":
        ap.error("--world sphere50k profiles the engine route only")
    if a.update_rule and (a.mode != "engine" or a.world != "sphere2500"):
        ap.error("--update_rule goes with the sphere2500 engine route only")
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path: torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    if a.world == "sphere50k":
        argv = WORLDS[a.world]
    else:
        demo = "asapp_demo" if a.mode == "async" else "dpgo_demo"
        argv = ["--demo", demo] + WORLDS[a.world]
    argv = argv + ["--device", "cuda", "--mode", a.mode]
    if a.update_rule:
        argv += ["--update_rule", a.update_rule]
    if a.acceleration:
        argv += ["--acceleration", "true"]
    summary, extras = cli.run(argv)  # build, library loads, allocator warm-up
    print("warm-up run: " + json.dumps(summary), flush=True)
    print("warm-up timing_sec " + json.dumps(extras["timing_sec"]), flush=True)

    _zero_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        summary, extras = cli.run(argv)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    launches = _launches()
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
    busy_ms = busy_us([(e["ts"], e["dur"]) for e in dev]) / 1e3
    kernels = sum(e.get("cat") == "kernel" for e in dev)
    out = {"card": card, "mode": a.mode, "world": a.world,
           "update_rule": a.update_rule or "demo's", "acceleration": a.acceleration,
           "wall_ms": wall_ms, "timing_sec": extras["timing_sec"], "device_busy_ms": busy_ms,
           "kernel_launches": kernels}
    for key, name in KERNELS.items():
        ev = [e for e in dev if name in e.get("name", "")]
        ms = sum(e["dur"] for e in ev) / 1e3
        assert len(ev) == launches[key], (key, len(ev), launches)
        out.update({f"{key}_ms": ms, f"{key}_launches": len(ev),
                    f"{key}_ms_per_launch": ms / max(len(ev), 1),
                    f"{key}_share_of_busy": ms / busy_ms})
    want = dict.fromkeys(KERNELS, 0)
    if a.mode == "engine" or a.acceleration:
        # one K4 (RoundRobin) or K1 (Parallel) launch per update, and per
        # restart of an accelerated one
        want["k1" if a.update_rule == "Parallel" else "k4"] = (
            extras["block_updates"] + extras["restarts"])
        if a.acceleration:  # K7 once per accelerated update
            want["k7"] = extras["block_updates"]
    elif a.mode == "fused":
        want["k2"] = 1
    else:
        want["k3"] = summary["ticks"]
    assert launches == want and max(want.values()) > 0, (launches, want)

    rows = sorted(prof.key_averages(), key=lambda r: -r.device_time_total)
    for r in rows[:a.top]:
        print(f"  {r.key[:70]:70s} calls {r.count:6d} device "
              f"{r.device_time_total / 1e3:10.3f} ms")
    out.update({
        "idle_share": 1.0 - busy_ms / wall_ms,
        "iterations": summary.get("iterations", summary.get("ticks")),
        "restarts": extras.get("restarts", 0),
        "final_cost": summary["final_cost"],
    })
    shares = ", ".join(f"{k.upper()} {out[k + '_ms']:.3f} ms "
                       f"({100 * out[k + '_share_of_busy']:.1f} %)" for k in KERNELS)
    print(f"device busy {busy_ms:.3f} ms, {shares}, wall {wall_ms:.1f} ms, "
          f"idle share {out['idle_share']:.3f}; {kernels} kernel launches")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
