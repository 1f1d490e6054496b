"""Whether the first torch.profiler traces of a fresh process keep their
device intervals: one padded trace of one K4 solve, in many processes.

The standalone roofline (``scripts/roofline.py``) times one reference-budget
K4 solve on sphere2500's robot 0 window as the chains ``(0, 1)``: an empty
profiler session, then a session around one solve. On its first run in a
fresh process that trace has held no kernel interval. This script starts
``--procs`` fresh processes per arm. Each loads the sphere2500 stand-in,
builds K4's robot 0 window, solves once untraced (the library loaded),
runs its arm's prelude and then takes ``--traces`` padded traces, each
read as the roofline reads it: of one reference-budget K4 solve, and every
other one of a chain of two forced K = 1 solves (the roofline's shortest
chain). Arms:

* ``first``: no prelude, the K4 trace is the process's first session;
* ``after_empty``: an empty padded session first, as the chain ``(0, 1)``;
* ``heavy``: ``--heavy_s`` seconds of untraced K4 solves first;
* ``traced_heavy``: one traced K4 solve, then the heavy untraced work;
* ``first_probe``: the first session launches a torch kernel at each of
  :data:`PROBE_MS` ms after it starts and then the K4 solve, with no pad
  (which probes the trace keeps shows when the session starts recording);
* ``build_in_session``: the K4 library is built (nvcc, into a build
  directory of the process's own) inside the first session, around its
  first solve, as the standalone roofline builds a kernel inside its first
  chain's session;
* ``long_session``: the first session stays open ``--long_s`` seconds
  (asleep) before one solve;
* ``long_busy``: the first session holds ``--long_s`` seconds of solves;
* ``spawn_in_session``: the first session starts a subprocess (``nvcc
  --version``) and then one solve;
* an arm name ending in ``+noteardown`` or ``+eager`` runs its arm with
  ``TEARDOWN_CUPTI=0`` or ``DISABLE_CUPTI_LAZY_REINIT=1`` in its
  environment (Kineto's switches for tearing CUPTI down after a session,
  and for re-initialising it at once rather than at the next launch); one
  ending in ``+pad200`` pads its traces 0.2 s, one ending in ``+marker``
  launches and synchronizes a marker kernel in each traced session after
  its leading pad, before the traced call.

``--session padded`` (default) traces with ``utils.profiling.padded_profile``
as the roofline does: the kernels built and a known launch traced before
the first session, no session after one held open over 30 s (so a long
arm raises at its first trace after the prelude). ``--session raw``
traces with the bare padded session it replaced
(:func:`raw_padded_profile`), as the runs that found the cause did
(PERF.md §7).

Run from the repository root on a machine with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.first_trace [--procs 20] [--arms a,b]

Prints one JSON line: the card's name and power limit, and per arm the
processes, how many lost a kernel in their first trace and in a later one,
and the counts of one process whose first trace lost it (else of the
first process). Exits nonzero without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import kernels
from dpgo_ros_tpu_torch.scripts import measure_peaks, roofline
from dpgo_ros_tpu_torch.utils import profiling

ARMS = ("first", "after_empty", "heavy", "traced_heavy", "first_probe", "build_in_session",
        "long_session", "long_busy", "spawn_in_session")
# arm suffixes: environment of the process, or arguments of its child
ENV = {"noteardown": {"TEARDOWN_CUPTI": "0"}, "eager": {"DISABLE_CUPTI_LAZY_REINIT": "1"}}
FLAGS = {"pad200": ["--pad", "0.2"], "marker": ["--marker"]}
PROBE_MS = (0, 5, 10, 20, 50, 100, 200, 400)


@contextlib.contextmanager
def raw_padded_profile(pad: float = profiling.TRACE_PAD_S):
    """The padded session without any per-process preparation: synchronize,
    start torch.profiler, sleep ``pad``, the body, synchronize, sleep."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        yield prof
        torch.cuda.synchronize()
        time.sleep(pad)


def read(events, launched: int) -> dict:
    """What a trace holds: its device intervals by kind, the K4 ones, the
    CUDA runtime and driver calls, each device interval's start minus its
    launch call's (µs), the body's host window, and whether
    ``roofline.session_busy_ms`` reads it."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in roofline.DEVICE_CATS]
    calls = {}
    for e in events:
        c = e.get("args", {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and c is not None:
            calls.setdefault(c, e["ts"])
    offs = [e["ts"] - calls[e["args"]["correlation"]] for e in dev
            if e.get("args", {}).get("correlation") in calls]
    body = [e for e in events if e.get("name") == "body" and e.get("ph") == "X"]
    out = {
        "launched": launched,
        "kernels": sum(e["cat"] == "kernel" for e in dev),
        "k4": sum("rtr_window_kernel" in e.get("name", "") for e in dev),
        "probes": sum("spin_kernel" in e.get("name", "") for e in dev),
        "memcpy": sum(e["cat"] == "gpu_memcpy" for e in dev),
        "memset": sum(e["cat"] == "gpu_memset" for e in dev),
        "runtime": sum(e.get("cat") == "cuda_runtime" for e in events),
        "driver": sum(e.get("cat") == "cuda_driver" for e in events),
        "kernel_names": sorted({e.get("name", "")[:40] for e in dev if e["cat"] == "kernel"}),
        "offset_us": [min(offs), max(offs)] if offs else None,
        "body_us": [body[0]["ts"], body[0]["ts"] + body[0]["dur"]] if body else None,
        "dev_us": [min(e["ts"] for e in dev), max(e["ts"] + e["dur"] for e in dev)]
        if dev else None,
    }
    try:
        out["busy_ms"] = roofline.session_busy_ms(events, launched)
    except RuntimeError as ex:
        out["busy_ms"], out["error"] = None, str(ex)
    return out


def child(arm: str, traces: int, heavy_s: float, session: str, long_s: float,
          pad_s: float = profiling.TRACE_PAD_S, marker: bool = False) -> dict:
    """One process's run of ``arm`` (without its suffix)."""
    padded = profiling.padded_profile if session == "padded" else raw_padded_profile
    if arm == "build_in_session":
        kernels.BUILD_DIR = kernels.BUILD_DIR / f"private_{os.getpid()}"
    data, _ = roofline.load_data("sphere2500")
    prob = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device="cuda")
    X0, Pinv = roofline.init_state(prob)
    solve, _ = roofline.solvers(prob, Pinv, ["k4"])["k4"]

    def one():
        return solve(X0, roofline.REF_PARAMS)

    def chain2():
        X = X0
        for _ in range(2):
            X, _ = solve(X, roofline.forced_params(1))

    def traced(fn, pad=True):
        before = profiling.launches()["k4"]
        if pad:
            with padded(pad=pad_s) as prof:
                if marker:
                    torch.cuda._sleep(1000)
                    torch.cuda.synchronize()
                with record_function("body"):
                    fn()
        else:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with record_function("body"):
                    fn()
                torch.cuda.synchronize()
        return read(profiling.chrome_events(prof), profiling.launches()["k4"] - before)

    def heavy():
        t0 = time.time()
        while time.time() - t0 < heavy_s:
            for _ in range(100):
                one()
            torch.cuda.synchronize()

    t0 = time.time()
    out = {"arm": arm, "prelude": None, "traces": []}
    if arm == "build_in_session":
        out["prelude"] = traced(one)  # the nvcc build runs inside it
    else:
        one()
        torch.cuda.synchronize()
    if arm == "long_session":
        out["prelude"] = traced(lambda: (time.sleep(long_s), one()))
    elif arm == "long_busy":
        def busy():
            while time.time() - t0 < long_s:
                for _ in range(50):
                    one()
                torch.cuda.synchronize()
        out["prelude"] = traced(busy)
    elif arm == "spawn_in_session":
        out["prelude"] = traced(lambda: (subprocess.run([kernels.nvcc(), "--version"],
                                                        capture_output=True), one()))
    elif arm == "after_empty":
        out["prelude"] = traced(lambda: None)
    elif arm == "heavy":
        heavy()
    elif arm == "traced_heavy":
        out["prelude"] = traced(one)
        heavy()
    elif arm == "first_probe":
        def probes():
            t0 = time.perf_counter()
            for ms in PROBE_MS:
                while (time.perf_counter() - t0) * 1e3 < ms:
                    time.sleep(1e-4)
                torch.cuda._sleep(1000)  # one spin_kernel
            one()

        out["traces"].append(traced(probes, pad=False))
    while len(out["traces"]) < traces:
        out["traces"].append(traced(chain2 if len(out["traces"]) % 2 else one))
        out["traces"][-1]["t_s"] = time.time() - t0
    out["wall_s"] = time.time() - t0
    return out


def _spawn(arm: str, a) -> dict:
    base, _, flag = arm.partition("+")
    env = dict(os.environ, **ENV.get(flag, {}))
    cmd = [sys.executable, "-m", "dpgo_ros_tpu_torch.scripts.first_trace", "--child", base,
           "--traces", str(a.traces), "--heavy_s", str(a.heavy_s), "--session", a.session,
           "--long_s", str(a.long_s), *FLAGS.get(flag, [])]
    p = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    if p.returncode or not lines:
        raise RuntimeError(f"{arm}: exit {p.returncode}: {p.stderr[-2000:]}")
    return dict(json.loads(lines[-1]), arm=arm)


def summary(arm: str, runs: list) -> dict:
    lost = [r for r in runs if r["traces"][0]["k4"] < r["traces"][0]["launched"]]
    later = [r for r in runs if any(t["k4"] < t["launched"] for t in r["traces"][1:])]
    return {"arm": arm, "processes": len(runs), "first_lost": len(lost),
            "later_lost": len(later),
            "traces_lost": sum(t["k4"] < t["launched"] for r in runs for t in r["traces"]),
            "traces": sum(len(r["traces"]) for r in runs),
            "prelude_lost": sum(bool(r["prelude"] and r["prelude"].get("error")) for r in runs),
            "example": (lost or runs)[0]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--procs", type=int, default=20, help="fresh processes per arm")
    p.add_argument("--arms", default=",".join(ARMS))
    p.add_argument("--traces", type=int, default=3, help="K4 traces per process")
    p.add_argument("--heavy_s", type=float, default=3.0)
    p.add_argument("--long_s", type=float, default=60.0)
    p.add_argument("--pad", type=float, default=profiling.TRACE_PAD_S, help=argparse.SUPPRESS)
    p.add_argument("--marker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--jobs", type=int, default=3, help="processes at a time")
    p.add_argument("--session", choices=("padded", "raw"), default="padded")
    p.add_argument("--child", help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    measure_peaks.require_cuda("first_trace")
    if a.child:
        out = child(a.child, a.traces, a.heavy_s, a.session, a.long_s, a.pad, a.marker)
        print(json.dumps(out), flush=True)
        return out
    arms = [s for s in a.arms.split(",") if s]
    bad = [s for s in arms if s.partition("+")[0] not in ARMS or s.partition("+")[2]
           not in ("", *ENV, *FLAGS)]
    if bad:
        p.error(f"unknown arms {bad}")
    kernels.build_all()
    # interleaved, so that every arm meets the same load on the card
    order = [arm for _ in range(a.procs) for arm in arms]
    t0 = time.time()
    with ThreadPoolExecutor(a.jobs) as pool:
        runs = list(pool.map(lambda arm: _spawn(arm, a), order))
    out = {"card": measure_peaks.card_line(), "session": a.session,
           "seconds": time.time() - t0, "pad_s": profiling.TRACE_PAD_S,
           "arms": [summary(arm, [r for r in runs if r["arm"] == arm]) for arm in arms]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
