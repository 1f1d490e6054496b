"""Tracing and profiling hooks.

Port of ``dpgo_ros_tpu/utils/profiling.py`` on ``torch.profiler``. The
reference's profiling is a ``std::chrono`` wall clock around
``iterate(true)`` plus a per-iteration CSV (``src/PGOAgentROS.cpp:159-162,
853-894``); the CSV schema lives in ``utils/telemetry.py``. This module
adds:

* :func:`device_trace` — a ``torch.profiler`` session around a ``with``
  body, exported as a Chrome trace (Perfetto, ``chrome://tracing``) into a
  directory: host ops, and on the card every kernel and copy with its
  device time (the CLI's ``--profile_dir``);
* :func:`padded_profile` — the session under it: synchronized and held
  open :data:`TRACE_PAD_S` at each end, so that no device interval of the
  body falls outside it; before a process's first CUDA session it builds
  the package's kernels and checks that a trace keeps a known launch, and
  it refuses a session after one held open :data:`LONG_SESSION_S`;
* :func:`annotate` — a named region on the same timeline;
* :class:`PhaseTimer` — wall-clock phase accounting, JSON-dumpable, for
  where no profiler runs.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# The card stamps a kernel's interval up to ~6 ms before the host's launch
# time, and the profiler drops intervals outside its session's host window:
# about 5 in 1,000 unpadded traces of one short K4 solve lost the kernel on
# an H100 (``scripts/trace_pad.py``; PERF.md §6). 20 ms of pad kept
# every one.
TRACE_PAD_S = 0.02
# After a session held open about a minute (asleep or busy), the later
# sessions of the process lost device intervals on an H100: a one-solve K4
# trace all of them, a two-solve one part; one held open 37 s cost none
# (scripts/first_trace.py; PERF.md §7). The standalone roofline opened its
# first session around nvcc's build of K1. So the first CUDA session of a
# process builds the kernels before it opens, and no session opens after
# one held open longer than this.
LONG_SESSION_S = 30.0
longest_session_s = 0.0  # the longest padded CUDA session of this process
_warmed_up = False


def chrome_events(prof) -> list:
    """The ``traceEvents`` of a finished session's Chrome trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])


def check_warm_up(events) -> None:
    """Raises unless the warm-up trace holds its known launch, one
    ``torch.cuda._sleep`` spin kernel."""
    if not any(e.get("cat") == "kernel" and "spin_kernel" in e.get("name", "")
               for e in events):
        raise RuntimeError("torch.profiler kept no device interval of a known launch: "
                           "this process's traces cannot time the card")


def _warm_up(pad: float) -> None:
    """Once per process, before its first CUDA session: build every kernel
    library of the package (an nvcc build inside a session holds it open
    for a minute), then trace one known launch and check that the trace
    holds it."""
    global _warmed_up
    if _warmed_up:
        return
    from dpgo_ros_tpu_torch.ops import fused_rtr

    fused_rtr.build_all()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(pad)
    check_warm_up(chrome_events(prof))
    _warmed_up = True


@contextlib.contextmanager
def padded_profile(activities=(ProfilerActivity.CPU, ProfilerActivity.CUDA),
                   pad: float = TRACE_PAD_S):
    """torch.profiler around the ``with`` body, held open ``pad`` seconds on
    each side; with the CUDA activity the card is synchronized before and
    after the body, so that every device interval of it lies inside the
    session, the process's first such session is preceded by
    :func:`_warm_up`, and a session after one held open longer than
    :data:`LONG_SESSION_S` is refused (RuntimeError). Without it nothing
    touches CUDA."""
    global longest_session_s
    cuda = ProfilerActivity.CUDA in activities
    if cuda:
        if longest_session_s > LONG_SESSION_S:
            raise RuntimeError(
                f"an earlier trace of this process stayed open {longest_session_s:.0f} s "
                f"(> {LONG_SESSION_S:.0f} s): later traces lose device intervals")
        _warm_up(pad)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with profile(activities=list(activities)) as prof:
            time.sleep(pad)
            yield prof
            if cuda:
                torch.cuda.synchronize()
            time.sleep(pad)
    finally:
        if cuda:
            longest_session_s = max(longest_session_s, time.perf_counter() - t0)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str], device=None):
    """A :func:`padded_profile` of the ``with`` body, its Chrome trace
    written to ``log_dir/trace_<pid>_<ms>.json`` (no-op if ``log_dir`` is
    None or empty). The CUDA activity is traced when ``device`` is a CUDA
    device; otherwise the trace holds the host only."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    cuda = device is not None and torch.device(device).type == "cuda"
    acts = ((ProfilerActivity.CPU, ProfilerActivity.CUDA) if cuda
            else (ProfilerActivity.CPU,))
    with padded_profile(acts) as prof:
        yield
    name = f"trace_{os.getpid()}_{int(time.time() * 1000)}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


def annotate(name: str):
    """Named region on the profiler timeline (a ``record_function``)."""
    return record_function(name)


class PhaseTimer:
    """Accumulating wall-clock phase timer.

    >>> pt = PhaseTimer()
    >>> with pt.phase("initialize"): ...
    >>> pt.summary()  # {"initialize": {"calls": 1, "total_sec": ...}}
    """

    def __init__(self):
        self._acc: Dict[str, Dict[str, float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            slot = self._acc.setdefault(
                name, {"calls": 0, "total_sec": 0.0, "max_sec": 0.0}
            )
            slot["calls"] += 1
            slot["total_sec"] += dt
            slot["max_sec"] = max(slot["max_sec"], dt)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "calls": int(v["calls"]),
                "total_sec": round(v["total_sec"], 6),
                "max_sec": round(v["max_sec"], 6),
            }
            for k, v in self._acc.items()
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=1)
