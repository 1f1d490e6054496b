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
  body falls outside it;
* :func:`annotate` — a named region on the same timeline;
* :class:`PhaseTimer` — wall-clock phase accounting, JSON-dumpable, for
  where no profiler runs.
"""

from __future__ import annotations

import contextlib
import json
import os
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


@contextlib.contextmanager
def padded_profile(activities=(ProfilerActivity.CPU, ProfilerActivity.CUDA),
                   pad: float = TRACE_PAD_S):
    """torch.profiler around the ``with`` body, held open ``pad`` seconds on
    each side; with the CUDA activity the card is synchronized before and
    after the body, so that every device interval of it lies inside the
    session. Without it nothing touches CUDA."""
    cuda = ProfilerActivity.CUDA in activities
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=list(activities)) as prof:
        time.sleep(pad)
        yield prof
        if cuda:
            torch.cuda.synchronize()
        time.sleep(pad)


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
