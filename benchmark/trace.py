"""The traced stretch: a padded profiler session and what its Chrome trace says.

The padding is a frozen copy of ``dpgo_ros_tpu_torch/utils/profiling.py::
padded_profile``: the card is synchronized before and after the body and
the session is held open 20 ms on each side, because the card stamps a
kernel's interval up to ~6 ms before the host's launch time and the profiler
drops intervals outside its session. Its first-session check traces one
known launch (a ``torch.cuda._sleep`` spin kernel) and reports whether the
trace kept it. Sessions stay short: after one held open about a minute, the
later sessions of a process lost device intervals on an H100.

Kernels are counted one by one by name, never by a session total.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile

PAD_S = 0.02
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."
REQUEST_SPAN = "bench.request"


def chrome_events(prof) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])


def keeps_known_launch() -> bool:
    """Whether a session of this process keeps a known launch's device
    interval (run before the first traced stretch, kernels built)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PAD_S)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(PAD_S)
    return any(e.get("cat") == "kernel" and "spin_kernel" in e.get("name", "")
               for e in chrome_events(prof))


@contextlib.contextmanager
def padded_profile():
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PAD_S)


def _merge(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list) -> Optional[Dict]:
    """From a session's events: device seconds by kernel name, the busy
    seconds and the length of the traced window (the first request span's
    start to the last one's end), the top device operations, and the
    longest idle gaps named by the benchmark span they fell in ("request"
    outside the layer spans, "between_requests" outside any). None when
    the session holds no request span."""
    req = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == REQUEST_SPAN]
    if not req:
        return None
    w0 = min(e["ts"] for e in req)
    w1 = max(e["ts"] + e.get("dur", 0) for e in req)
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    by_name: Dict[str, float] = {}
    kernel_s: Dict[str, float] = {}
    kernel_n: Dict[str, int] = {}
    for e in dev:
        s = e.get("dur", 0) * 1e-6
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + s
        if e["cat"] == "kernel":
            kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + s
            kernel_n[e["name"]] = kernel_n.get(e["name"], 0) + 1
    merged = _merge([(max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1))
                     for e in dev if e["ts"] < w1 and e["ts"] + e.get("dur", 0) > w0])
    busy = sum(b - a for a, b in merged) * 1e-6
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(SPAN_PREFIX) and e["name"] != REQUEST_SPAN]
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a <= 0:
            continue
        mid = 0.5 * (a + b)
        within = lambda e: e["ts"] <= mid <= e["ts"] + e.get("dur", 0)
        inside = [s for s in spans if within(s)]
        if inside:
            name = min(inside, key=lambda s: s.get("dur", 0))["name"][len(SPAN_PREFIX):]
        else:
            name = "request" if any(within(e) for e in req) else "between_requests"
        gaps.append([name, (b - a) * 1e-6])
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(kernel_s=kernel_s, kernel_n=kernel_n, busy_s=busy, window_s=(w1 - w0) * 1e-6,
                device_ops=[[k, v] for k, v in ops], idle_gaps=gaps[:10])


def kernel_seconds(summary: Optional[Dict], pattern: str, launches: int) -> Optional[float]:
    """Device seconds of the kernels whose name holds ``pattern``, or None
    unless the trace holds exactly ``launches`` of them (the launches the
    traced requests made): a trace that lost intervals, or kept none, reads
    nothing rather than too little."""
    if not summary or launches <= 0:
        return None
    n = sum(v for k, v in summary["kernel_n"].items() if pattern in k)
    if n != launches:
        return None
    return sum(v for k, v in summary["kernel_s"].items() if pattern in k)

