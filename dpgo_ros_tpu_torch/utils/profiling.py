"""Tracing and profiling hooks.

Port of ``dpgo_ros_tpu/utils/profiling.py`` on ``torch.profiler``. The
reference's profiling is a ``std::chrono`` wall clock around
``iterate(true)`` plus a per-iteration CSV (``src/PGOAgentROS.cpp:159-162,
853-894``); the CSV schema lives in ``utils/telemetry.py``. This module
adds:

* :func:`device_trace` — a ``torch.profiler`` session around a ``with``
  body, exported as a Chrome trace (Perfetto, ``chrome://tracing``) into a
  directory: host ops, and on the card every kernel and copy with its
  device time (the CLI's ``--profile_dir``), optionally with
  :func:`span_table`'s per-span idle seconds beside it;
* :func:`padded_profile` — the session under it: synchronized and held
  open :data:`TRACE_PAD_S` at each end, so that no device interval of the
  body falls outside it; before a process's first CUDA session it builds
  the package's kernels and checks that a trace keeps a known launch, and
  it refuses a session after one held open :data:`LONG_SESSION_S`;
* the process's registry of spans and counters: :func:`span` (and
  :func:`spanned`, its decorator form) puts a named range on the
  profiler's timeline and accumulates per-name calls, total seconds and
  the seconds of the spans inside it while a ``torch.profiler`` session is
  active, and does nothing else otherwise; :func:`count` adds to an
  always-on integer counter. :func:`summary`, :func:`counters` and
  :func:`reset` read and clear them; self and idle seconds come from the
  trace (:func:`span_table`);
* :class:`PhaseTimer` — wall-clock phase accounting, JSON-dumpable, for
  where no profiler runs; the registry's per-name accumulator.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import itertools
import json
import os
import tempfile
import time
from typing import Dict, Iterable, List, Optional

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
    from dpgo_ros_tpu_torch.ops import kernels

    kernels.build_all()
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
def device_trace(log_dir: Optional[str], device=None, spans: bool = False):
    """A :func:`padded_profile` of the ``with`` body, its Chrome trace
    written to ``log_dir/trace_<pid>_<ms>.json`` (no-op if ``log_dir`` is
    None or empty). The CUDA activity is traced when ``device`` is a CUDA
    device; otherwise the trace holds the host only. With ``spans``,
    :func:`span_table` of the trace goes to ``log_dir/spans_<pid>.json``."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    cuda = device is not None and torch.device(device).type == "cuda"
    acts = ((ProfilerActivity.CPU, ProfilerActivity.CUDA) if cuda
            else (ProfilerActivity.CPU,))
    with padded_profile(acts) as prof:
        yield
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.json")
    prof.export_chrome_trace(path)
    if spans:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        table = span_table(events, _span_names, device_traced=cuda)
        with open(os.path.join(log_dir, f"spans_{os.getpid()}.json"), "w") as f:
            json.dump(table, f, indent=1)


# ---- spans and counters ----------------------------------------------
#
# One registry per process, its spans opened on one thread (the solve's).
# Off, a span costs one check: whether a torch.profiler session is
# active in the process. On, it is a range on the profiler's timeline (the
# cheapest event that lands in the Chrome trace, on the clock of every
# kernel and copy) and per-name totals on the host's clock.

_profiling = torch.autograd._profiler_enabled
_RangeEvent = getattr(torch._C._profiler, "_RecordFunctionFast", record_function)
_clock = time.perf_counter
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "t0", "within", "event")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.within = {}
        _span_names.add(self.name)
        self.event = _RangeEvent(self.name)
        self.event.__enter__()
        _stack.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        self.event.__exit__(*exc)
        _stack.pop()
        dt = t1 - self.t0
        for outer in _stack:  # every span it ran in: time under its name
            outer.within[self.name] = outer.within.get(self.name, 0.0) + dt
        _timer.add(self.name, dt, self.within)
        return False


def span(name: str):
    """A named span around a ``with`` body: off (no profiler session
    active) a shared no-op; on, a range on the profiler's timeline and its
    time in the registry's totals."""
    if not _profiling():
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: each call of the function is a :func:`span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiling():
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, k: int = 1) -> None:
    """Adds ``k`` to counter ``name`` (always on)."""
    _counts[name] = _counts.get(name, 0) + k


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    return dict(_counts)


KERNELS = ("k1", "k2", "k3", "k4", "k5", "k6", "k7")


def launches() -> Dict[str, int]:
    """Each kernel's CUDA launches (not its plain version's): the
    counters ``k1.launches`` … ``k7.launches``, keyed ``k1`` … ``k7``."""
    return {k: _counts.get(f"{k}.launches", 0) for k in KERNELS}


def set_counters(values: Dict[str, int]) -> None:
    """Sets the named counters (e.g. back to a :func:`counters` copy, to
    leave out launches that are not part of the path being counted)."""
    _counts.update(values)


def summary() -> Dict[str, Dict]:
    """Per span name since the last :func:`reset`: ``calls``, ``total_s``
    and ``within_s`` (seconds of each span name that ran inside it, at any
    depth)."""
    return _timer.totals()


def reset() -> None:
    """Clears the span totals and the counters."""
    global _timer
    _timer = PhaseTimer()
    _counts.clear()


def _merge(intervals) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def span_table(events: list, names: Iterable[str], device_traced: bool = True) -> Dict:
    """Per span name in ``names``, from one session's Chrome-trace events:
    ``calls``, ``total_s``, ``self_s`` (its intervals less those of the
    spans that ran directly inside it) and ``idle_s``, the seconds of its
    self intervals in which no kernel, copy or memset ran on the card (None
    unless ``device_traced``). Host ranges and device intervals share the
    trace's clock (µs)."""
    names = set(names)
    busy = _merge((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    starts = [a for a, _ in busy]
    before = list(itertools.accumulate((b - a for a, b in busy), initial=0.0))

    def busy_until(x):  # device-busy µs before x
        i = bisect.bisect_right(starts, x)
        return before[i - 1] + min(x, busy[i - 1][1]) - busy[i - 1][0] if i else 0.0

    by_tid: Dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name") in names and e.get("cat") not in DEVICE_CATS:
            by_tid.setdefault((e.get("pid"), e.get("tid")), []).append(
                (e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
    out: Dict[str, Dict] = {}
    for spans in by_tid.values():
        spans.sort(key=lambda s: (s[0], -s[1]))
        kids: List[List] = [[] for _ in spans]
        open_: List[int] = []
        for i, (a, b, _) in enumerate(spans):
            while open_ and spans[open_[-1]][1] <= a:
                open_.pop()
            if open_:
                kids[open_[-1]].append((a, b))
            open_.append(i)
        for (a, b, name), inner in zip(spans, kids):
            gaps, t = [], a
            for ca, cb in inner:
                gaps.append((t, ca))
                t = cb
            gaps.append((t, b))
            own = sum(y - x for x, y in gaps)
            idle = sum((y - x) - (busy_until(y) - busy_until(x)) for x, y in gaps)
            row = out.setdefault(name, {"calls": 0, "total_s": 0.0, "self_s": 0.0,
                                        "idle_s": 0.0 if device_traced else None})
            row["calls"] += 1
            row["total_s"] += (b - a) * 1e-6
            row["self_s"] += own * 1e-6
            if device_traced:
                row["idle_s"] += idle * 1e-6
    return out


class PhaseTimer:
    """Accumulating wall-clock phase timer; the span registry's per-name
    accumulator.

    >>> pt = PhaseTimer()
    >>> with pt.phase("initialize"): ...
    >>> pt.summary()  # {"initialize": {"calls": 1, "total_sec": ...}}
    """

    def __init__(self):
        # name -> [calls, total s, max s, {inner name: s}]
        self._acc: Dict[str, list] = {}

    def add(self, name: str, dt: float,
            within: Optional[Dict[str, float]] = None) -> None:
        """One call of ``name`` that took ``dt`` seconds, with ``within``
        seconds of other names inside it."""
        slot = self._acc.get(name)
        if slot is None:
            slot = self._acc[name] = [0, 0.0, 0.0, {}]
        slot[0] += 1
        slot[1] += dt
        if dt > slot[2]:
            slot[2] = dt
        if within:
            acc = slot[3]
            for k, v in within.items():
                acc[k] = acc.get(k, 0.0) + v

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "calls": int(v[0]),
                "total_sec": round(v[1], 6),
                "max_sec": round(v[2], 6),
            }
            for k, v in self._acc.items()
        }

    def totals(self) -> Dict[str, Dict]:
        """Unrounded, with inner seconds (:func:`summary`'s form)."""
        return {
            k: {"calls": int(v[0]), "total_s": v[1], "within_s": dict(v[3])}
            for k, v in self._acc.items()
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=1)


# the registry (module state: one per process)
_timer = PhaseTimer()
_counts: Dict[str, int] = {}
_stack: List[_Span] = []
_span_names: set = set()
