"""The accelerated step's spans (``parallel/rbcd.py::_accelerated_update``,
``utils/profiling.py``) and the benchmark's readers of them.

1. Off (no profiler session): an accelerated solve opens no range event,
   reads no span clock and leaves the span registry empty.
2. Under a CPU profiler session, engine and fused runners: one
   ``rbcd.extrapolate`` and one ``rbcd.safeguard`` per update, inside
   ``rbcd.step``, the safeguard holding no read and no solve;
   ``rbcd.restart`` calls equal ``info["restarts"]`` and
   ``sum(history["restarted"])``; the restart's second solve and read lie
   inside its span. Without the safeguard: no safeguard or restart span.
3. The benchmark's readers of these spans on summaries built by hand, and
   None on an empty registry or a program without one; the engine loop's
   readers and these on the registry of a real accelerated solve.
"""

import dataclasses
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dpgo_ros_tpu_torch.io.synthetic import generate_world
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import hbm_rtr
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu_torch.utils import profiling
from dpgo_ros_tpu_torch.utils.config import AgentConfig, InitMethod, UpdateRule

ROOT = Path(__file__).resolve().parents[1]
ACCEL_SPANS = ("rbcd.extrapolate", "rbcd.safeguard", "rbcd.restart")
# the spans of an accelerated step and the spans each may run directly in
PARENTS = {
    "rbcd.step": {"rbcd.run", "rbcd.fused_run"},
    "rbcd.extrapolate": {"rbcd.step"},
    "rbcd.safeguard": {"rbcd.step"},
    "rbcd.restart": {"rbcd.step"},
    "rbcd.read": {"rbcd.restart", "rbcd.step", "rbcd.run", "rbcd.fused_run"},
    "k4.launch": {"rbcd.step", "rbcd.restart"},
    "k4.windows": {"rbcd.step", "rbcd.fused_prepare"},
    "rbcd.run": {None},
    "rbcd.fused_run": {None},
    "rbcd.fused_prepare": {None},
}


@pytest.fixture(autouse=True)
def clean_registry():
    profiling.reset()
    yield
    profiling.reset()


def _engine(**kw) -> RBCDEngine:
    data, _, _ = generate_world("sphere", n=90, num_robots=3, seed=3)
    prob = LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu")
    cfg = AgentConfig(num_robots=3, update_rule=UpdateRule.ROUND_ROBIN,
                      local_initialization_method=InitMethod.CHORDAL,
                      relative_change_tolerance=0.0, max_iteration_number=15,
                      RTR_gradnorm_tol=0.5, dtype="float64", acceleration=True,
                      acceleration_beta=0.9, restart_interval=4)
    return RBCDEngine(prob, dataclasses.replace(cfg, **kw))


def _trace_parents(events):
    """(name, innermost enclosing span's name or None) of every span of
    ``PARENTS`` in a Chrome trace, from the intervals alone."""
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("ph") == "X" and e.get("name") in PARENTS),
                   key=lambda s: (s[0], -s[1]))
    out, open_ = [], []
    for a, b, name in spans:
        while open_ and open_[-1][1] <= a:
            open_.pop()
        out.append((name, open_[-1][2] if open_ else None))
        open_.append((a, b, name))
    return out


def _run(eng, mode):
    """(updates, restarts, per-update restarted flags or None) of one solve."""
    st = eng.initialize()
    if mode == "engine":
        st, info = eng.run(st)
        return info["iterations"], info["restarts"], info["history"]["restarted"]
    runner = eng.make_fused_run(eng.config.max_iteration_number)
    st = runner(st)
    return st.iteration, runner.last_stats["restarts"], None


@pytest.mark.parametrize("mode", ["engine", "fused"])
def test_off_records_no_span(monkeypatch, mode):
    def refuse(*_a, **_k):
        raise AssertionError("an off span opened a range event or read its clock")

    monkeypatch.setattr(profiling, "_RangeEvent", refuse)
    monkeypatch.setattr(profiling, "_clock", refuse)
    updates, restarts, _ = _run(_engine(), mode)
    assert profiling.summary() == {}
    assert updates == 15 and restarts > 0


@pytest.mark.parametrize("mode", ["engine", "fused"])
def test_spans_of_the_accelerated_step(mode):
    eng = _engine()
    k4, solves = hbm_rtr.rtr_solve_hbm, []

    def k4_counted(*a, **k):
        solves.append(1)
        return k4(*a, **k)

    hbm_rtr.rtr_solve_hbm = k4_counted
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            updates, restarts, flags = _run(eng, mode)
    finally:
        hbm_rtr.rtr_solve_hbm = k4
    s = profiling.summary()
    assert updates == 15 and restarts > 0
    assert s["rbcd.step"]["calls"] == s["rbcd.extrapolate"]["calls"] == updates
    assert s["rbcd.safeguard"]["calls"] == updates
    assert s["rbcd.restart"]["calls"] == restarts
    if flags is not None:
        assert sum(flags) == restarts and len(flags) == updates
    assert len(solves) == updates + restarts
    assert s["k4.launch"]["calls"] == updates + restarts
    step = s["rbcd.step"]["within_s"]
    for name in ACCEL_SPANS:
        assert 0.0 < step[name] <= s["rbcd.step"]["total_s"]
    # each restart's second solve and its read lie inside its span
    inner = s["rbcd.restart"]["within_s"]
    assert inner["k4.launch"] > 0 and inner["rbcd.read"] > 0
    # the safeguard launches the cost and the flag; the read that carries it is the step's
    assert not {"rbcd.read", "k4.launch"} & set(s["rbcd.safeguard"]["within_s"])
    assert step["rbcd.read"] > 0
    pairs = _trace_parents(profiling.chrome_events(prof))
    for name, parent in pairs:
        assert parent in PARENTS[name], (name, parent)
    for name in ACCEL_SPANS:
        assert sum(n == name for n, _ in pairs) == s[name]["calls"]


def test_without_the_safeguard_no_restart_span():
    eng = _engine(acceleration_safeguard=False, max_iteration_number=9)
    with profile(activities=[ProfilerActivity.CPU]):
        updates, restarts, flags = _run(eng, "engine")
    s = profiling.summary()
    assert updates == 9 and restarts == 0 and flags == [False] * updates
    assert s["rbcd.extrapolate"]["calls"] == updates
    assert "rbcd.safeguard" not in s and "rbcd.restart" not in s


def test_plain_run_flags_no_restart_and_opens_no_accelerated_span():
    eng = _engine(acceleration=False, max_iteration_number=6)
    with profile(activities=[ProfilerActivity.CPU]):
        updates, restarts, flags = _run(eng, "engine")
    assert flags == [False] * updates and restarts == 0
    assert not set(ACCEL_SPANS) & set(profiling.summary())


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _row(calls, total, within=None):
    return {"calls": calls, "total_s": total, "within_s": within or {}}


HAND = {
    "rbcd.step": _row(80, 0.200, {"rbcd.extrapolate": 0.024, "rbcd.safeguard": 0.040,
                                  "rbcd.restart": 0.030, "rbcd.read": 0.050}),
    "rbcd.extrapolate": _row(80, 0.024),
    "rbcd.safeguard": _row(80, 0.040),
    "rbcd.restart": _row(16, 0.030, {"rbcd.read": 0.020}),
}
READS = {
    "extrapolate_us_per_update": 0.024 / 80 * 1e6,
    "safeguard_us_per_update": 0.040 / 80 * 1e6,
    "restarts_per_update": 16 / 80,
}


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_arithmetic(monkeypatch, name):
    run = SimpleNamespace(cell=SimpleNamespace(traffic={"runner": "engine"}))
    read = _reader(name)
    monkeypatch.setattr(profiling, "summary", lambda: HAND)
    assert read(run) == pytest.approx(READS[name])
    monkeypatch.setattr(profiling, "summary", lambda: {})
    assert read(run) is None
    # a plain run's registry: steps, none of the accelerated spans
    monkeypatch.setattr(profiling, "summary", lambda: {"rbcd.step": _row(80, 0.2)})
    assert read(run) is None


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_is_silent_without_the_registry(monkeypatch, name):
    run = SimpleNamespace(cell=SimpleNamespace(traffic={"runner": "engine"}))
    monkeypatch.delattr(profiling, "summary")  # a program without the registry
    assert _reader(name)(run) is None


def test_no_restart_reads_zero(monkeypatch):
    hand = {k: v for k, v in HAND.items() if k != "rbcd.restart"}
    monkeypatch.setattr(profiling, "summary", lambda: hand)
    run = SimpleNamespace(cell=SimpleNamespace(traffic={"runner": "engine"}))
    assert _reader("restarts_per_update")(run) == 0.0


@pytest.fixture(scope="module")
def accelerated():
    """(span registry, updates, restarts) of one accelerated engine solve
    under a CPU profiler session."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        updates, restarts, _ = _run(_engine(), "engine")
    s = profiling.summary()
    profiling.reset()
    return s, updates, restarts


# the engine loop's readers, which the accelerated cell reports beside its own
ENGINE_READERS = ("loop_host_us_per_update", "read_wait_us_per_update", "k4_launch_us")


@pytest.mark.parametrize("name", ENGINE_READERS + tuple(sorted(READS)))
def test_readers_read_an_accelerated_solve(monkeypatch, accelerated, name):
    s, updates, restarts = accelerated
    monkeypatch.setattr(profiling, "summary", lambda: s)
    run = SimpleNamespace(cell=SimpleNamespace(traffic={"runner": "engine"}))
    v = _reader(name)(run)
    assert v is not None and v > 0
    if name == "restarts_per_update":
        assert v == restarts / updates
