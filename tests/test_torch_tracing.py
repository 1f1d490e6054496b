"""The port's spans and counters (``utils/profiling.py``) on the engine path.

1. Off (no profiler session): a solve opens no range event, reads no span
   clock and leaves the span registry empty.
2. Under a CPU profiler session, on small engine and fused solves
   (RoundRobin and GNC): each span the path runs lands in the Chrome trace,
   nested as the layers nest; ``rbcd.step`` calls equal the updates,
   ``k4.launch`` calls the K4 wrapper calls, ``rbcd.weight_round`` calls
   the weight rounds, ``rbcd.read`` calls in an engine run one per update
   and per restarted accelerated step plus the opening and closing reads;
   self time never exceeds total time.
3. The chordal CG's counters: ``host_syncs`` = ⌈steps / CHECK_EVERY⌉, plus
   one where the test stopped it early.
4. The span table of ``--profile_dir`` (self and idle seconds) by hand, and
   the CLI writing it.
5. The benchmark's readers of the registry on summaries built by hand, and
   None on an empty registry.
6. On the card: ``k4.launch`` calls equal ``k4.launches``; K4's launch
   record gives a fresh launch's bits across weight changes.
"""

import dataclasses
import importlib.util
import json
import math
import os
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dpgo_ros_tpu_torch import cli
from dpgo_ros_tpu_torch.io.synthetic import generate_world
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import chordal
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu_torch.utils import profiling
from dpgo_ros_tpu_torch.utils.config import AgentConfig, InitMethod, RobustCostType, UpdateRule

ROOT = Path(__file__).resolve().parents[1]

# every span the engine path opens, and the spans each may run directly in
# (None: a root, the request)
PARENTS = {
    "rbcd.initialize": {None, "rbcd.weight_round", "rbcd.run"},
    "chordal.cg": {"rbcd.initialize"},
    "rbcd.run": {None},
    "rbcd.step": {"rbcd.run", "rbcd.fused_run"},
    "rbcd.read": {"rbcd.step", "rbcd.run", "rbcd.fused_run"},
    "k4.launch": {"rbcd.step"},
    "k4.windows": {"rbcd.step", "rbcd.fused_prepare"},
    "rbcd.weight_round": {"rbcd.run", "rbcd.fused_run"},
    "rbcd.fused_prepare": {None},
    "rbcd.fused_run": {None},
    "rbcd.finalize": {None},
}


@pytest.fixture(autouse=True)
def clean_registry():
    profiling.reset()
    yield
    profiling.reset()


def _engine(robust: bool, **kw) -> RBCDEngine:
    data, _, _ = generate_world("sphere", n=90, num_robots=3, seed=3,
                                outlier_ratio=0.2 if robust else 0.0)
    prob = LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu")
    cfg = AgentConfig(num_robots=3, update_rule=UpdateRule.ROUND_ROBIN,
                      local_initialization_method=InitMethod.CHORDAL,
                      relative_change_tolerance=0.0, max_iteration_number=12,
                      RTR_gradnorm_tol=0.5, dtype="float64")
    if robust:
        cfg = dataclasses.replace(cfg, robust_cost_type=RobustCostType.GNC_TLS,
                                  robust_opt_num_weight_updates=3,
                                  robust_opt_inner_iters_per_robot=1,
                                  robust_opt_num_resets=1)
    return RBCDEngine(prob, dataclasses.replace(cfg, **kw))


def _solve(eng: RBCDEngine, mode: str):
    """initialize → run (or the fused runner) → finalize; returns the
    info of the run (the fused runner's: its iterations)."""
    st = eng.initialize()
    if mode == "engine":
        st, info = eng.run(st)
    else:
        st = eng.make_fused_run(eng.config.max_iteration_number)(st)
        info = {"iterations": st.iteration, "history": {"event": []}}
    eng.finalize(st)
    return info


def _trace_parents(events):
    """(name, name of the innermost span containing it or None) of every
    span in a Chrome trace, from the intervals alone."""
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


def _no_range_events(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("an off span opened a range event or read its clock")

    monkeypatch.setattr(profiling, "_RangeEvent", refuse)
    monkeypatch.setattr(profiling, "_clock", refuse)
    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


@pytest.mark.parametrize("mode", ["engine", "fused"])
@pytest.mark.parametrize("robust", [False, True], ids=["l2", "gnc"])
def test_off_opens_nothing_and_records_nothing(monkeypatch, mode, robust):
    _no_range_events(monkeypatch)
    info = _solve(_engine(robust), mode)
    assert info["iterations"] > 0
    assert profiling.summary() == {}


def test_off_accelerated_and_chordal_record_nothing(monkeypatch):
    _no_range_events(monkeypatch)
    _solve(_engine(False, acceleration=True), "engine")
    assert profiling.summary() == {}
    counts = profiling.counters()
    assert counts["chordal.cg_steps"] > 0 and counts["chordal.host_syncs"] > 0


@pytest.mark.parametrize("mode", ["engine", "fused"])
@pytest.mark.parametrize("robust", [False, True], ids=["l2", "gnc"])
def test_spans_on_the_engine_path(mode, robust):
    eng = _engine(robust)
    calls = {"k4": 0, "rounds": 0}
    from dpgo_ros_tpu_torch.ops import hbm_rtr

    k4, update = hbm_rtr.rtr_solve_hbm, eng._weight_update_impl

    def k4_counted(*a, **k):
        calls["k4"] += 1
        return k4(*a, **k)

    def update_counted(st):
        calls["rounds"] += 1
        return update(st)

    eng._weight_update_impl = update_counted
    hbm_rtr.rtr_solve_hbm = k4_counted
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            info = _solve(eng, mode)
    finally:
        hbm_rtr.rtr_solve_hbm = k4
    events = profiling.chrome_events(prof)
    pairs = _trace_parents(events)
    for name, parent in pairs:
        assert parent in PARENTS[name], (name, parent)
    seen = {name for name, _ in pairs}
    expect = {"rbcd.initialize", "chordal.cg", "rbcd.read", "rbcd.finalize", "k4.windows"}
    expect |= ({"rbcd.run", "rbcd.step", "k4.launch"} if mode == "engine"
               else {"rbcd.fused_prepare", "rbcd.fused_run"})
    if robust:
        expect.add("rbcd.weight_round")
    assert seen == expect

    s = profiling.summary()
    table = profiling.span_table(events, PARENTS, device_traced=False)
    assert set(s) == set(table) == seen
    for name, row in s.items():
        assert row["calls"] == table[name]["calls"] == sum(n == name for n, _ in pairs)
        assert 0.0 <= table[name]["self_s"] <= table[name]["total_s"]
    if robust:
        assert s["rbcd.weight_round"]["calls"] == calls["rounds"] > 0
    if mode == "engine":
        updates = info["iterations"]
        assert s["rbcd.step"]["calls"] == updates > 0
        assert s["k4.launch"]["calls"] == calls["k4"] == updates
        assert profiling.launches()["k4"] == 0  # CPU tensors: the plain version
        rounds = sum(ev == "UPDATE_WEIGHT" for _, ev in info["history"]["event"])
        assert s.get("rbcd.weight_round", {}).get("calls", 0) == rounds
        # one read per update, the opening read of the rel changes, the
        # closing read of the final cost and counts
        assert s["rbcd.read"]["calls"] == updates + 2
        step = s["rbcd.step"]
        assert step["within_s"]["rbcd.read"] <= step["total_s"]


def test_reads_of_an_accelerated_run_count_its_restarts():
    eng = _engine(False, acceleration=True, acceleration_beta=0.9,
                  max_iteration_number=15)
    st = eng.initialize()
    with profile(activities=[ProfilerActivity.CPU]):
        st, info = eng.run(st)
    s = profiling.summary()
    assert info["restarts"] > 0
    assert s["rbcd.step"]["calls"] == info["iterations"]
    assert s["rbcd.read"]["calls"] == info["iterations"] + info["restarts"] + 2
    assert s["k4.launch"]["calls"] == info["iterations"] + info["restarts"]


def test_accelerated_fused_runner_spans():
    eng = _engine(True, acceleration=True)
    st = eng.initialize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner = eng.make_fused_run(eng.config.max_iteration_number)
        st = runner(st)
    s = profiling.summary()
    assert s["rbcd.fused_prepare"]["calls"] == s["rbcd.fused_run"]["calls"] == 1
    assert s["rbcd.step"]["calls"] == st.iteration
    assert s["rbcd.weight_round"]["calls"] == st.weight_update_count
    assert (s["rbcd.read"]["calls"]
            == st.iteration + runner.last_stats["restarts"] + 1)
    for name, parent in _trace_parents(profiling.chrome_events(prof)):
        assert parent in PARENTS[name], (name, parent)


def _spd(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    M = torch.randn(n, n, generator=g, dtype=torch.float64)
    return M @ M.T + n * torch.eye(n, dtype=torch.float64)


@pytest.mark.parametrize("n,max_iters,tol,early", [
    (60, 40, 0.0, False),   # runs every step: no early stop
    (60, 7, 0.0, False),    # fewer steps than one check period
    (12, 500, 1e-8, True),  # converges, stopped at a check
    (12, 500, 1e30, True),  # stopped at the first check, no step
])
def test_chordal_cg_counters(n, max_iters, tol, early):
    A = _spd(n)
    b = torch.ones(n, dtype=torch.float64)
    chordal._cg(lambda x: A @ x, b, torch.zeros_like(b), max_iters, tol)
    c = profiling.counters()
    steps, syncs = c.get("chordal.cg_steps", 0), c["chordal.host_syncs"]
    assert steps <= max_iters and (steps == max_iters) != early
    assert syncs == math.ceil(steps / chordal.CHECK_EVERY) + int(early)


def test_chordal_init_counts_each_cg_solve():
    eng = _engine(False)
    with profile(activities=[ProfilerActivity.CPU]):
        eng.initialize()
    c, s = profiling.counters(), profiling.summary()
    # each solve syncs ⌈steps / CHECK_EVERY⌉ times, plus one if stopped early
    solves = s["chordal.cg"]["calls"]
    assert solves >= eng.problem.num_robots
    syncs, steps = c["chordal.host_syncs"], c["chordal.cg_steps"]
    assert solves <= syncs <= steps / chordal.CHECK_EVERY + 2 * solves


def test_span_table_by_hand():
    x = lambda name, ts, dur, cat="cpu_op": {"ph": "X", "cat": cat, "name": name,
                                             "ts": ts, "dur": dur, "pid": 1, "tid": 1}
    events = [
        x("rbcd.step", 0, 100), x("rbcd.read", 60, 30), x("k4.launch", 10, 20),
        x("rbcd.step", 200, 50),
        x("rtr_window_kernel", 20, 50, "kernel"), x("memcpy", 85, 10, "gpu_memcpy"),
        x("aten::add", 0, 300),
    ]
    t = profiling.span_table(events, {"rbcd.step", "rbcd.read", "k4.launch"})
    step, read, k4 = t["rbcd.step"], t["rbcd.read"], t["k4.launch"]
    assert step["calls"] == 2 and read["calls"] == k4["calls"] == 1
    assert step["total_s"] == pytest.approx(150e-6)
    assert step["self_s"] == pytest.approx((100 - 30 - 20 + 50) * 1e-6)
    # step's self intervals [0,10) [30,60) [90,100) [200,250): busy 30..60, 90..95
    assert step["idle_s"] == pytest.approx((10 + 0 + 5 + 50) * 1e-6)
    assert read["idle_s"] == pytest.approx((10 + 5) * 1e-6)   # busy 60..70, 85..90
    assert k4["idle_s"] == pytest.approx(10e-6)                # busy 20..30
    host = profiling.span_table(events, {"rbcd.step"}, device_traced=False)
    assert host["rbcd.step"]["idle_s"] is None


def test_profile_dir_writes_the_span_table(tmp_path):
    flags = ["--synthetic", "grid3d", "--synthetic_n", "64", "--num_robots", "2",
             "--update_rule", "RoundRobin", "--max_iteration_number", "6",
             "--relative_change_tolerance", "0", "--device", "cpu",
             "--local_initialization_method", "Chordal", "--profile_dir", str(tmp_path)]
    summary, extras = cli.run(flags)
    table = json.loads((tmp_path / f"spans_{os.getpid()}.json").read_text())
    assert table["rbcd.step"]["calls"] == summary["iterations"] == 6
    assert {"rbcd.initialize", "chordal.cg", "rbcd.run", "rbcd.read", "k4.launch",
            "k4.windows", "rbcd.finalize"} <= set(table)
    for row in table.values():
        assert row["self_s"] <= row["total_s"] + 1e-9 and row["idle_s"] is None
    # the CPU: no kernel launch, no CG, no κ_eff (the plain version computes
    # its own); K4's launch records, one per robot, are built on both devices
    assert extras["timing_sec"]["counters"] == {"k4.records": 2}


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _row(calls, total, within=None):
    return {"calls": calls, "total_s": total, "within_s": within or {}}


HAND = {
    "rbcd.step": _row(100, 0.130, {"rbcd.read": 0.075, "k4.windows": 0.010,
                                   "k4.launch": 0.008}),
    "k4.launch": _row(100, 0.008),
    "k4.windows": _row(2, 0.010),
    "rbcd.weight_round": _row(4, 0.100),
    "rbcd.fused_prepare": _row(5, 0.002),
    "rbcd.fused_run": _row(5, 0.450, {"rbcd.read": 0.440}),
}
READS = {
    "loop_host_us_per_update": ("engine", (0.130 - 0.075 - 0.010) / 100 * 1e6),
    "read_wait_us_per_update": ("engine", 0.075 / 100 * 1e6),
    "k4_launch_us": ("engine", 0.008 / 100 * 1e6),
    "weight_round_ms": ("engine", 0.100 / 4 * 1e3),
    "windows_ms": ("engine", 0.010 / 2 * 1e3),
    "fused_host_ms_per_solve": ("fused", (0.002 + 0.450 - 0.440) / 5 * 1e3),
}


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_arithmetic(monkeypatch, name):
    runner, want = READS[name]
    run = SimpleNamespace(cell=SimpleNamespace(traffic={"runner": runner}))
    read = _reader(name)
    monkeypatch.setattr(profiling, "summary", lambda: HAND)
    assert read(run) == pytest.approx(want)
    monkeypatch.setattr(profiling, "summary", lambda: {})
    assert read(run) is None


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_is_silent_without_the_registry(monkeypatch, name):
    runner, _ = READS[name]
    run = SimpleNamespace(cell=SimpleNamespace(traffic={"runner": runner}))
    monkeypatch.delattr(profiling, "summary")  # a program without the registry
    assert _reader(name)(run) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run these tests on the card)")


@pytest.mark.cuda
def test_k4_launch_spans_equal_k4_launches_on_the_card(card):
    data, _, _ = generate_world("sphere", n=600, num_robots=3, seed=3)
    prob = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device="cuda")
    eng = RBCDEngine(prob, AgentConfig(num_robots=3, update_rule=UpdateRule.ROUND_ROBIN,
                                       relative_change_tolerance=0.0,
                                       max_iteration_number=9, RTR_gradnorm_tol=0.5,
                                       dtype="float32"))
    st = eng.initialize()
    before = profiling.launches()["k4"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        st, info = eng.run(st)
        torch.cuda.synchronize()
    s = profiling.summary()
    assert s["k4.launch"]["calls"] == profiling.launches()["k4"] - before == 9
    assert s["rbcd.step"]["calls"] == info["iterations"] == 9


@pytest.mark.cuda
def test_k4_record_path_equals_a_fresh_launch_on_the_card(card):
    """For every robot, across weight changes between calls (none, in place,
    a new tensor): K4's record path gives X_new and stats bit-identical to a
    launch with freshly computed operands (new windows: a new launch record
    and new κ_eff/τ_eff); ``k4.launch`` span calls equal ``k4.launches``."""
    from dpgo_ros_tpu_torch.models.local_solvers import RTRParams
    from dpgo_ros_tpu_torch.ops import hbm_rtr, quadratic

    data, _, _ = generate_world("sphere", n=600, num_robots=3, seed=3, outlier_ratio=0.2)
    prob = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device="cuda")
    eng = RBCDEngine(prob, AgentConfig(num_robots=3, dtype="float32"))
    X = eng.initialize().X
    edges = dataclasses.replace(prob.edges, weight=prob.edges.weight.clone())
    Pinv = quadratic.precond_inverse(quadratic.precond_blocks(edges, prob.n)).contiguous()
    params = RTRParams(max_iterations=3, max_tcg_iterations=50, gradnorm_tol=0.5)
    windows = hbm_rtr.prepare_windows(prob)
    for robot in range(prob.num_robots):
        hbm_rtr.rtr_solve_hbm(X, robot, Pinv, edges, params, windows)
    launches, records = profiling.launches()["k4"], profiling.counters()["k4.records"]
    solves, moved = 0, set()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for change in ("none", "in_place", "new_tensor"):
            if change == "in_place":
                edges.weight[::7] *= 0.5
            elif change == "new_tensor":
                edges = dataclasses.replace(edges, weight=edges.weight * 0.9)
            for robot in range(prob.num_robots):
                X_r, s_r = hbm_rtr.rtr_solve_hbm(X, robot, Pinv, edges, params, windows)
                fresh = hbm_rtr.prepare_windows(prob)
                X_f, s_f = hbm_rtr.rtr_solve_hbm(X, robot, Pinv, edges, params, fresh)
                assert torch.equal(X_r, X_f) and torch.equal(s_r, s_f), (change, robot)
                moved.add((robot, float(s_r[1])))
                solves += 2
        torch.cuda.synchronize()
    assert profiling.summary()["k4.launch"]["calls"] == solves
    assert profiling.launches()["k4"] - launches == solves
    assert profiling.counters()["k4.records"] - records == solves // 2  # the fresh windows'
    assert len(moved) == solves // 2  # each weight set gave each robot another solve
