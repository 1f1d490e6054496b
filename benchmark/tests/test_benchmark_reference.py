"""The comparison that decides ``correct``: the plain reference agrees with
the program where both compute in float64, and the comparison fails the
control and each fault a cell can have, run through the harness on the
CPU (the look for a card skipped)."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from benchmark import compare, harness, reference, world
from benchmark.tests.conftest import ROOT, cells, small, small_run


def config(manifest, cell):
    c = harness.Cell.load(manifest, cell, False)
    w, s = small(cell)
    return dict(c.config, world=dict(c.config["world"], **w),
                solver=dict(c.config["solver"], **s)), c.limits


@pytest.mark.parametrize("cell", ["dpgo_demo.warm", "dpgo_gnc_demo.cold"])
def test_reference_is_the_programs_algorithm_in_float64(manifest, cell):
    cfg, _ = config(manifest, cell)
    g = world.generate_world(**cfg["world"], seed=7)
    Y = reference.lifting_matrix(7, 5, 3)
    ref = reference.solve(g, cfg["solver"], Y)
    prog = harness.Program(dict(cfg, solver=dict(cfg["solver"], dtype="float64")), g,
                           torch.device("cpu"))
    eng = prog.build(g)
    st, info = eng.run(eng.initialize(ylift=torch.as_tensor(Y, dtype=torch.float64)))
    T, st = eng.finalize(st)
    assert info["iterations"] == ref["iterations"]
    assert abs(info["final_cost"] - ref["cost"]) <= 1e-8 * ref["cost"]
    assert np.max(np.abs(T - ref["T"])) <= 1e-6
    assert np.array_equal(st.weights.numpy(), ref["weights"])


def test_world_is_the_programs_generator():
    from dpgo_ros_tpu_torch.io.synthetic import generate_world

    g = world.generate_world(kind="sphere", n=300, num_robots=4, outlier_ratio=0.1, seed=11)
    data, gt, outlier = generate_world(kind="sphere", n=300, num_robots=4,
                                       outlier_ratio=0.1, seed=11)
    for f in dataclasses.fields(data.measurements):
        assert np.array_equal(getattr(data.measurements, f.name), g[f.name]), f.name
    assert np.array_equal(gt, g["ground_truth"]) and np.array_equal(outlier, g["outlier"])


def test_comparison_rejects_a_perturbed_trajectory_and_the_control(manifest):
    cfg, limits = config(manifest, "dpgo_demo.warm")
    plain = harness.reference_of(cfg)
    g = world.generate_world(**cfg["world"], seed=3)
    Y = reference.lifting_matrix(3, 5, 3)
    ref = reference.solve(g, cfg["solver"], Y)
    ok = dict(ref, graph=0)
    checks, failed = compare.compare([ok], [], {0: ref}, [g], cfg, limits, plain)
    assert failed == 0
    bad = dict(ok, T=ref["T"] + 0.1)
    checks, failed = compare.compare([bad], [], {0: ref}, [g], cfg, limits, plain)
    assert failed == 1 and checks["traj"]["value"] > limits["traj"]
    ctl = reference.solve(g, cfg["solver"], Y, control=True)
    st = dict(ctl, index=0, graph=0)
    checks, failed = compare.compare([dict(ctl, graph=0)], [st], {0: ref}, [g], cfg, limits,
                                     plain)
    assert failed == 1
    assert any(c["value"] > c["limit"] for c in checks.values())


@pytest.mark.parametrize("cell", cells())
def test_a_sound_run_is_correct(manifest, cell):
    out = small_run(manifest, cell)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert set(out["checks"]) == set(harness.Cell.load(manifest, cell, False).limits)


def _unchanged_step(monkeypatch, runner):
    """The kernel each step of the runner launches returns X unchanged."""
    mod, fn = runner.STEP.split(":")
    mod = importlib.import_module(mod)
    real = getattr(mod, fn)

    def step(X, *a, **k):
        out = real(X, *a, **k)
        return (X.clone(),) + tuple(out[1:])

    monkeypatch.setattr(mod, fn, step)


def _half_the_edges(monkeypatch, runner):
    from dpgo_ros_tpu_torch.models.problem import LiftedProblem

    real = LiftedProblem.from_data

    def from_data(*a, **k):
        prob = real(*a, **k)
        prob.edges.mask[::2] = 0.0
        return prob

    monkeypatch.setattr(LiftedProblem, "from_data", staticmethod(from_data))


def _altered_answer(monkeypatch, runner):
    """The answer the runner's ``finalize`` hands back, altered there (the
    run loads the runner anew, so the loader plants it)."""
    load = harness.runner

    def altered(name):
        mod = load(name)
        real = mod.finalize

        def finalize(eng, st):
            T, st = real(eng, st)
            T = T.copy()
            T[len(T) // 2:, :, 3] += 0.05
            return T, st

        mod.finalize = finalize
        return mod

    monkeypatch.setattr(harness, "runner", altered)


def _no_weight_rounds(monkeypatch):
    from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine

    monkeypatch.setattr(RBCDEngine, "_round_due", lambda self, *a: False)


def _stops_early(monkeypatch):
    from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine

    real = RBCDEngine._terminated
    monkeypatch.setattr(RBCDEngine, "_terminated",
                        lambda self, rel, wuc: real(self, 0.5 * rel, wuc))


def _weights_not_settled(monkeypatch):
    from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine

    real = RBCDEngine.finalize

    def finalize(self, st):
        T, st2 = real(self, st)
        return T, st2._replace(weights=st.weights)

    monkeypatch.setattr(RBCDEngine, "finalize", finalize)


FAULTS = {"step_returns_state_unchanged": _unchanged_step,
          "half_the_edges_left_out": _half_the_edges,
          "answer_altered_where_produced": _altered_answer}


def _loaded(cell):
    return harness.Cell.load(harness.load_json(ROOT / "BENCHMARK.json"), cell, False)


def _records_schedule(c):
    return c.runner.RECORDS_SCHEDULE


def _robust(c):
    return c.config["solver"].get("robust_cost_type", "L2") != "L2"


# faults of the loop's schedule, in a cell whose runner records it, and of
# the weights, in a cell whose configuration is robust
LOOP_FAULTS = {"stops_early": (_stops_early, _records_schedule),
               "no_weight_rounds": (_no_weight_rounds, _robust),
               "weights_not_settled": (_weights_not_settled, _robust)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", cells())
def test_a_fault_makes_the_run_incorrect(manifest, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch, harness.Cell.load(manifest, cell, False).runner)
    out = small_run(manifest, cell)
    assert out["correct"] is False and out["failed"] >= 1, out["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for f, (_, due) in sorted(LOOP_FAULTS.items())
                                        for c in cells() if due(_loaded(c))])
def test_a_loop_fault_makes_the_run_incorrect(manifest, monkeypatch, cell, fault):
    LOOP_FAULTS[fault][0](monkeypatch)
    out = small_run(manifest, cell)
    assert out["correct"] is False and out["failed"] >= 1, out["checks"]


def test_a_number_read_nowhere_fails_the_run(manifest, monkeypatch):
    load = harness.reference_of

    def unfollowed(config):  # a reference whose robust solve reads the start alone
        mod = load(config)
        mod.follow = lambda *a, **k: {"init": 0.0}
        return mod

    monkeypatch.setattr(harness, "reference_of", unfollowed)
    out = small_run(manifest, "dpgo_gnc_demo.cold")
    assert out["correct"] is False and out["failed"] >= 1
    assert out["checks"]["stretch"]["value"] is None


def test_the_schedule_replays_the_rule():
    cfg = {"update_rule": "RoundRobin", "robust_cost_type": "GNC_TLS",
           "GNC_schedule": "adaptive", "gnc_finalize_by_residual": True,
           "weight_convergence_threshold": -1.0, "relative_change_tolerance": 0.2,
           "robust_opt_num_weight_updates": 2, "robust_opt_inner_iters_per_robot": 2,
           "robust_opt_inner_tol": 0.15, "max_iteration_number": 1000}
    rule = reference.Schedule(cfg, 2)  # inner budget 4 updates, 10 at most
    calm, busy = np.array([0.1, 0.1]), np.array([0.1, 0.5])
    rels = [busy, calm, busy, busy, busy, busy, busy, calm, calm]
    # rounds before update 2 (all calm) and 6 (the inner budget); stop after 8
    assert rule.gaps(rels[:8], [2, 6], 8) == 0
    assert rule.gaps(rels[:8], [2], 8) == 1 and rule.gaps(rels[:8], [3, 6], 8) == 2
    assert rule.gaps(rels, [2, 6], 9) == 1 and rule.gaps(rels[:7], [2, 6], 7) == 1
    # never calm: rounds on the inner budget, stop at the budget of 10 updates
    assert rule.gaps([busy] * 10, [4, 8], 10) == 0
