"""The accelerated plain reference (``references/nesterov.py``) is the
program's accelerated RBCD in float64: on a small world on the CPU, the
same updates restart, X and V agree to 1e-9 and the solve stops after the
same update, for a fixed β and for the θ-sequence; it refuses what it does
not run, and the comparison fails its TF32 control and a program whose
accelerated step goes wrong, run through the harness on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import compare, harness, reference, world
from benchmark.tests.conftest import ROOT, small, small_run

CELL = "dpgo_accel_demo.warm"
CASES = {
    "beta_0.3": dict(acceleration_beta=0.3),
    "theta_sequence": dict(acceleration_beta=None),
    "theta_sequence_reset_every_7": dict(acceleration_beta=None, restart_interval=7),
    # unguarded, this world's solve runs to its budget
    "no_safeguard_40_updates": dict(acceleration_beta=0.3, acceleration_safeguard=False,
                                    max_iteration_number=40),
}


@pytest.fixture(scope="module")
def plain():
    return harness.plugin("references", "nesterov")


def config(**solver):
    c = harness.Cell.load(harness.load_json(ROOT / "BENCHMARK.json"), CELL, False)
    w, s = small(CELL)
    return dict(c.config, world=dict(c.config["world"], **w),
                solver=dict(c.config["solver"], **s, **solver)), c.limits


def rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_is_the_programs_accelerated_algorithm_in_float64(plain, case):
    cfg, _ = config(**CASES[case])
    g = world.generate_world(**cfg["world"], seed=7)
    Y = plain.lifting_matrix(7, 5, 3)
    ref = plain.solve(g, cfg["solver"], Y)
    prog = harness.Program(dict(cfg, solver=dict(cfg["solver"], dtype="float64")), g,
                           torch.device("cpu"))
    eng = prog.build(g)
    st, info = eng.run(eng.initialize(ylift=torch.as_tensor(Y, dtype=torch.float64)))
    assert info["iterations"] == ref["iterations"]
    assert info["history"]["restarted"] == ref["restarted"]
    assert info["restarts"] == sum(ref["restarted"])
    if cfg["solver"]["acceleration_safeguard"]:  # restarts, then a stop on the tolerance
        assert info["restarts"] > 0
        assert info["iterations"] < int(cfg["solver"]["max_iteration_number"])
    assert rel(st.X.numpy(), ref["X"]) <= 1e-9
    assert rel(st.V.numpy(), ref["V"]) <= 1e-9
    assert abs(info["final_cost"] - ref["cost"]) <= 1e-9 * ref["cost"]
    T, _ = eng.finalize(st)
    assert np.max(np.abs(T - ref["T"])) <= 1e-6
    # the stop: the reference's rule replayed on the program's own record
    rule = plain.Schedule(cfg["solver"], len(g["num_poses"]))
    assert rule.gaps(info["history"]["rel_change_robots"], [], info["iterations"]) == 0


@pytest.mark.parametrize("change", [
    dict(acceleration=False), dict(update_rule="Parallel"), dict(update_rule="Uniform"),
    dict(robust_cost_type="GNC_TLS"), dict(solver="RGD"), dict(asynchronous=True),
    dict(relative_change_metric="max_pose")])
def test_reference_refuses_what_it_does_not_run(plain, change):
    cfg, _ = config(**change)
    g = world.generate_world(**cfg["world"], seed=7)
    with pytest.raises(ValueError):
        plain.solve(g, cfg["solver"], plain.lifting_matrix(7, 5, 3))
    with pytest.raises(ValueError):
        plain.Schedule(cfg["solver"], 5)


def test_schedule_is_the_l2_stop_rule(plain):
    cfg, _ = config()
    with pytest.raises(ValueError):  # the plain reference's own rule refuses acceleration
        reference.Schedule(cfg["solver"], 2)
    rule = plain.Schedule(dict(cfg["solver"], max_iteration_number=6), 2)
    calm, busy = np.array([0.1, 0.1]), np.array([0.1, 0.5])
    assert rule.gaps([busy, busy, calm], [], 3) == 0
    assert rule.gaps([busy, busy, calm], [], 2) == 1  # stopped before the rule
    assert rule.gaps([busy, busy, calm, calm], [], 4) == 1  # ran on past it
    assert rule.gaps([busy, calm], [1], 2) == 1  # a weight round the rule never makes
    assert rule.gaps([busy] * 6, [], 6) == 0  # the budget


def test_comparison_rejects_the_control(plain):
    cfg, limits = config()
    g = world.generate_world(**cfg["world"], seed=3)
    Y = plain.lifting_matrix(3, 5, 3)
    ref = plain.solve(g, cfg["solver"], Y)
    checks, failed = compare.compare([dict(ref, graph=0)], [], {0: ref}, [g], cfg, limits,
                                     plain)
    assert failed == 0
    ctl = plain.solve(g, cfg["solver"], Y, control=True)
    st = dict(ctl, index=0, graph=0)
    checks, failed = compare.compare([dict(ctl, graph=0)], [st], {0: ref}, [g], cfg, limits,
                                     plain)
    assert failed == 1
    assert any(c["value"] > c["limit"] for c in checks.values())


# the accelerated step gone wrong, planted where the engine takes its
# configuration: the plain step, no extrapolation, no restart
STEP_FAULTS = {"acceleration_off": dict(acceleration=False),
               "beta_zero": dict(acceleration_beta=0.0),
               "restart_never_taken": dict(acceleration_safeguard=False)}


@pytest.mark.parametrize("fault", sorted(STEP_FAULTS))
def test_a_fault_of_the_accelerated_step_makes_the_run_incorrect(manifest, monkeypatch,
                                                                 fault):
    from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine

    real = RBCDEngine.__init__

    def init(self, problem, config):
        real(self, problem, dataclasses.replace(config, **STEP_FAULTS[fault]))

    monkeypatch.setattr(RBCDEngine, "__init__", init)
    out = small_run(manifest, CELL)
    assert out["correct"] is False and out["failed"] >= 1, out["checks"]
    assert out["checks"]["traj"]["value"] > out["checks"]["traj"]["limit"]
