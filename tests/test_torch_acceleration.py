"""Port parity: Nesterov-accelerated RBCD and the ``max_pose`` metric
against the JAX engine and fused runner (fp64 XLA path).

The port's engine solves each accelerated block on K4's window (plain
version) or, for Parallel, K1's; JAX solves full-width. YLift is carried
from the JAX engine into ``initialize(ylift=...)`` and the Uniform rule
takes JAX's ``randint(fold_in(key, it))`` schedule, so both compute the
same thing. Tolerance rel 1e-9 on the cost and per-robot rel-change
histories, X and V (fp64, different sum orders only): the adaptive
restarts must fire at the same steps for that to hold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_ros_tpu.models.problem import LiftedProblem as JaxProblem
from dpgo_ros_tpu.parallel.rbcd import RBCDEngine as JaxEngine
from dpgo_ros_tpu.utils.config import (
    AgentConfig,
    InitMethod,
    RobustCostType,
    UpdateRule,
)
from dpgo_ros_tpu_torch.io.synthetic import generate_world
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from torch_parity import port_config, rel_err, world

TOL = 1e-9
STEPS = 30
SEED = 7


def _cfg(**kw):
    base = dict(
        num_robots=3, update_rule=UpdateRule.ROUND_ROBIN,
        local_initialization_method=InitMethod.CHORDAL, acceleration=True,
        relative_change_tolerance=0.0, max_iteration_number=STEPS,
        RTR_gradnorm_tol=0.5, dtype="float64", seed=SEED,
    )
    base.update(kw)
    return AgentConfig(**base)


def _jax_schedule(cfg, upto: int):
    if cfg.update_rule != UpdateRule.UNIFORM:
        return None
    key0 = jax.random.PRNGKey(cfg.seed)
    return [int(jax.random.randint(jax.random.fold_in(key0, i), (), 0, cfg.num_robots))
            for i in range(upto)]


@pytest.fixture(scope="module")
def problems():
    data, _ = world("sphere256")
    return (JaxProblem.from_data(data, r=5, dtype=jnp.float64),
            LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu"))


@pytest.fixture(scope="module")
def outlier_problems():
    data, _, _ = generate_world("sphere", n=256, num_robots=3, seed=0, outlier_ratio=0.2)
    return (JaxProblem.from_data(data, r=5, dtype=jnp.float64),
            LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu"))


def _engines(problems, cfg):
    jp, tp = problems
    je = JaxEngine(jp, cfg)
    te = RBCDEngine(tp, port_config(cfg))
    js0 = je.initialize()
    return je, js0, te, te.initialize(ylift=np.asarray(je.Ylift))


def _assert_states_match(ts, js):
    for field in ("X", "V", "X_prev"):
        assert rel_err(getattr(ts, field).numpy(), np.asarray(getattr(js, field))) < TOL, field
    assert float(ts.theta) == pytest.approx(float(js.theta), rel=TOL)
    assert ts.iteration == int(js.iteration)


ENGINE_CASES = {
    # a restart_interval that fires (steps 7, 14, ...) on top of the safeguard
    "roundrobin": dict(restart_interval=7),
    "uniform": dict(update_rule=UpdateRule.UNIFORM),
    "parallel": dict(update_rule=UpdateRule.PARALLEL),
    "no-safeguard": dict(acceleration_safeguard=False),
    "theta-sequence": dict(acceleration_beta=None),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_accelerated_engine_matches_jax(problems, case):
    cfg = _cfg(**ENGINE_CASES[case])
    je, js0, te, ts0 = _engines(problems, cfg)
    js, jinfo = je.run(js0, max_iters=STEPS)
    ts, tinfo = te.run(ts0, max_iters=STEPS, schedule=_jax_schedule(cfg, STEPS))
    assert tinfo["iterations"] == jinfo["iterations"] == STEPS
    jh, th = jinfo["history"], tinfo["history"]
    assert rel_err(th["cost"], jh["cost"]) < TOL
    assert rel_err(th["rel_change"], jh["rel_change"]) < TOL
    assert rel_err(np.stack(th["rel_change_robots"]),
                   np.stack(jh["rel_change_robots"])) < TOL
    _assert_states_match(ts, js)
    assert tinfo["final_cost"] == pytest.approx(float(js.cost), rel=TOL)
    assert th["cost"][-1] < th["cost"][0]
    # the safeguard restarts where the extrapolated step would raise the cost
    if cfg.acceleration_safeguard:
        assert tinfo["restarts"] > 0
        assert tinfo["tcg_iterations"] > 0
    else:
        assert tinfo["restarts"] == 0


def test_accelerated_gnc_engine_matches_jax(outlier_problems):
    """GNC_TLS + acceleration with a reset after the first weight round:
    every round and reset drops the momentum (θ = 1, V = X_prev = X).
    Compared up to the step after the last round: on this world the second
    step after it separates the two fp64 runs by ~1e-6 in X with or without
    acceleration (ROADMAP Queue 3: a stopping test at its threshold, the
    weights still within ~1e-13)."""
    cfg = _cfg(robust_cost_type=RobustCostType.GNC_TLS, robust_opt_num_weight_updates=2,
               robust_opt_inner_iters_per_robot=3, robust_opt_num_resets=1)
    cap = 2 * 9 + 1  # rounds fire before iterations 9 and 18
    je, js0, te, ts0 = _engines(outlier_problems, cfg)
    js, jinfo = je.run(js0, max_iters=cap)
    ts, tinfo = te.run(ts0, max_iters=cap)
    assert [i for i, _ in tinfo["history"]["event"]] == [
        i for i, _ in jinfo["history"]["event"]] == [9, 18]
    assert rel_err(tinfo["history"]["cost"], jinfo["history"]["cost"]) < TOL
    assert rel_err(ts.weights.numpy(), np.asarray(js.weights)) < TOL
    _assert_states_match(ts, js)
    assert tinfo["restarts"] > 0


FUSED_CASES = {
    "roundrobin": dict(restart_interval=7),
    "parallel": dict(update_rule=UpdateRule.PARALLEL),
    "uniform-max-pose": dict(update_rule=UpdateRule.UNIFORM,
                             relative_change_metric="max_pose",
                             relative_change_tolerance=0.05, max_iteration_number=60),
    "gnc-reset": dict(robust_cost_type=RobustCostType.GNC_TLS,
                      robust_opt_num_weight_updates=1,
                      robust_opt_inner_iters_per_robot=3, robust_opt_num_resets=1,
                      max_iteration_number=11),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_accelerated_fused_runner_matches_jax(problems, outlier_problems, case):
    """JAX's accelerated make_fused_run (a device while-loop of per-step
    solves) against the port's host loop, ``record=True``: the same exit,
    state, rel-change history and weight-round events."""
    cfg = _cfg(**FUSED_CASES[case])
    cap = cfg.max_iteration_number
    probs = outlier_problems if case == "gnc-reset" else problems
    je, js0, te, ts0 = _engines(probs, cfg)
    js, jrel, jev = je.make_fused_run(cap, record=True)(js0)
    run = te.make_fused_run(cap, record=True, schedule=_jax_schedule(cfg, cap))
    ts, trel, tev = run(ts0)
    assert ts.iteration == int(js.iteration)
    if case == "uniform-max-pose":
        assert ts.iteration < cap  # stopped on the max_pose tolerance
    else:
        assert ts.iteration == cap
    assert rel_err(trel.numpy(), np.asarray(jrel)) < TOL
    np.testing.assert_array_equal(tev.numpy(), np.asarray(jev))
    assert float(ts.cost) == pytest.approx(float(js.cost), rel=TOL)
    _assert_states_match(ts, js)
    assert set(run.last_stats) == {"tcg_iterations", "restarts"}
    if case == "gnc-reset":
        assert tev.numpy().tolist().count(1) == 1
    # without record, the same final state
    plain = te.make_fused_run(cap, schedule=_jax_schedule(cfg, cap))(ts0)
    assert torch.equal(plain.X, ts.X)


def test_max_pose_engine_matches_jax(problems):
    """The ``max_pose`` rel-change metric (largest per-pose update norm per
    robot) without acceleration: the run stops on it at JAX's iteration."""
    cfg = _cfg(acceleration=False, relative_change_metric="max_pose",
               relative_change_tolerance=0.05, max_iteration_number=60)
    je, js0, te, ts0 = _engines(problems, cfg)
    js, jinfo = je.run(js0)
    ts, tinfo = te.run(ts0)
    assert tinfo["iterations"] == jinfo["iterations"] < 60
    assert tinfo["converged"] and jinfo["converged"]
    jh, th = jinfo["history"], tinfo["history"]
    assert rel_err(np.stack(th["rel_change_robots"]),
                   np.stack(jh["rel_change_robots"])) < 1e-7
    assert rel_err(th["rel_change"], jh["rel_change"]) < 1e-7
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) < 1e-7
    # the block-Frobenius metric stops elsewhere on the same run
    fro = RBCDEngine(problems[1], port_config(_cfg(
        acceleration=False, relative_change_tolerance=0.05, max_iteration_number=60)))
    _, finfo = fro.run(fro.initialize(ylift=np.asarray(je.Ylift)))
    assert finfo["iterations"] != tinfo["iterations"]


def test_accelerated_fused_runner_refuses_return_stats(problems):
    eng = RBCDEngine(problems[1], port_config(_cfg()))
    with pytest.raises(ValueError):
        eng.make_fused_run(4, return_stats=True)
    with pytest.raises(ValueError):
        RBCDEngine(problems[1], port_config(_cfg(relative_change_metric="max")))
