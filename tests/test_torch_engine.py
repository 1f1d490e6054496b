"""Port parity: the RBCD engine against the JAX engine (fp64 XLA path).

The lifting matrix YLift is the main path's only random input; it is
carried from the JAX engine into the port's ``initialize(ylift=...)``, so
both compute the same thing. Tolerance rel 1e-7 on initial state, cost
history, per-robot relative change and the finalized trajectory.
"""

import dataclasses

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
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import fused_rtr
from dpgo_ros_tpu_torch.parallel.rbcd import (
    RBCDEngine,
    state_from_numpy,
    state_to_numpy,
)
from dpgo_ros_tpu_torch.utils import profiling
from torch_parity import port_config, rel_err, world

TOL = 1e-7
STEPS = 10


def _cfg(rule=UpdateRule.ROUND_ROBIN, init=InitMethod.CHORDAL, **kw):
    return AgentConfig(
        num_robots=3, update_rule=rule, local_initialization_method=init,
        relative_change_tolerance=0.0, max_iteration_number=STEPS,
        RTR_gradnorm_tol=0.5, dtype="float64", **kw,
    )


@pytest.fixture(scope="module")
def problems():
    data, _ = world("sphere256")
    return (
        JaxProblem.from_data(data, r=5, dtype=jnp.float64),
        LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu"),
    )


def _jax_state_np(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


@pytest.mark.parametrize("init", [InitMethod.CHORDAL, InitMethod.ODOMETRY])
def test_initialize_matches_jax(problems, init):
    jp, tp = problems
    je = JaxEngine(jp, _cfg(init=init))
    js = je.initialize()
    te = RBCDEngine(tp, port_config(_cfg(init=init)))
    ts = te.initialize(ylift=np.asarray(je.Ylift))
    assert rel_err(ts.X.numpy(), js.X) < TOL
    assert float(ts.cost) == pytest.approx(float(js.cost), rel=TOL)
    np.testing.assert_array_equal(te.robot_colors, je.robot_colors)
    assert np.isinf(ts.rel_change.numpy()).all()


@pytest.mark.parametrize("rule", [UpdateRule.ROUND_ROBIN, UpdateRule.PARALLEL])
def test_steps_and_finalize_match_jax(problems, rule):
    jp, tp = problems
    je = JaxEngine(jp, _cfg(rule))
    js, jinfo = je.run(je.initialize())
    te = RBCDEngine(tp, port_config(_cfg(rule)))
    ts, tinfo = te.run(te.initialize(ylift=np.asarray(je.Ylift)))
    assert tinfo["iterations"] == jinfo["iterations"] == STEPS
    jh, th = jinfo["history"], tinfo["history"]
    assert rel_err(th["cost"], jh["cost"]) < TOL
    assert rel_err(th["rel_change"], jh["rel_change"]) < TOL
    assert rel_err(np.stack(th["rel_change_robots"]),
                   np.stack(jh["rel_change_robots"])) < TOL
    assert th["cost"][-1] < th["cost"][0]
    Tj, _ = je.finalize(js)
    Tt, _ = te.finalize(ts)
    assert rel_err(Tt, Tj) < TOL


def test_state_carried_from_jax(problems):
    """A JAX state resumes in the port and continues identically."""
    jp, tp = problems
    je = JaxEngine(jp, _cfg())
    js, _ = je.run(je.initialize(), max_iters=4)
    te = RBCDEngine(tp, port_config(_cfg()))
    ts = state_from_numpy(_jax_state_np(js), dtype=torch.float64, device="cpu")
    assert ts.iteration == 4
    js2, jinfo = je.run(js, max_iters=3)
    ts2, tinfo = te.run(ts, max_iters=3)
    assert rel_err(tinfo["history"]["cost"], jinfo["history"]["cost"]) < TOL
    assert rel_err(ts2.X.numpy(), js2.X) < TOL
    back = state_to_numpy(ts2)
    assert set(back) == set(js2._asdict())
    assert back["iteration"] == int(js2.iteration) == 7


@pytest.mark.parametrize("use_fused_kernel", [None, False, True])
def test_every_block_update_goes_through_rtr_solve_fused(
    problems, monkeypatch, use_fused_kernel
):
    """On the CPU the engine has one solve path whatever use_fused_kernel
    says: every Parallel block update is one rtr_solve_fused call (the
    card's entry point), which runs the kernel's plain version for CPU
    tensors. RoundRobin's windowed route is tests/test_torch_hbm_rtr.py's."""
    _, tp = problems
    calls = []
    real = fused_rtr.rtr_solve_fused

    def counting(X, *args, **kw):
        calls.append(X.device.type)
        return real(X, *args, **kw)

    monkeypatch.setattr(fused_rtr, "rtr_solve_fused", counting)
    launches = profiling.launches()["k1"]
    cfg = _cfg(UpdateRule.PARALLEL, use_fused_kernel=use_fused_kernel)
    eng = RBCDEngine(tp, port_config(cfg))
    _, info = eng.run(eng.initialize(ylift=np.eye(5, 3)), max_iters=4)
    assert info["iterations"] == 4
    assert calls == ["cpu"] * 4
    assert profiling.launches()["k1"] == launches  # CPU tensors: plain version


@pytest.mark.parametrize("what", ["acceleration", "gnc", "uniform"])
def test_unported_features_raise(problems, what):
    """Acceleration, the Uniform rule and the asynchronous mode's RGD
    block solver are now ported, so their engines build and run where they
    raised before (their parity with JAX is tests/test_torch_acceleration.py's,
    test_torch_repairs.py's and test_torch_rgd.py's): a GNC engine under an
    async config (its ``initialize`` also serves the ASAPP engine, as in
    JAX) runs RGD block updates in both runners."""
    _, tp = problems
    kw = {
        "acceleration": dict(acceleration=True),
        "gnc": dict(robust_cost_type=RobustCostType.GNC_TLS, asynchronous=True),
        "uniform": dict(rule=UpdateRule.UNIFORM),
    }[what]
    if what != "gnc":
        eng = RBCDEngine(tp, port_config(_cfg(**kw)))
        st, info = eng.run(eng.initialize(ylift=np.eye(5, 3)), max_iters=2)
        assert info["iterations"] == 2
        assert info["history"]["cost"][-1] < float(eng.initialize(ylift=np.eye(5, 3)).cost)
        return
    eng = RBCDEngine(tp, port_config(_cfg(**kw)))
    st0 = eng.initialize(ylift=np.eye(5, 3))
    st, info = eng.run(st0, max_iters=2)
    assert info["iterations"] == 2 and info["tcg_iterations"] == 0
    assert info["history"]["cost"][-1] < float(st0.cost)
    st_f = eng.make_fused_run(4)(st0)
    assert st_f.iteration == 4 and float(st_f.cost) < float(st0.cost)


def test_async_config_initializes(problems):
    """Under an asynchronous config (solver resolves to RGD) the engine
    builds and ``initialize`` gives the same state as under RTR."""
    _, tp = problems
    X_async = RBCDEngine(tp, port_config(_cfg(asynchronous=True))).initialize(
        ylift=np.eye(5, 3)).X
    X_sync = RBCDEngine(tp, port_config(_cfg())).initialize(ylift=np.eye(5, 3)).X
    assert torch.equal(X_async, X_sync)


def test_config_dtype_must_match_problem(problems):
    _, tp = problems
    with pytest.raises(ValueError):
        RBCDEngine(tp, port_config(dataclasses.replace(_cfg(), dtype="float32")))
