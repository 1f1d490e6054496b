"""Port parity: RGD as the engine's and the fused runner's block solver.

JAX's engine solves each block update with one preconditioned
``rgd_solve`` step when ``solver = RGD``; the port runs each update as one
launch of K2's RGD variant (``fused_rtr.rtr_run_fused``, one step, on the
robot's or colour class's window; its plain version here on the CPU) and
the fused runner as one launch per stretch. Inputs are shared as numpy:
YLift is carried from the JAX engine, the Uniform rule takes JAX's
``randint(fold_in(key, it))`` schedule. Tolerance rel 1e-9 (fp64, sum
order only) on the cost and rel-change histories and the final X; the GNC
runs stop two steps after their last weight round, as the GNC parity tests
do (later, a weight at its threshold separates the fp64 trajectories).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_ros_tpu.models import local_solvers as j_ls
from dpgo_ros_tpu.models.problem import LiftedProblem as JaxProblem
from dpgo_ros_tpu.ops import quadratic as j_quad
from dpgo_ros_tpu.parallel.rbcd import RBCDEngine as JaxEngine
from dpgo_ros_tpu.utils.config import (
    AgentConfig,
    InitMethod,
    RobustCostType,
    SolverMethod,
    UpdateRule,
)
from dpgo_ros_tpu_torch.io.synthetic import generate_world
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import fused_rtr
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from torch_parity import port_config, rel_err, world

TOL = 1e-9
STEPS = 24


def _cfg(**kw):
    base = dict(
        num_robots=3, update_rule=UpdateRule.ROUND_ROBIN,
        local_initialization_method=InitMethod.CHORDAL, solver=SolverMethod.RGD,
        RGD_stepsize=0.2, relative_change_tolerance=0.0,
        max_iteration_number=STEPS, dtype="float64", seed=7,
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
    js0 = je.initialize()
    te = RBCDEngine(tp, port_config(cfg))
    return je, js0, te, te.initialize(ylift=np.asarray(je.Ylift))


def _count_k2_calls(monkeypatch):
    """Calls of K2's wrapper (on the CPU it runs the plain version, so the
    kernel's launch counter cannot count them)."""
    calls = []
    real = fused_rtr.rtr_run_fused

    def spy(*args, **kw):
        calls.append(kw["it_cap"] - kw["it0"])
        return real(*args, **kw)

    monkeypatch.setattr(fused_rtr, "rtr_run_fused", spy)
    return calls


ENGINE_CASES = {
    "roundrobin": {},
    "uniform": dict(update_rule=UpdateRule.UNIFORM),
    "parallel": dict(update_rule=UpdateRule.PARALLEL),
    "accelerated": dict(acceleration=True, restart_interval=7),
    # the plain masked Riemannian gradient diverges at 0.2 (notes of the
    # async tests): a stepsize of the unpreconditioned regime
    "no-preconditioner": dict(RGD_use_preconditioner=False, RGD_stepsize=1e-5),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_rgd_engine_matches_jax(problems, monkeypatch, case):
    cfg = _cfg(**ENGINE_CASES[case])
    je, js0, te, ts0 = _engines(problems, cfg)
    js, jinfo = je.run(js0, max_iters=STEPS)
    calls = _count_k2_calls(monkeypatch)
    ts, tinfo = te.run(ts0, max_iters=STEPS, schedule=_jax_schedule(cfg, STEPS))
    assert tinfo["iterations"] == jinfo["iterations"] == STEPS
    jh, th = jinfo["history"], tinfo["history"]
    assert rel_err(th["cost"], jh["cost"]) < TOL
    assert rel_err(th["rel_change"], jh["rel_change"]) < TOL
    assert rel_err(np.stack(th["rel_change_robots"]),
                   np.stack(jh["rel_change_robots"])) < TOL
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) < TOL
    assert tinfo["final_cost"] == pytest.approx(float(js.cost), rel=TOL)
    assert th["cost"][-1] < th["cost"][0]
    # one K2 launch of one step per update, one more per restart; no tCG
    assert calls == [1] * (STEPS + tinfo["restarts"])
    assert tinfo["tcg_iterations"] == 0


def test_rgd_gnc_engine_matches_jax(outlier_problems, monkeypatch):
    """GNC_TLS with a reset after the first round: each round refreshes P⁻¹
    and the next RGD launches take the new weights."""
    cfg = _cfg(robust_cost_type=RobustCostType.GNC_TLS, GNC_schedule="geometric",
               robust_opt_num_weight_updates=2, robust_opt_inner_iters_per_robot=3,
               robust_opt_num_resets=1)
    cap = 20  # two steps after the second round (iteration 18)
    je, js0, te, ts0 = _engines(outlier_problems, cfg)
    js, jinfo = je.run(js0, max_iters=cap)
    calls = _count_k2_calls(monkeypatch)
    ts, tinfo = te.run(ts0, max_iters=cap)
    assert tinfo["history"]["event"] == jinfo["history"]["event"] == [
        (9, "UPDATE_WEIGHT"), (18, "UPDATE_WEIGHT")]
    assert rel_err(tinfo["history"]["cost"], jinfo["history"]["cost"]) < TOL
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) < TOL
    assert np.max(np.abs(ts.weights.numpy() - np.asarray(js.weights))) < TOL
    assert tinfo["gnc_stats"] == jinfo["gnc_stats"]
    assert len(calls) == cap


FUSED_CASES = {
    "roundrobin": ({}, STEPS),
    "uniform": (dict(update_rule=UpdateRule.UNIFORM), STEPS),
    "parallel": (dict(update_rule=UpdateRule.PARALLEL), STEPS),
    "no-preconditioner": (dict(RGD_use_preconditioner=False, RGD_stepsize=1e-5), STEPS),
    # two steps after the second round, at iteration 18
    "gnc": (dict(robust_cost_type=RobustCostType.GNC_TLS, GNC_schedule="geometric",
                 robust_opt_num_weight_updates=2,
                 robust_opt_inner_iters_per_robot=3), 20),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_rgd_fused_runner_matches_jax(problems, outlier_problems, monkeypatch, case):
    kw, cap = FUSED_CASES[case]
    cfg = _cfg(**kw)
    gnc = cfg.robust_cost_type != RobustCostType.L2
    je, js0, te, ts0 = _engines(outlier_problems if gnc else problems, cfg)
    js = je.make_fused_run(cap)(js0)
    calls = _count_k2_calls(monkeypatch)
    ts = te.make_fused_run(cap, schedule=_jax_schedule(cfg, cap))(ts0)
    assert ts.iteration == int(js.iteration) == cap
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) < TOL
    assert float(ts.cost) == pytest.approx(float(js.cost), rel=TOL)
    assert rel_err(ts.rel_change.numpy(), np.asarray(js.rel_change)) < TOL
    # one K2 launch for an L2 run, one per stretch between weight rounds
    assert calls == ([cap, cap - 9, cap - 18] if gnc else [cap])
    if gnc:
        assert ts.weight_update_count == int(js.weight_update_count) == 2
        assert np.max(np.abs(ts.weights.numpy() - np.asarray(js.weights))) < TOL


def test_rgd_fused_runner_matches_engine(problems):
    """The fused runner's RGD steps are the engine loop's (both plain
    here): the same X, cost and rel change after the same updates."""
    _, tp = problems
    eng = RBCDEngine(tp, port_config(_cfg()))
    st0 = eng.initialize(ylift=np.eye(5, 3))
    s_e, info = eng.run(st0, max_iters=STEPS)
    s_f, tcg = eng.make_fused_run(STEPS, return_stats=True)(st0)
    assert rel_err(s_f.X.numpy(), s_e.X.numpy()) < 1e-12
    assert float(s_f.cost) == pytest.approx(info["final_cost"], rel=1e-12)
    assert tcg == STEPS  # K2 counts one per RGD step


def test_identity_pinv_is_jax_unpreconditioned_step(problems):
    """K2 takes a preconditioner only; the engine hands it identities for
    ``RGD_use_preconditioner = False``. Its plain version with those
    identities is JAX's ``rgd_step`` without the preconditioner (fp64, to
    1e-12): for a tangent direction g, proj(X, g·I) = g."""
    jp, tp = problems
    cfg = _cfg(RGD_use_preconditioner=False, RGD_stepsize=1e-3)
    eng = RBCDEngine(tp, port_config(cfg))
    Pinv = eng._solver_cache(tp.edges)
    assert torch.equal(Pinv, torch.eye(4, dtype=torch.float64).expand(tp.n, 4, 4))
    X = np.array(JaxEngine(jp, cfg).initialize().X)  # on the manifold
    for robot in range(tp.num_robots):
        mask = np.asarray(eng._masks[robot].numpy())
        Xj = np.asarray(j_ls.rgd_step(
            jnp.asarray(X), jp.edges, jnp.asarray(mask), None,
            j_ls.RGDParams(stepsize=1e-3, use_preconditioner=False)))
        Xt, stats = eng._local_solve(torch.as_tensor(X), tp.edges, eng._masks[robot],
                                     Pinv, robot=robot,
                                     cost=float(j_quad.cost(jnp.asarray(X), jp.edges)))
        assert np.max(np.abs(Xt.numpy() - Xj)) < 1e-12
        assert not np.array_equal(Xt.numpy(), X)
        assert float(stats[fused_rtr.RUN_COST]) == pytest.approx(
            float(j_quad.cost(jnp.asarray(Xj), jp.edges)), rel=1e-12)


def test_k2_recheck_after_in_place_edit(problems):
    """K2's wrapper checks a bank against its windows once and skips the
    read on the next launch with the same tensors; an in-place write to the
    bank makes it check again."""
    _, tp = problems
    eng = RBCDEngine(tp, port_config(_cfg()))
    st = eng.initialize(ylift=np.eye(5, 3))
    bank = eng._bank.clone()
    kw = dict(adj=eng._adjf, rel0=eng._rel_zero, it0=0, last_wu=0, gnc_pending=False,
              cost0=st.cost, it_cap=1, tol=0.0, gnc=False, inner=1, inner_tol=None,
              rgd_stepsize=0.2, offsets=eng._offsets, windows=eng._row_windows)
    Pinv = eng._solver_cache(tp.edges)
    sched = eng._row_sched[0]
    fused_rtr.rtr_run_fused(st.X, bank, sched, Pinv, tp.edges, eng.rtr_params, **kw)
    fused_rtr.rtr_run_fused(st.X, bank, sched, Pinv, tp.edges, eng.rtr_params, **kw)
    bank[0, :3] = 1 - bank[0, :3]  # row 0's block no longer its window's
    with pytest.raises(ValueError, match="bank rows"):
        fused_rtr.rtr_run_fused(st.X, bank, sched, Pinv, tp.edges, eng.rtr_params, **kw)
    with pytest.raises(ValueError, match="outside the mask bank"):
        fused_rtr.rtr_run_fused(st.X, eng._bank, torch.tensor([7], dtype=torch.int32),
                                Pinv, tp.edges, eng.rtr_params, **kw)

