"""Port parity: robust costs and GNC-TLS against the JAX package.

1. ``models/robust.py``, every function against its JAX counterpart on the
   same random residuals (fp64, rel 1e-12), including the three μ
   schedules, the five IRLS costs and the all-NaN percentile fallback.
2. The robust engine (fp64) against the JAX XLA engine on sphere256 with
   20 % planted outliers, YLift carried across: the same weight rounds at
   the same iterations, weights and final cost within 1e-7, equal
   ``gnc_stats`` and identical accept/reject sets after ``finalize``; on
   the fixed cadence, on ``robust_opt_inner_tol`` and with one reset.
3. GNC_TLS local initialization against JAX (fp64, 1e-8).
4. The two repairs: the initial ``fixed_mask`` frees the loop closures
   under robust costs, and a reset re-initializes with the engine's current
   YLift.
5. The port's two runners (``make_fused_run`` and ``run``) agree on CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_ros_tpu.io.synthetic import generate_world
from dpgo_ros_tpu.models import robust as j_robust
from dpgo_ros_tpu.models.problem import LiftedProblem as JaxProblem
from dpgo_ros_tpu.parallel.rbcd import RBCDEngine as JaxEngine
from dpgo_ros_tpu.utils.config import (
    AgentConfig,
    InitMethod,
    RobustCostType,
    UpdateRule,
)
from dpgo_ros_tpu_torch.models import robust
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import stiefel
from dpgo_ros_tpu_torch.parallel import rbcd
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine, state_to_numpy
from torch_parity import port_config, rel_err

TOL = 1e-7


# ------------------------------------------------------------ robust.py


def _residuals(seed=0, n=200):
    rng = np.random.default_rng(seed)
    r = np.abs(rng.standard_normal(n)) * 4.0
    loop = (rng.uniform(size=n) < 0.6).astype(np.float64)
    return r, loop


def _cfg_ns(schedule, K=3):
    return AgentConfig(GNC_schedule=schedule, robust_opt_num_weight_updates=K,
                       GNC_barc=3.0)


def _pair(case):
    """(port value, JAX value) of one robust.py function on one input."""
    r, loop = _residuals()
    tr, tl = torch.as_tensor(r), torch.as_tensor(loop)
    if case == "residuals":
        data, _, _ = generate_world("sphere", n=60, num_robots=1, seed=5,
                                    outlier_ratio=0.3)
        rng = np.random.default_rng(1)
        T = np.stack([np.concatenate([np.linalg.qr(rng.standard_normal((3, 3)))[0],
                                      rng.standard_normal((3, 1))], 1)
                      for _ in range(60)])
        jp = JaxProblem.from_data(data, r=3, dtype=jnp.float64)
        tp = LiftedProblem.from_data(data, r=3, dtype=torch.float64, device="cpu")
        return (robust.measurement_residuals(torch.as_tensor(T), tp.edges),
                j_robust.measurement_residuals(jnp.asarray(T), jp.edges))
    if case == "gnc_tls":
        return (torch.stack([robust.gnc_tls_weights(tr, torch.tensor(mu, dtype=torch.float64), 3.0)
                             for mu in (1e-3, 0.3, 3.0, 1e3)]),
                np.stack([j_robust.gnc_tls_weights(jnp.asarray(r), mu, 3.0)
                          for mu in (1e-3, 0.3, 3.0, 1e3)]))
    if case in ("L2", "L1", "Huber", "TLS", "GM"):
        return (robust.robust_weight(case, tr, 3.0),
                j_robust.robust_weight(case, jnp.asarray(r), 3.0))
    if case.startswith(("mu_", "round_")):
        fn_t, fn_j = ((robust.mu_for_round, j_robust.mu_for_round)
                      if case.startswith("mu_") else
                      (robust.gnc_round_params, j_robust.gnc_round_params))
        schedule = case.split("_", 1)[1]
        if schedule == "all_nan":  # no loop closure selected
            schedule, tl, loop = "adaptive", tl * 0, loop * 0
        cfg = _cfg_ns(schedule)
        out_t, out_j = [], []
        for k in range(3):
            kw_t = dict(residuals=tr, loop_mask=tl, dtype=torch.float64)
            kw_j = dict(residuals=jnp.asarray(r), loop_mask=jnp.asarray(loop),
                        dtype=jnp.float64)
            vt = fn_t(k, cfg, torch.tensor(2e-3, dtype=torch.float64), **kw_t)
            vj = fn_j(k, cfg, 2e-3, **kw_j)
            vt, vj = (vt if isinstance(vt, tuple) else (vt,)), (
                vj if isinstance(vj, tuple) else (vj,))
            out_t.append(torch.stack([torch.as_tensor(v, dtype=torch.float64)
                                      .reshape(()) for v in vt]))
            out_j.append(np.array([float(v) for v in vj]))
        return torch.stack(out_t), np.stack(out_j)
    if case == "update":
        fixed = (np.arange(r.size) % 3 == 0).astype(np.float64)
        w0 = np.linspace(0, 1, r.size)
        wt, mut = robust.update_weights_gnc(torch.as_tensor(w0), torch.as_tensor(fixed),
                                            tr, torch.tensor(0.7, dtype=torch.float64), 3.0, 1.4)
        wj, muj = j_robust.update_weights_gnc(jnp.asarray(w0), jnp.asarray(fixed),
                                              jnp.asarray(r), 0.7, 3.0, 1.4)
        return torch.cat([wt, mut.reshape(1)]), np.append(np.asarray(wj), muj)
    if case == "classify":
        w = np.clip(np.round(np.random.default_rng(2).uniform(-0.5, 1.5, r.size), 1), 0, 1)
        mask = (np.arange(r.size) % 7 != 0).astype(np.float64)
        return (torch.tensor(robust.classify_weights(torch.as_tensor(w), tl,
                                                     torch.as_tensor(mask)), dtype=torch.float64),
                np.array([int(v) for v in j_robust.classify_weights(
                    jnp.asarray(w), jnp.asarray(loop), jnp.asarray(mask))], np.float64))
    raise ValueError(case)


ROBUST_CASES = [
    "residuals", "gnc_tls", "L2", "L1", "Huber", "TLS", "GM",
    "mu_reference", "mu_geometric", "mu_adaptive", "mu_all_nan",
    "round_reference", "round_geometric", "round_adaptive", "round_all_nan",
    "update", "classify",
]


@pytest.mark.parametrize("case", ROBUST_CASES)
def test_robust_matches_jax(case):
    t, j = _pair(case)
    t, j = t.numpy(), np.asarray(j, np.float64)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=1e-12, atol=1e-14)


def test_nanquantile_matches_nanpercentile():
    r, loop = _residuals(seed=3, n=57)
    masked = np.where(loop > 0, r, np.nan)
    for x in (masked, np.full(9, np.nan), r[:1]):
        t = torch.nanquantile(torch.as_tensor(x), 0.9)
        j = jnp.nanpercentile(jnp.asarray(x), 90.0)
        np.testing.assert_array_equal(np.isnan(t.numpy()), np.isnan(np.asarray(j)))
        np.testing.assert_allclose(np.nan_to_num(t.numpy(), nan=-1.0),
                                   np.nan_to_num(np.asarray(j), nan=-1.0), rtol=1e-12)


# ------------------------------------------------------------ engine


def _world():
    data, _, planted = generate_world("sphere", n=256, num_robots=3, seed=0,
                                      outlier_ratio=0.2)
    return data, planted


@pytest.fixture(scope="module")
def problems():
    data, planted = _world()
    return (JaxProblem.from_data(data, r=5, dtype=jnp.float64),
            LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu"), planted)


def _cfg(**kw):
    base = dict(
        num_robots=3, update_rule=UpdateRule.ROUND_ROBIN,
        local_initialization_method=InitMethod.CHORDAL,
        robust_cost_type=RobustCostType.GNC_TLS,
        robust_opt_num_weight_updates=2, robust_opt_inner_iters_per_robot=3,
        relative_change_tolerance=0.1, RTR_gradnorm_tol=0.5, dtype="float64",
        use_fused_kernel=False,
    )
    base.update(kw)
    return AgentConfig(**base)


# name -> (config, iteration cap of the run). The inner_tol and reset runs
# stop two steps after their last round: later, a trust-region or tCG
# stopping test that sits at its threshold separates the two fp64
# trajectories by ~1e-8..1e-6 in cost (numerics, not semantics: the
# weights still agree to ~1e-13).
SCHEDULES = {
    "cadence": ({}, None),
    "inner_tol": (dict(robust_opt_inner_tol=5.0), 15),
    "reset": (dict(robust_opt_num_resets=1), 20),
}


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_robust_engine_matches_jax_fp64(problems, schedule):
    jp, tp, _ = problems
    kw, cap = SCHEDULES[schedule]
    cfg = _cfg(**kw)
    je = JaxEngine(jp, cfg)
    js, jinfo = je.run(je.initialize(), max_iters=cap)
    te = RBCDEngine(tp, port_config(cfg))
    ts, tinfo = te.run(te.initialize(ylift=np.asarray(je.Ylift)), max_iters=cap)
    assert tinfo["iterations"] == jinfo["iterations"]
    assert tinfo["history"]["event"] == jinfo["history"]["event"]
    assert len(tinfo["history"]["event"]) == 2
    if schedule == "inner_tol":  # the tolerance fired before the cadence
        assert tinfo["history"]["event"][0][0] < 9
    assert ts.weight_update_count == int(js.weight_update_count) == 2
    assert rel_err(tinfo["history"]["cost"], jinfo["history"]["cost"]) < TOL
    assert np.max(np.abs(ts.weights.numpy() - np.asarray(js.weights))) < TOL
    assert tinfo["final_cost"] == pytest.approx(jinfo["final_cost"], rel=TOL)
    assert tinfo["gnc_stats"] == jinfo["gnc_stats"]
    assert tinfo["gnc_converged"] == jinfo["gnc_converged"]
    Tt, ft = te.finalize(ts)
    Tj, fj = je.finalize(js)
    assert rel_err(Tt, np.asarray(Tj)) < TOL
    np.testing.assert_array_equal(ft.weights.numpy() > 0.5, np.asarray(fj.weights) > 0.5)


@pytest.mark.parametrize("rtype", [RobustCostType.HUBER, RobustCostType.GM])
def test_irls_engine_matches_jax_fp64(problems, rtype):
    jp, tp, _ = problems
    cfg = _cfg(robust_cost_type=rtype, max_iteration_number=14)
    je = JaxEngine(jp, cfg)
    js, jinfo = je.run(je.initialize())
    te = RBCDEngine(tp, port_config(cfg))
    ts, tinfo = te.run(te.initialize(ylift=np.asarray(je.Ylift)))
    assert tinfo["history"]["event"] == jinfo["history"]["event"]
    assert np.max(np.abs(ts.weights.numpy() - np.asarray(js.weights))) < TOL
    assert tinfo["final_cost"] == pytest.approx(jinfo["final_cost"], rel=TOL)


def test_gnc_tls_local_init_matches_jax_fp64():
    data, _, planted = generate_world("sphere", n=200, num_robots=1, seed=4,
                                      outlier_ratio=0.25)
    assert planted.any()
    cfg = AgentConfig(num_robots=1, update_rule=UpdateRule.ROUND_ROBIN,
                      local_initialization_method=InitMethod.GNC_TLS,
                      robust_cost_type=RobustCostType.GNC_TLS,
                      GNC_use_probability=False, GNC_barc=3.0, dtype="float64")
    je = JaxEngine(JaxProblem.from_data(data, r=5, dtype=jnp.float64), cfg)
    js = je.initialize()
    tp = LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu")
    te = RBCDEngine(tp, port_config(cfg))
    ts = te.initialize(ylift=np.asarray(je.Ylift))
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) < 1e-8
    chordal = RBCDEngine(tp, port_config(AgentConfig(
        num_robots=1, update_rule=UpdateRule.ROUND_ROBIN,
        local_initialization_method=InitMethod.CHORDAL,
        robust_cost_type=RobustCostType.GNC_TLS, dtype="float64",
    ))).initialize(ylift=np.asarray(je.Ylift))
    assert rel_err(ts.X.numpy(), chordal.X.numpy()) > 1e-3  # truncation acted


def test_initial_state_matches_jax_with_free_loop_closures(problems):
    """Repair: under a robust cost the loop closures start unfrozen
    (fixed_mask = 1 − is_loop), as the JAX engine starts them."""
    jp, tp, _ = problems
    je = JaxEngine(jp, _cfg())
    js = je.initialize()
    ts = RBCDEngine(tp, port_config(_cfg())).initialize(ylift=np.asarray(je.Ylift))
    back = state_to_numpy(ts)
    for k, v in js._asdict().items():
        assert rel_err(back[k], np.asarray(v)) < TOL, k
    np.testing.assert_array_equal(back["fixed_mask"], 1.0 - tp.host_edges.is_loop)
    assert back["fixed_mask"].min() == 0.0
    l2 = RBCDEngine(tp, port_config(_cfg(robust_cost_type=RobustCostType.L2))).initialize()
    assert (l2.fixed_mask.numpy() == 1.0).all()


def test_reset_reinitializes_with_current_ylift(problems):
    """Repair: a GNC reset lifts the fresh initial trajectory through the
    engine's current YLift (here one carried in, not the seed's)."""
    _, tp, _ = problems
    eng = RBCDEngine(tp, port_config(_cfg(robust_opt_num_resets=1)))
    Y = stiefel.random_lifting_matrix(torch.Generator().manual_seed(7), 5, 3,
                                      dtype=torch.float64)
    st0 = eng.initialize(ylift=Y)
    st, _ = eng.run(st0, max_iters=4)
    st = eng._weight_update_impl(st)
    st = eng._reset(st)
    assert torch.equal(eng.Ylift, Y)
    assert torch.allclose(st.X, st0.X, rtol=0, atol=1e-12)
    assert st.weight_update_count == 1 and st.iteration == 4
    # through the run loop: the first round (it = 9) resets X to st0.X
    seen = {}
    eng.run(st0, max_iters=10,
            callback=lambda it, s: seen.setdefault(it, s.X_prev.clone()))
    assert torch.allclose(seen[10], st0.X, rtol=0, atol=1e-12)


@pytest.mark.parametrize("rule", [UpdateRule.ROUND_ROBIN, UpdateRule.PARALLEL])
@pytest.mark.parametrize("cost", ["L2", "GNC"])
def test_fused_runner_matches_engine_run(problems, monkeypatch, rule, cost):
    """The fused runner's steps are the engine loop's, full-width (its
    RoundRobin steps on windows are held to these in
    tests/test_torch_hbm_rtr.py)."""
    _, tp, _ = problems
    monkeypatch.setattr(rbcd, "SEQUENTIAL_ON_WINDOWS", False)
    kw = dict(update_rule=rule, robust_opt_num_resets=1)
    if cost == "L2":
        kw.update(robust_cost_type=RobustCostType.L2, max_iteration_number=40)
    cfg = _cfg(**kw)
    eng = RBCDEngine(tp, port_config(cfg))
    st0 = eng.initialize()
    st_r, info = eng.run(st0)
    st_f, rel_h, ev_h, tcg = eng.make_fused_run(
        eng.config.max_iteration_number, record=True, return_stats=True)(st0)
    assert st_f.iteration == info["iterations"]
    assert float(st_f.cost) == pytest.approx(info["final_cost"], rel=1e-9)
    assert tcg == info["tcg_iterations"]
    assert st_f.weight_update_count == st_r.weight_update_count
    assert [(int(i), "UPDATE_WEIGHT") for i in np.flatnonzero(ev_h.numpy())] == (
        info["history"]["event"])
    np.testing.assert_allclose(
        rel_h[:st_f.iteration].numpy(), np.stack(info["history"]["rel_change_robots"]),
        rtol=1e-9)
    assert torch.isnan(rel_h[st_f.iteration:]).all()
    assert torch.allclose(st_f.weights, st_r.weights, rtol=0, atol=1e-9)
