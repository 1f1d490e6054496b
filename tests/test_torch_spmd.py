"""The spmd mesh program (``dpgo_ros_tpu_torch/parallel/spmd.py``) against
the JAX package's on the same worlds and initial states (CPU).

1. Host side: ``group_robots``, ``repartition_slots`` and
   ``ShardedProblem.build`` give JAX's arrays exactly (slots = robots, more
   slots than robots, grouped fleets).
2. Steps (fp64): 8 steps (GNC: 6, with weight rounds at steps 2 and 4)
   of the port's ``build_spmd_step`` (one process owning every slot) and
   of JAX's on the 8-device CPU mesh (XLA route), from one initial state:
   X, X_prev, V, θ, rel change, weights and μ within 1e-9 (max abs over
   max |ref|) at M ∈ {1, 3, 5}, full and
   separator-only exchange, acceleration with restarts, the GNC weight
   round under the ``reference`` and ``adaptive`` schedules with an inert
   slot, more slots than robots and more robots than slots (grouped).
   Full and separator-only exchange give the same states (1e-12).
3. The kernel route on the CPU (fp32, ``use_fused_kernel=True``): each
   slot's solve goes through K1's wrapper on its slot window
   (``hbm_rtr.prepare_slot_window``; the plain version here) and equals the
   plain route bit for bit; the windowed plain solve on a padded slot's
   window equals the full-width solve (fp64, 1e-12; padded rows and other
   slots untouched).
4. Stretches (fp32, ``use_fused_kernel=True``): RTR at M = 1, S = 4 and RGD
   at M = 4, S = 8, each through K2's wrapper (its plain version), against
   JAX's stretch with its Pallas kernel in interpret mode: X within 2e-3 of
   max |X| (fp32 over 8 and 16 steps; JAX's own M = 1 pin is 5e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dpgo_ros_tpu.io.synthetic import generate_world as j_generate_world
from dpgo_ros_tpu.models.problem import LiftedProblem as JaxProblem
from dpgo_ros_tpu.parallel import spmd as j_spmd
from dpgo_ros_tpu.parallel.rbcd import RBCDEngine as JaxEngine
from dpgo_ros_tpu.utils.config import (
    AgentConfig,
    InitMethod,
    RobustCostType,
    UpdateRule,
)
from dpgo_ros_tpu_torch.io.synthetic import generate_world
from dpgo_ros_tpu_torch.models.local_solvers import RTRParams, rtr_solve
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import fused_rtr, hbm_rtr, quadratic
from dpgo_ros_tpu_torch.parallel import multihost, spmd
from torch_parity import port_config

TOL_STEP = 1e-9  # fp64 port vs JAX XLA over 8 steps
TOL_STRETCH = 2e-3  # fp32 plain K2 vs the Pallas kernel in interpret mode


def _worlds(R, n=240, seed=3, outlier_ratio=0.0):
    kw = dict(kind="sphere", n=n, num_robots=R, seed=seed, outlier_ratio=outlier_ratio)
    return j_generate_world(**kw)[0], generate_world(**kw)[0]


def _setup(R, M, n=240, group=None, outlier_ratio=0.0, dtype=np.float64, **cfg_kw):
    """(JAX init state, JAX step, port init state, port step, port sp,
    JAX sp) of an R-robot sphere on M slots (``group``: the fleet grouped
    into that many robots first), from JAX's initial state."""
    jd, td = _worlds(R, n, outlier_ratio=outlier_ratio)
    if group is not None:
        jd, td = j_spmd.group_robots(jd, group), spmd.group_robots(td, group)
    nR = jd.num_robots
    cfg_kw.setdefault("local_initialization_method", InitMethod.CHORDAL)
    cfg = AgentConfig(num_robots=nR, update_rule=UpdateRule.PARALLEL,
                      RTR_gradnorm_tol=0.5,
                      dtype="float64" if dtype == np.float64 else "float32", **cfg_kw)
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    jprob = JaxProblem.from_data(jd, r=5, dtype=jdt)
    eng = JaxEngine(jprob, cfg)
    X0 = np.asarray(eng.initialize().X).astype(dtype)
    colors = np.asarray(eng.robot_colors)
    jsp = j_spmd.ShardedProblem.build(jprob, X0, colors, num_devices=M, dtype=dtype)
    jst, jstep = j_spmd.build_spmd_step(
        jsp, Mesh(np.array(jax.devices()[:M]), ("robots",)), cfg)
    tprob = LiftedProblem.from_data(
        td, r=5, dtype=torch.float64 if dtype == np.float64 else torch.float32,
        device="cpu")
    tsp = spmd.ShardedProblem.build(tprob, X0, colors, num_devices=M, dtype=dtype)
    tst, tstep = spmd.build_spmd_step(tsp, port_config(cfg),
                                      multihost.local_mesh(M, "cpu"))
    return jst, jstep, tst, tstep, tsp, jsp


def _err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    fin = np.isfinite(b)
    assert np.array_equal(a[~fin], b[~fin])
    return float(np.max(np.abs(a[fin] - b[fin]), initial=0.0)
                 / max(np.max(np.abs(b[fin]), initial=0.0), 1e-300))


def _assert_states(tst, jst, tol):
    for f in ("X", "X_prev", "V", "theta", "rel_change", "weights", "mu"):
        assert _err(getattr(tst, f).numpy(), getattr(jst, f)) <= tol, f
    assert tst.iteration == int(np.asarray(jst.iteration)[0, 0])
    assert tst.wuc == int(np.asarray(jst.wuc)[0, 0])


# ---------------------------------------------------------------- host side


@pytest.mark.parametrize("R,M,group", [(3, 3, None), (3, 5, None), (6, 3, 3)])
def test_sharded_problem_equals_jax(R, M, group):
    jd, td = _worlds(R)
    if group is not None:
        jd, td = j_spmd.group_robots(jd, group), spmd.group_robots(td, group)
    jprob = JaxProblem.from_data(jd, r=5, dtype=jnp.float64)
    tprob = LiftedProblem.from_data(td, r=5, dtype=torch.float64, device="cpu")
    X0 = np.random.default_rng(0).standard_normal((jprob.n, 5, 4))
    colors = np.arange(jd.num_robots, dtype=np.int32) % 2
    jsp = j_spmd.ShardedProblem.build(jprob, X0, colors, num_devices=M, dtype=np.float64)
    tsp = spmd.ShardedProblem.build(tprob, X0, colors, num_devices=M, dtype=np.float64)
    for f in dataclasses.fields(j_spmd.ShardedProblem):
        a, b = getattr(tsp, f.name), getattr(jsp, f.name)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f.name
        assert np.asarray(a).dtype == np.asarray(b).dtype, f.name


@pytest.mark.parametrize("how,k", [("group", 2), ("group", 4), ("repartition", 3),
                                   ("repartition", 7)])
def test_regrouping_equals_jax(how, k):
    jd, td = _worlds(5, n=300)
    jfn = j_spmd.group_robots if how == "group" else j_spmd.repartition_slots
    tfn = spmd.group_robots if how == "group" else spmd.repartition_slots
    jo, to = jfn(jd, k), tfn(td, k)
    assert to.num_robots == jo.num_robots == k
    np.testing.assert_array_equal(to.num_poses, jo.num_poses)
    for f in dataclasses.fields(jo.measurements):
        a = getattr(to.measurements, f.name)
        b = getattr(jo.measurements, f.name)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f.name)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f.name


# ---------------------------------------------------------------- steps

STEP_CASES = {
    "m1": dict(R=1, M=1),
    "m3-full": dict(R=3, M=3, spmd_separator_only=False),
    "m3-separators": dict(R=3, M=3, spmd_separator_only=True),
    "m5": dict(R=5, M=5),
    "accelerated": dict(R=3, M=3, acceleration=True, acceleration_beta=0.9,
                        restart_interval=5,
                        local_initialization_method=InitMethod.ODOMETRY),
    "gnc-reference": dict(R=3, M=4, outlier_ratio=0.2,
                          robust_cost_type=RobustCostType.GNC_TLS,
                          GNC_use_probability=False, GNC_barc=3.0,
                          GNC_schedule="reference"),
    "gnc-adaptive": dict(R=3, M=4, outlier_ratio=0.2,
                         robust_cost_type=RobustCostType.GNC_TLS,
                         GNC_use_probability=False, GNC_barc=3.0,
                         GNC_schedule="adaptive"),
    "more-slots": dict(R=2, M=4),
    "more-robots": dict(R=6, M=3, group=3),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_steps_match_jax(case):
    kw = dict(STEP_CASES[case])
    R, M = kw.pop("R"), kw.pop("M")
    jst, jstep, tst, tstep, _, _ = _setup(R, M, **kw)
    gnc = "robust_cost_type" in kw
    # GNC runs: two weight rounds, then one step on the second round's
    # weights; a step or two later a trust-region test sitting at its
    # threshold separates fp64 runs by ~1e-6 (ROADMAP.md, "Numerical
    # effects"), as the engine parity tests find
    for it in range(6 if gnc else 8):
        wu = int(gnc and it in (2, 4))
        jst = jstep(np.int32(it), np.int32(wu), jst)
        tst = tstep(it, wu, tst)
        _assert_states(tst, jst, TOL_STEP)
    if case == "accelerated":
        assert tstep.restarts > 0
    if gnc:
        w = tst.weights.numpy()
        assert tst.wuc == 2 and ((w > 0) & (w < 1)).any() | (w == 0).any()


def test_full_and_separator_only_exchange_agree():
    _, _, tfull, sfull, _, _ = _setup(4, 4, spmd_separator_only=False)
    _, _, tsep, ssep, _, _ = _setup(4, 4, spmd_separator_only=True)
    assert ssep.sep_only and not sfull.sep_only
    assert ssep.exchange_bytes < sfull.exchange_bytes
    for it in range(6):
        tfull, tsep = sfull(it, 0, tfull), ssep(it, 0, tsep)
    for f in ("X", "X_prev", "V", "rel_change"):
        assert _err(getattr(tsep, f).numpy(), getattr(tfull, f).numpy()) <= 1e-12, f


# ---------------------------------------------------------------- kernel route


def test_kernel_route_goes_through_k1_wrapper_on_slot_windows(monkeypatch):
    _, _, tk, sk, tsp, _ = _setup(3, 4, dtype=np.float32, use_fused_kernel=True)
    _, _, tp, spl, _, _ = _setup(3, 4, dtype=np.float32, use_fused_kernel=False)
    assert sk.use_kernel and not spl.use_kernel and sk.S == 1
    calls = []
    orig = fused_rtr.rtr_solve_fused

    def spy(X, mask, *args, windows=None, row=None, **kw):
        calls.append((windows, row))
        return orig(X, mask, *args, windows=windows, row=row, **kw)

    monkeypatch.setattr(fused_rtr, "rtr_solve_fused", spy)
    for it in range(5):
        tk, tp = sk(it, 0, tk), spl(it, 0, tp)
        torch.testing.assert_close(tk.X, tp.X, rtol=0, atol=0)
    active = sum(int(tsp.color[m]) == it % tsp.num_colors and tsp.pose_valid[m].any()
                 for it in range(5) for m in range(4))
    assert len(calls) == sk.solves == active > 0
    assert all(w is not None and row == 0 and w.num_rows == 1 for w, row in calls)


@pytest.mark.parametrize("use_fused_kernel", [None, True])
def test_float64_on_the_card_is_refused(use_fused_kernel):
    """On the card the slot solves are K1/K2 (float32 only): a float64
    program is refused there unless the caller turns the kernels off, and
    never runs the plain solve quietly. The refusal comes before any tensor
    is made, so it shows on the CPU."""
    _, _, _, _, tsp, _ = _setup(3, 3)
    cfg = port_config(AgentConfig(num_robots=3, update_rule=UpdateRule.PARALLEL,
                                  dtype="float64", use_fused_kernel=use_fused_kernel))
    card = multihost.SlotMesh(1, 0, 3, torch.device("cuda"))
    with pytest.raises(ValueError, match="float32 only"):
        spmd.build_spmd_step(tsp, cfg, card)
    spmd.build_spmd_step(tsp, cfg, multihost.local_mesh(3, "cpu"))  # the CPU runs it


def test_slot_window_solve_equals_full_width():
    """What K1 computes on a padded slot's window (the windowed plain
    version) equals the full-width masked solve; padded rows and the other
    slots' poses stay bit-identical."""
    _, _, tst, step, tsp, _ = _setup(3, 3, n=250)  # 84, 83, 83 poses
    st = step(0, 0, tst)
    m = 1
    assert tsp.pose_valid[m].sum() < tsp.n_max  # a slot with padded rows
    w = hbm_rtr.prepare_slot_window(tsp.src[m], tsp.dst[m], tsp.mask[m], m * tsp.n_max,
                                    int(tsp.pose_valid[m].sum()), step.n, "cpu")
    Xg = st.X.reshape(step.n, tsp.r, tsp.d + 1)
    e = dataclasses.replace(step._edges[m], weight=st.weights[m])
    Pinv = step._pinv(m, st.weights)
    own = step._own[m]
    Xw, stats_w = hbm_rtr.rtr_solve_window_ref(Xg, 0, Pinv, e, step.rtr, w)
    Xf, res = rtr_solve(Xg, e, own, Pinv, step.rtr)
    Xf = torch.where(own > 0, Xf, Xg)
    assert int(stats_w[fused_rtr.S_ITERS]) == res.iterations
    assert int(stats_w[fused_rtr.S_TCG]) == res.tcg_iterations
    assert _err(Xw.numpy(), Xf.numpy()) <= 1e-12
    out = own[:, 0, 0] == 0
    assert torch.equal(Xw[out], Xg[out])
    assert abs(float(stats_w[fused_rtr.S_F]) - float(res.f_opt)) <= 1e-9 * float(res.f_opt)
    # the window holds the live edges only, the block's poses first
    assert w.num_poses.tolist() == [int(tsp.pose_valid[m].sum())]
    assert int(w.edge_off[-1]) == int(tsp.mask[m].sum())


# ---------------------------------------------------------------- stretches


@pytest.mark.parametrize("R,S,launches,rgd", [(1, 4, 2, None), (4, 8, 2, 0.2)])
def test_stretch_matches_jax(R, S, launches, rgd):
    jst, jstep, tst, tstep, _, _ = _setup(
        R, R, n=160, dtype=np.float32, use_fused_kernel=True,
        spmd_steps_per_launch=S, spmd_stretch_rgd_stepsize=rgd)
    assert tstep.S == S and (tstep.stretch_rgd is not None) == (R > 1)
    calls = []
    orig = fused_rtr.rtr_run_fused

    def spy(X, bank, sched, *args, **kw):
        calls.append((bank.shape[0], sched[: kw["it_cap"]].tolist()))
        return orig(X, bank, sched, *args, **kw)

    import unittest.mock as mock

    with mock.patch.object(fused_rtr, "rtr_run_fused", spy):
        for lt in range(launches):
            jst = jstep(np.int32(lt), np.int32(0), jst)
            tst = tstep(lt, 0, tst)
    assert tst.iteration == int(np.asarray(jst.iteration)[0, 0]) == S * launches
    # one K2 call per slot per launch, one bank row, every step on it
    assert calls == [(1, [0] * S)] * (R * launches)
    assert _err(tst.X.numpy(), np.asarray(jst.X)) <= TOL_STRETCH
