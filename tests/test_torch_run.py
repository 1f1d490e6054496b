"""Port parity: the multi-step runner (K2) against the JAX package.

1. The port's ``rtr_run_fused`` on CPU tensors (its plain version) in fp32
   against the JAX Pallas kernel ``rtr_run_fused`` in interpret mode, on the
   same numpy inputs: RoundRobin and Parallel banks, GNC exits on the
   cadence and on ``inner_tol``, the RGD variant, an input that has already
   terminated, history rows. Tolerances are K1's
   (tests/test_torch_fused_rtr.py): the same exit iteration and steps, X and
   the rel row within rel 1e-3, the cost within rel 1e-4.
2. The port's ``make_fused_run`` against the JAX ``make_fused_run`` (the
   Pallas multi-step runner in interpret mode) on a GNC_TLS world with
   planted outliers: the same weight rounds at the same iterations,
   weights within 1e-4, final cost within rel 1e-3.
3. The wrapper's operand checks and its build failure.
The CUDA kernel itself runs only on the card (``python3 chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_ros_tpu.io.synthetic import generate_world
from dpgo_ros_tpu.models import local_solvers as j_ls
from dpgo_ros_tpu.models.problem import LiftedProblem as JaxProblem
from dpgo_ros_tpu.ops import fused_rtr as j_fused
from dpgo_ros_tpu.ops import quadratic as j_quad
from dpgo_ros_tpu.parallel.rbcd import RBCDEngine as JaxEngine
from dpgo_ros_tpu.utils.config import (
    AgentConfig,
    InitMethod,
    RobustCostType,
    UpdateRule,
)
from dpgo_ros_tpu_torch.models.local_solvers import RTRParams
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import fused_rtr, kernels
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu_torch.utils import profiling
from torch_parity import noisy_lifted_gt, port_config, rel_err, world

DEMO = dict(max_iterations=3, max_tcg_iterations=50, gradnorm_tol=0.5)
RELW = 128  # the JAX kernel's lane-padded rel row

# name -> (update rule, it_cap, run options)
CASES = {
    "roundrobin": (UpdateRule.ROUND_ROBIN, 6, {}),
    "parallel": (UpdateRule.PARALLEL, 6, {}),
    "gnc_cadence": (UpdateRule.ROUND_ROBIN, 6,
                    dict(gnc=True, gnc_pending=True, inner=2)),
    "gnc_inner_tol": (UpdateRule.ROUND_ROBIN, 6,
                      dict(gnc=True, gnc_pending=True, inner=12, inner_tol=1e4)),
    "rgd": (UpdateRule.ROUND_ROBIN, 4, dict(rgd_stepsize=0.2)),
    "terminated": (UpdateRule.ROUND_ROBIN, 6, dict(tol=0.1, rel0=0.05)),
}


def _jax_run(jp, X, bank, sched, Pinv, adj, rel0, cost0, it_cap, o):
    """The JAX Pallas K2 (interpret mode) on the port's operands."""
    kg = j_fused.build_kernel_graph(jp)
    R = jp.num_robots
    mrows = np.zeros((j_fused._rup(bank.shape[0], 8), kg.n_pad), np.float32)
    for i, row in enumerate(bank):
        mrows[i] = j_fused.mask_to_row_np(row[:, None, None], kg.n_pad)[0]
    adj_pad = np.zeros((RELW, RELW), np.float32)
    adj_pad[:R, :R] = adj
    rel_row = np.full((1, RELW), -1.0, np.float32)
    rel_row[0, :R] = rel0
    scal = np.zeros((1, 8), np.int32)
    scal[0, :3] = [0, 0, int(o["gnc_pending"])]
    Xt, rel, stats, hist = j_fused.rtr_run_fused(
        j_fused.to_t(jnp.asarray(X), kg.n_pad), jnp.asarray(mrows),
        j_fused.pinv_to_t(jnp.asarray(Pinv), kg.n_pad),
        kg.weight_rows(jp.edges, jp.edges.weight), kg, j_ls.RTRParams(**DEMO),
        adj_pad=jnp.asarray(adj_pad), rel0=jnp.asarray(rel_row),
        sched=jnp.asarray(sched[None]), scal=jnp.asarray(scal),
        cost0=jnp.asarray([[cost0]], jnp.float32), it_cap=it_cap, tol=o["tol"],
        gnc=o["gnc"], inner=o["inner"], inner_tol=o["inner_tol"], record=True,
        interpret=True, rgd_stepsize=o["rgd_stepsize"],
    )
    X_j = np.asarray(j_fused.from_t(Xt, jp.n, jp.r, jp.d + 1))
    return (X_j, np.asarray(rel)[0, :R], np.asarray(stats)[0, :4],
            np.asarray(hist)[:it_cap, :R])


@pytest.mark.parametrize("name", ["sphere256", "grid3d4"])
@pytest.mark.parametrize("case", list(CASES))
def test_run_cpu_matches_pallas_interpret(name, case):
    rule, it_cap, opts = CASES[case]
    o = dict(gnc=False, gnc_pending=False, inner=1, inner_tol=None, tol=0.0,
             rgd_stepsize=0.0, rel0=float("inf"))
    o.update(opts)
    data, gt = world(name)
    jp = JaxProblem.from_data(data, r=5, dtype=jnp.float32)
    tp = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device="cpu")
    eng = RBCDEngine(tp, port_config(AgentConfig(
        num_robots=tp.num_robots, update_rule=rule, dtype="float32")))
    bank, sched = eng.mask_bank_and_schedule(it_cap)
    R = tp.num_robots
    X = noisy_lifted_gt(gt, 5, seed=21).astype(np.float32)
    Pinv = np.array(j_quad.precond_inverse(j_quad.precond_blocks(jp.edges, jp.n)))
    adj = eng._adjf.numpy()
    rel0 = np.full(R, o["rel0"], np.float32)
    cost0 = float(j_quad.cost(jnp.asarray(X), jp.edges))
    X_j, rel_j, s_j, h_j = _jax_run(jp, X, bank.numpy(), sched.numpy(), Pinv,
                                    adj, rel0, cost0, it_cap, o)

    launches = profiling.launches()["k2"]
    X_t, rel_t, s_t, h_t = fused_rtr.rtr_run_fused(
        torch.as_tensor(X), bank, sched, torch.as_tensor(Pinv), tp.edges,
        RTRParams(**DEMO), adj=eng._adjf, rel0=torch.as_tensor(rel0), it0=0,
        last_wu=0, gnc_pending=o["gnc_pending"], cost0=cost0, it_cap=it_cap,
        tol=o["tol"], gnc=o["gnc"], inner=o["inner"], inner_tol=o["inner_tol"],
        record=True, rgd_stepsize=o["rgd_stepsize"], offsets=eng._offsets,
        windows=eng._row_windows,
    )
    assert profiling.launches()["k2"] == launches  # CPU tensors: plain version
    s_t = s_t.numpy()
    assert s_t.shape == (4,)
    assert int(s_t[1]) == int(s_j[1]) and int(s_t[2]) == int(s_j[2])
    assert int(s_t[3]) == int(s_j[3])
    expect_it = {"gnc_cadence": 2, "gnc_inner_tol": R, "terminated": 0}
    assert int(s_t[1]) == expect_it.get(case, it_cap)
    assert rel_err(X_t.numpy(), X_j) < 1e-3
    assert rel_err(rel_t.numpy(), rel_j) < 1e-3
    assert rel_err(h_t.numpy(), h_j) < 1e-3
    assert s_t[0] == pytest.approx(float(s_j[0]), rel=1e-4)
    assert np.isnan(h_t.numpy()[int(s_t[1]):]).all()


def test_mask_bank_matches_jax():
    data, _ = world("sphere256")
    jp = JaxProblem.from_data(data, r=5, dtype=jnp.float32)
    tp = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device="cpu")
    for rule, attr in [(UpdateRule.ROUND_ROBIN, "_masks_np"),
                       (UpdateRule.PARALLEL, "_color_masks_np")]:
        cfg = AgentConfig(num_robots=3, update_rule=rule, dtype="float32")
        bank, sched = RBCDEngine(tp, port_config(cfg)).mask_bank_and_schedule(7)
        jbank = getattr(JaxEngine(jp, cfg), attr)[:, :, 0, 0]
        np.testing.assert_array_equal(bank.numpy(), jbank)
        assert sched.dtype == torch.int32
        np.testing.assert_array_equal(sched.numpy(), np.arange(7) % bank.shape[0])


def _gnc_cfg(**kw):
    return AgentConfig(
        num_robots=2, update_rule=UpdateRule.ROUND_ROBIN,
        local_initialization_method=InitMethod.CHORDAL,
        robust_cost_type=RobustCostType.GNC_TLS,
        robust_opt_num_weight_updates=2, robust_opt_inner_iters_per_robot=2,
        RTR_gradnorm_tol=0.5, **kw,
    )


def test_make_fused_run_matches_jax_fused_runner():
    """fp32 on both sides, so X agrees to ~2e-5 (sum orders differ). The
    geometric μ schedule keeps the weight map's slope small where that
    moves the residuals, so weights hold to 1e-4; under the adaptive
    schedule's μ = 3 band the same X difference moves mid-band weights by
    ~4e-4 (the fp64 engine test pins that schedule)."""
    data, _, planted = generate_world("grid3d", grid_shape=(4, 4, 4),
                                      num_robots=2, seed=3, outlier_ratio=0.2)
    assert planted.any()
    cfg = _gnc_cfg(dtype="float32", use_fused_kernel=True,
                   GNC_schedule="geometric", GNC_use_probability=False,
                   GNC_barc=5.0)
    jp = JaxProblem.from_data(data, r=5, dtype=jnp.float32)
    je = JaxEngine(jp, cfg)
    assert je._use_fused and je.config.max_iteration_number == 10
    js, jrel, jev = je.make_fused_run(10, record=True)(je.initialize())
    tp = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device="cpu")
    te = RBCDEngine(tp, port_config(cfg))
    launches = profiling.launches()["k2"]
    ts, trel, tev, tcg = te.make_fused_run(10, record=True, return_stats=True)(
        te.initialize(ylift=np.asarray(je.Ylift))
    )
    assert profiling.launches()["k2"] == launches
    assert ts.weight_update_count == int(js.weight_update_count) == 2
    assert ts.iteration == int(js.iteration)
    np.testing.assert_array_equal(np.flatnonzero(tev.numpy()), np.flatnonzero(jev))
    np.testing.assert_array_equal(np.flatnonzero(tev.numpy()), [4, 8])
    assert np.max(np.abs(ts.weights.numpy() - np.asarray(js.weights))) < 1e-4
    np.testing.assert_array_equal(ts.fixed_mask.numpy(), np.asarray(js.fixed_mask))
    assert float(ts.cost) == pytest.approx(float(js.cost), rel=1e-3)
    assert rel_err(trel.numpy(), np.asarray(jrel)) < 1e-3
    assert tcg > ts.iteration


def _operands(bad=None):
    data, gt = world("grid3d4")
    tp = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device="cpu")
    eng = RBCDEngine(tp, port_config(AgentConfig(
        num_robots=2, update_rule=UpdateRule.ROUND_ROBIN, dtype="float32")))
    bank, sched = eng.mask_bank_and_schedule(4)
    X = torch.as_tensor(noisy_lifted_gt(gt, 5, seed=22), dtype=torch.float32)
    kw = dict(adj=eng._adjf, rel0=torch.full((2,), float("inf")), it0=0,
              last_wu=0, gnc_pending=False, cost0=1.0, it_cap=4, tol=0.0,
              gnc=False, inner=1, inner_tol=None, offsets=eng._offsets,
              windows=eng._row_windows)
    args = [X, bank, sched, eng._solver_cache(tp.edges), tp.edges, RTRParams(**DEMO)]
    err = ValueError
    if bad == "bank_dtype":
        args[1], err = bank.double(), TypeError
    elif bad == "bank_shape":
        args[1] = bank[:, :-1].contiguous()
    elif bad == "sched_dtype":
        args[2], err = sched.long(), TypeError
    elif bad == "sched_row":
        args[2] = torch.tensor([0, 1, 2, 0], dtype=torch.int32)
    elif bad == "sched_short":
        args[2] = sched[:3]
    elif bad == "adj_shape":
        kw["adj"] = torch.zeros((3, 3))
    elif bad == "inner":
        kw.update(gnc=True, inner=0)
    return args, kw, err


@pytest.mark.parametrize("bad", ["bank_dtype", "bank_shape", "sched_dtype",
                                 "sched_row", "sched_short", "adj_shape", "inner"])
def test_run_wrapper_rejects_operands_the_kernel_cannot_take(bad):
    args, kw, err = _operands(bad)
    with pytest.raises(err):
        fused_rtr.rtr_run_fused(*args, **kw)
    args, kw, _ = _operands()
    X, rel, stats = fused_rtr.rtr_run_fused(*args, **kw)  # the good operands run
    assert int(stats[fused_rtr.RUN_STEPS]) == 4


def test_run_build_failure_raises(tmp_path, monkeypatch):
    """A K2 source that does not compile raises; nothing falls back."""
    src = tmp_path / "rtr_run.cu"
    src.write_text("this is not CUDA\n")
    monkeypatch.setattr(kernels, "RUN_SOURCE", src)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.build_all()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.build_all([src])


def test_build_key_hashes_every_compiled_file(tmp_path, monkeypatch):
    """Editing the shared header changes both libraries' names."""
    before = [kernels.lib_path(s) for s in (kernels.BLOCK_SOURCE, kernels.RUN_SOURCE)]
    hdr = tmp_path / "rtr_cluster.cuh"
    hdr.write_bytes(kernels.HEADER.read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(kernels, "HEADER", hdr)
    after = [kernels.lib_path(s) for s in (kernels.BLOCK_SOURCE, kernels.RUN_SOURCE)]
    assert all(a != b for a, b in zip(after, before))
    assert len(set(after)) == 2


@pytest.mark.cuda
def test_run_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python3 chip_smoke.py)")
    data, gt = world("sphere256")
    tp = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device="cuda")
    eng = RBCDEngine(tp, port_config(AgentConfig(
        num_robots=3, update_rule=UpdateRule.ROUND_ROBIN, dtype="float32")))
    bank, sched = eng.mask_bank_and_schedule(6)
    X = torch.as_tensor(noisy_lifted_gt(gt, 5, seed=23), dtype=torch.float32,
                        device="cuda")
    kw = dict(adj=eng._adjf, rel0=torch.full((3,), float("inf"), device="cuda"),
              cost0=torch.ones(1, device="cuda"), offsets=eng._offsets, it0=0,
              last_wu=0, gnc_pending=False, it_cap=6, tol=0.0, gnc=False, inner=1,
              inner_tol=None, record=False, rgd_stepsize=0.0)
    args = (X, bank, sched, eng._solver_cache(tp.edges), tp.edges, RTRParams(**DEMO))
    launches = profiling.launches()["k2"]
    X_k, rel_k, s_k = fused_rtr.rtr_run_fused(*args, windows=eng._row_windows, **kw)
    assert profiling.launches()["k2"] == launches + 1
    X_p, rel_p, s_p = fused_rtr.rtr_run_fused_ref(*args, **kw)
    assert int(s_k[1]) == int(s_p[1]) == 6
    assert rel_err(X_k.cpu(), X_p.cpu()) < 1e-3
