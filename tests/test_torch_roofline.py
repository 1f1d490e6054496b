"""Port parity: the roofline path (``scripts/roofline.py``) and the work
counts of ``utils/work.py``.

1. ``forced_params`` equals the JAX script's field by field.
2. A forced solve runs exactly 3·K tCG iterations: the port's plain K1
   (all-ones mask) and plain K4 (robot 0's window) on sphere256 from the
   chordal state in fp64, and the JAX package's XLA ``rtr_solve`` on the
   same state (its Hessian applications counted with jit disabled).
3. The sweep fit and its validity rule on synthetic times, and a whole
   kernel row on the CPU under a timer that charges 1 ms per solve and
   0.1 ms per tCG iteration, so the fit must return exactly those.
4. The problems cover the JAX script's list; their stand-ins have the
   stated sizes; a data file, where present, takes precedence.
5. No run without a card; ``--out`` never names the TPU's ROOFLINE.json.
6. The work counts, moved out of chip_smoke.py, against a hand count on a
   two-pose world; chip_smoke.py keeps no copy of them.
7. The device timer's busy time of a trace, and the traces it refuses.
The kernels run only on the card (``python3 chip_smoke.py``).
"""

import ast
import dataclasses
import math
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_ros_tpu.models import local_solvers as j_ls
from dpgo_ros_tpu.models.problem import LiftedProblem as JaxProblem
from dpgo_ros_tpu.ops import quadratic as j_quad
from dpgo_ros_tpu_torch.io import datasets
from dpgo_ros_tpu_torch.io.g2o import write_g2o
from dpgo_ros_tpu_torch.io.synthetic import generate_world
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import fused_rtr, hbm_rtr
from dpgo_ros_tpu_torch.scripts import roofline as rl
from dpgo_ros_tpu_torch.types import EdgeType, MeasurementBatch, PoseGraphData
from dpgo_ros_tpu_torch.utils import work
from torch_parity import load_jax_script, world

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_roofline():
    return load_jax_script("roofline")


@pytest.fixture(scope="module")
def sphere_state():
    """sphere256 in fp64 on the CPU and the roofline's chordal state."""
    data, _ = world("sphere256")
    prob = LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu")
    X0, Pinv = rl.init_state(prob)
    return data, prob, X0, Pinv


# ---------------------------------------------------------- 1. forced budgets


@pytest.mark.parametrize("K", [1, 10, 50])
def test_forced_params_match_jax(jax_roofline, K):
    ours, theirs = rl.forced_params(K), jax_roofline.forced_params(K)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    # the one JAX field the port's RTRParams lacks stays at its default
    extra = {f.name for f in dataclasses.fields(theirs)} - {
        f.name for f in dataclasses.fields(ours)}
    assert extra == {"precond_damping"}
    assert theirs.precond_damping == j_ls.RTRParams().precond_damping


# ---------------------------------------------------------- 2. 3·K tCG


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("kernel", ["k1", "k4"])
def test_forced_solve_runs_exactly_3k_tcg(sphere_state, kernel, K):
    _, prob, X0, Pinv = sphere_state
    solve, block = rl.solvers(prob, Pinv, (kernel,))[kernel]
    X, stats = solve(X0, rl.forced_params(K))
    assert int(stats[fused_rtr.S_TCG]) == 3 * K
    assert int(stats[fused_rtr.S_ITERS]) == 3
    assert float(stats[fused_rtr.S_F]) < float(stats[fused_rtr.S_F0])
    assert block.sum() == (prob.n if kernel == "k1" else prob.num_poses[0])
    # chained: the next forced solve from the new state runs 3·K too
    assert int(solve(X, rl.forced_params(K))[1][fused_rtr.S_TCG]) == 3 * K


@pytest.mark.parametrize("K", [1, 3])
def test_jax_rtr_solve_runs_the_same_tcg_count(sphere_state, jax_roofline, monkeypatch, K):
    data, prob, X0, Pinv = sphere_state
    jp = JaxProblem.from_data(data, r=5)
    calls = []
    rhess = j_quad.rhess_vp

    def counted(*a, **kw):
        calls.append(1)
        return rhess(*a, **kw)

    monkeypatch.setattr(j_quad, "rhess_vp", counted)
    with jax.disable_jit():  # while_loop bodies run once per iteration
        X, res = j_ls.rtr_solve(
            jnp.asarray(X0.numpy()), jp.edges, jnp.ones((prob.n, 1, 1)),
            jnp.asarray(Pinv.numpy()), jax_roofline.forced_params(K))
    assert int(res.iterations) == 3
    ours = rl.solvers(prob, Pinv, ("k1",))["k1"][0](X0, rl.forced_params(K))
    assert len(calls) == int(ours[1][fused_rtr.S_TCG]) == 3 * K
    assert float(res.f_opt) == pytest.approx(float(ours[1][fused_rtr.S_F]), rel=1e-8)


# ---------------------------------------------------------- 3. fit and rows


@pytest.mark.parametrize("case,valid", [
    ("linear", True),
    ("not_increasing", False),
    ("flat_slope", False),
    ("noisy", False),
    ("nonpositive", False),
])
def test_fit_and_validity_rule(case, valid):
    ks = rl.KS
    times = {K: 1e-3 + 3 * K * 1e-4 for K in ks}
    stds = {K: 1e-6 for K in ks}
    if case == "not_increasing":
        times[ks[1]] = times[ks[2]] + 1e-6
    elif case == "flat_slope":  # 1 % of the time per tCG at the largest K
        times = {K: 1.0 + 3 * K * 1e-4 for K in ks}
    elif case == "noisy":
        stds = {K: 0.02 for K in ks}
    elif case == "nonpositive":
        times = {K: t - times[ks[0]] for K, t in times.items()}
    slope, slope_std, intercept, ok = rl.fit(times, stds, ks)
    assert ok is valid
    if case == "linear":
        assert slope == pytest.approx(1e-4, rel=1e-9)
        assert intercept == pytest.approx(1e-3, rel=1e-9)
        assert slope_std == pytest.approx(math.sqrt(2) * 1e-6 / (3 * 49), rel=1e-9)


@pytest.mark.parametrize("kernel", ["k1", "k4"])
def test_sweep_row_recovers_the_charged_slope_and_intercept(sphere_state, monkeypatch, kernel):
    """Every solve is charged 1 ms + 0.1 ms per tCG iteration it ran: the
    row's slope is 0.1 ms per tCG, its intercept 1 ms, and its floors are
    the work counts of the block over the given rates."""
    _, prob, X0, Pinv = sphere_state
    solve, block = rl.solvers(prob, Pinv, (kernel,))[kernel]
    charged = []

    def counted(X, p):
        Xn, s = solve(X, p)
        charged.append(1.0 + 0.1 * float(s[fused_rtr.S_TCG]))
        return Xn, s

    def fake_device_ms(fn):
        charged.clear()
        fn()
        return sum(charged)

    monkeypatch.setattr(rl, "_device_ms", fake_device_ms)
    row = rl.sweep(prob, counted, block, X0, rate=2e13, reps=(1, 2), n_est=2, ks=(1, 2, 3))
    assert row["tcg_exact"] and row["slope_valid"]
    assert row["tcg_per_forced_solve"] == {"1": [3], "2": [6], "3": [9]}
    assert row["per_tcg_iter_measured_s"] == pytest.approx(1e-4, rel=1e-9)
    assert row["per_solve_intercept_s"] == pytest.approx(1e-3, rel=1e-9)
    nk, Ek, ns = work.block_work(prob, block)
    assert row["block"] == {"poses": nk, "edges": Ek, "separators": ns}
    flops = work.tcg_flops(nk, Ek, prob.r, prob.d)
    assert row["per_tcg_floor_s"] == pytest.approx(flops / 67e12)
    assert row["per_tcg_floor_attainable_s"] == pytest.approx(flops / 2e13)
    assert row["fraction_of_peak"] == pytest.approx(flops / 67e12 / 1e-4)
    # K1 on the all-robots window reports every robot's moved and updated
    stats_len = 6 + 2 * prob.num_robots if kernel == "k1" else hbm_rtr.STATS_LEN
    assert row["hbm_oneshot_s"] == pytest.approx(
        work.solve_bytes(prob, nk, Ek, ns, stats=stats_len) / 3.35e12)
    assert 0 < row["bench_budget_tcg_share"] < 1
    assert "slope_invalid_reason" not in row


def test_sweep_row_flags_tcg_counts_other_than_3k(sphere_state, monkeypatch):
    """A solve that stops tCG early (here: one whose stats say so) voids
    the slope and names the counts."""
    _, prob, X0, Pinv = sphere_state
    solve, block = rl.solvers(prob, Pinv, ("k4",))["k4"]

    def short(X, p):
        Xn, s = solve(X, p)
        s = s.clone()
        s[fused_rtr.S_TCG] = min(float(s[fused_rtr.S_TCG]), 4.0)
        return Xn, s

    monkeypatch.setattr(rl, "_device_ms", lambda fn: fn() or 1.0)
    row = rl.sweep(prob, short, block, X0, rate=None, reps=(1, 2), n_est=1, ks=(1, 2, 3))
    assert not row["tcg_exact"] and not row["slope_valid"]
    assert row["tcg_per_forced_solve"]["2"] == [4]
    assert "3·K" in row["slope_invalid_reason"]
    assert row["fraction_of_peak"] is None and row["per_tcg_floor_attainable_s"] is None


# ---------------------------------------------------------- 4. problems


def test_problems_cover_the_jax_list():
    src = (REPO / "scripts" / "roofline.py").read_text()
    loop = src[src.index('for name, num_robots in ['):src.index("prob, kg = build(")]
    jax_list = [(n, int(r)) for n, r in re.findall(r'\("([\w-]+)", (\d+)\)', loop)]
    assert len(jax_list) == 5
    for name, robots in jax_list:
        assert rl.PROBLEMS[name][:2] == (robots, ("k1", "k4")), name
        assert rl.STAND_INS[name]["num_robots"] == robots, name
    assert rl.PROBLEMS["parking-garage"][2] == 12  # the JAX script's presteps
    # the two small grids are the measurement scripts' stand-ins, no problem
    assert set(rl.STAND_INS) - set(rl.PROBLEMS) == {"tinyGrid3D", "smallGrid3D"}
    assert set(rl.PROBLEMS) == {n for n, _ in jax_list} | {"sphere50k"}
    assert rl.PROBLEMS["sphere50k"][1] == ("k4",)


@pytest.mark.parametrize("name,poses", [
    ("sphere2500", 2500), ("cubicle", 5832), ("torus3D", 5000),
    ("parking-garage", 1728), ("tunnels", 2500), ("sphere50k", 50000),
])
def test_stand_in_without_a_data_file(tmp_path, monkeypatch, name, poses):
    monkeypatch.setattr(datasets, "DEFAULT_DATA_DIR", str(tmp_path))
    data, stand_in = rl.load_data(name)
    assert stand_in == rl.STAND_INS[name]
    assert data.total_poses == poses
    assert data.num_robots == rl.PROBLEMS[name][0]
    if name == "tunnels":
        _, _, outliers = generate_world(**stand_in)
        assert int(outliers.sum()) == 245


def test_data_file_takes_precedence(tmp_path, monkeypatch):
    data, gt, _ = generate_world("grid3d", grid_shape=(3, 3, 3), num_robots=1, seed=5)
    write_g2o(str(tmp_path / "parking-garage.g2o"), gt, data.measurements)
    monkeypatch.setattr(datasets, "DEFAULT_DATA_DIR", str(tmp_path))
    loaded, stand_in = rl.load_data("parking-garage")
    assert stand_in is None
    assert loaded.total_poses == 27 and loaded.num_robots == 2
    assert len(loaded.measurements) == len(data.measurements)


# ---------------------------------------------------------- 5. no card


def test_roofline_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "dpgo_ros_tpu_torch.scripts.roofline",
                        "--problems", "sphere2500"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "CUDA" in p.stderr


@pytest.mark.parametrize("argv", [["--out", str(REPO / "ROOFLINE.json")],
                                  ["--problems", "sphere2500,nowhere"]])
def test_roofline_refuses_bad_arguments(argv):
    with pytest.raises(SystemExit) as e:
        rl.main(argv)
    assert e.value.code == 2


# ---------------------------------------------------------- 6. work counts


@pytest.fixture(scope="module")
def two_poses():
    """Two robots of one pose each, one shared edge 0 → 1, d = 3, r = 5."""
    m = MeasurementBatch(
        src_robot=np.array([0], np.int32), src_frame=np.array([0], np.int32),
        dst_robot=np.array([1], np.int32), dst_frame=np.array([0], np.int32),
        R=np.eye(3)[None], t=np.array([[1.0, 0.0, 0.0]]), kappa=np.ones(1),
        tau=np.ones(1), weight=np.ones(1), fixed_weight=np.zeros(1, bool),
        edge_type=np.array([EdgeType.SHARED_LOOP_CLOSURE], np.int32),
    )
    data = PoseGraphData(measurements=m, num_poses=np.array([1, 1], np.int64), d=3)
    return LiftedProblem.from_data(data, r=5, dtype=torch.float32, device="cpu")


def test_work_counts_match_a_hand_count(two_poses):
    """r = 5, d = 3: C = 20; an edge pass 5·(36 + 12 + 6 + 8) = 310 flops;
    per pose projection 180, preconditioned projection 360, retraction
    45 + 20·(90 + 105) = 3,945."""
    p = two_poses
    assert work.edge_bytes(1, 3) == 8 + 36 + 12 + 8
    assert work.block_work(p, np.array([True, False])) == (1, 1, 1)
    assert work.block_work(p, np.array([True, True])) == (2, 1, 0)
    # 4 · (2·20 + 20 + 16 + 6 + 2·2) + 64
    assert work.solve_bytes(p, 1, 1, 1) == 408
    assert work.solve_bytes(p, 1, 1, 1, stats=7) == 408 - 4 * 3
    assert work.tcg_flops(1, 1, 5, 3) == 310 + 270 + 360 + 460
    assert work.tr_flops(1, 1, 5, 3) == 310 + 540 + 360 + 260 + 3945
    assert work.rtr_flops(1, 1, 5, 3, 2, 3) == 310 + 220 + 2 * 5415 + 3 * 1400
    assert work.rtr_flops(2, 1, 5, 3, 1, 1) == 310 + 440 + (310 + 2 * 5105) + (310 + 2 * 1090)
    # per robot: one step over its edge and pose, then the movement (3·C)
    assert work.tick_flops(p, 1, True) == 2 * (310 + 4525 + 60)
    assert work.tick_flops(p, 2, False) == 2 * (2 * (310 + 4145) + 60)
    assert work.tick_bytes(p, True) == 4 * (80 + 40 + 32 + 4) + 64
    assert work.tick_bytes(p, False) == 4 * (80 + 40 + 4) + 64
    ms, by = work.bound(408, 15560)
    assert by == "operations" and ms == pytest.approx(15560 / 67e12 * 1e3)
    assert work.bound(4e6, 1.0)[1] == "bytes"


def test_rtr_flops_is_its_tr_and_tcg_terms():
    for n, E, tr, tcg in [(500, 1000, 3, 17), (3125, 6475, 3, 150)]:
        base = work.rtr_flops(n, E, 5, 3, 0, 0)
        assert work.rtr_flops(n, E, 5, 3, tr, tcg) == pytest.approx(
            base + tr * work.tr_flops(n, E, 5, 3) + tcg * work.tcg_flops(n, E, 5, 3), rel=1e-15)


def test_chip_smoke_keeps_no_copy_of_the_counts():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    defined = {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    moved = {"bound", "edge_bytes", "block_work", "solve_bytes", "_edge_flops",
             "_pose_flops", "rtr_flops", "tcg_flops", "tick_flops", "tick_bytes"}
    assert not defined & moved
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
                and n.module == "dpgo_ros_tpu_torch.utils.work" for a in n.names}
    assert imported >= {"bound", "block_work", "rtr_flops", "solve_bytes"}


def test_session_busy_ms_fails_loudly_on_a_trace_it_cannot_read():
    """The busy time of a trace is the union of its device intervals; a
    trace with an interval no runtime or driver call of the session
    launched (here another session's, spanning the whole trace), or with
    fewer kernel intervals than the call's launches, raises; a trace
    without correlation ids is taken whole."""
    call = lambda c: {"ph": "X", "cat": "cuda_runtime", "ts": 0, "dur": 1,
                      "args": {"correlation": c}}
    dev = lambda c, ts, dur, cat="kernel": {"ph": "X", "cat": cat, "ts": ts, "dur": dur,
                                           "args": {"correlation": c}}
    events = [call(1), call(2), {"ph": "X", "cat": "cuda_driver", "ts": 0, "dur": 1,
                                 "args": {"correlation": 3}},
              dev(1, 10, 5), dev(2, 12, 6), dev(3, 30, 2, "gpu_memcpy"),
              {"ph": "X", "cat": "cpu_op", "ts": 0, "dur": 50}]
    assert rl.session_busy_ms(events, 2) == pytest.approx((8 + 2) / 1e3)
    with pytest.raises(RuntimeError, match="2 kernel intervals for 3"):
        rl.session_busy_ms(events, 3)
    with pytest.raises(RuntimeError, match="1 of 4 device intervals"):
        rl.session_busy_ms(events + [dev(99, 0, 1e6)])
    with pytest.raises(RuntimeError, match="0 kernel intervals for 1"):
        rl.session_busy_ms([call(1)], 1)
    bare = [{k: v for k, v in e.items() if k != "args"} for e in events + [dev(99, 0, 1e6)]]
    assert rl.session_busy_ms(bare) == pytest.approx(1e6 / 1e3)
