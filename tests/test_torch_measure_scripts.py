"""Port parity: the measurement scripts of ``dpgo_ros_tpu_torch/scripts/``
against their JAX counterparts in ``scripts/``.

1. The stand-in table: the two small grids join ``roofline.STAND_INS``
   (not its problems) with the JAX package's pose counts.
2. ``golden_solves``: the JAX script's budgets and published optima; on the
   9-pose and the 125-pose grid the port's certified cost and rank equal
   the JAX staircase's (fp64 on the CPU, rel 1e-8).
3. ``record_ate``: its ATE, span, accept/reject agreement and outlier
   record against the JAX formulas (``rounding.ate_translation``,
   ``np.ptp``, the JAX script's agreement, the JAX CLI's
   ``outlier_ground_truth``) on two GNC solves of a small world with
   planted outliers (fp64, rel 1e-9).
4. ``run_baselines``: every section's ``AgentConfig`` equals the JAX
   script's field by field (the JAX script's calls, evaluated), and the
   ASAPP sweeps are its.
The scripts' runs on the CPU are ``tests/test_torch_script_runs.py``'s.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_ros_tpu.models import certified as j_certified
from dpgo_ros_tpu.models.problem import LiftedProblem as JaxProblem
from dpgo_ros_tpu.ops import rounding as j_rounding
from dpgo_ros_tpu.utils import config as j_config
from dpgo_ros_tpu_torch.io import datasets
from dpgo_ros_tpu_torch.io.synthetic import generate_world
from dpgo_ros_tpu_torch.scripts import golden_solves, record_ate, roofline, run_baselines
from dpgo_ros_tpu_torch.utils.config import UpdateRule
from torch_parity import load_jax_script, port_config

REPO = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------- 1. stand-ins


@pytest.mark.parametrize("name,poses,robots", [("tinyGrid3D", 9, 1), ("smallGrid3D", 125, 2)])
def test_small_grid_stand_ins(tmp_path, monkeypatch, name, poses, robots):
    monkeypatch.setattr(datasets, "DEFAULT_DATA_DIR", str(tmp_path))
    assert name not in roofline.PROBLEMS
    assert datasets.G2O_DATASETS[name][0] == poses
    data, gt, planted, stand_in = roofline.load_world(name)
    assert data.total_poses == poses and data.num_robots == robots
    assert stand_in == roofline.STAND_INS[name] and gt.shape == (poses, 3, 4)
    assert not planted.any()
    data8, _, _, args8 = roofline.load_world(name, num_robots=3)
    assert data8.num_robots == 3 and args8 == dict(stand_in, num_robots=3)
    assert len(data8.measurements) == len(data.measurements)


# ---------------------------------------------------------- 2. golden_solves


def test_golden_tables_match_jax():
    jax_golden = load_jax_script("golden_solves")
    assert golden_solves.CONFIGS == jax_golden.CONFIGS
    assert golden_solves.SESYNC_F == jax_golden.SESYNC_F


@pytest.mark.parametrize("name", ["tinyGrid3D", "smallGrid3D"])
def test_golden_matches_jax_staircase(name):
    data, _, _, stand_in = roofline.load_world(name, num_robots=1)
    entry = golden_solves.golden(name, "cpu", torch.float64, {"name": "cpu"}, verbose=False)
    jres = j_certified.certified_solve(data, **golden_solves.CONFIGS[name])
    assert entry["certified"] and jres.certified
    assert entry["rank"] == jres.rank
    assert entry["certified_global_optimum"] == pytest.approx(jres.cost, rel=1e-8)
    assert entry["refined_cost"] == pytest.approx(jres.refined_cost, rel=1e-8)
    assert entry["stand_in"] == stand_in and entry["sesync_published_f"] is None
    assert entry["poses"] == data.total_poses


# ---------------------------------------------------------- 3. record_ate


@pytest.fixture(scope="module")
def gnc_solves():
    """Two GNC solves (RoundRobin, Uniform) of a 64-pose world with 20 %
    planted outlier loop closures, fp64 on the CPU."""
    data, gt, planted = generate_world("grid3d", grid_shape=(4, 4, 4), num_robots=4,
                                       seed=3, outlier_ratio=0.2)
    runs = [record_ate.solve(data, record_ate.tun_cfg(rule, 2, 4, "float64"), rule.value,
                             "cpu")
            for rule in (UpdateRule.ROUND_ROBIN, UpdateRule.UNIFORM)]
    return data, gt, planted, runs


def test_record_ate_formulas_match_jax(gnc_solves):
    data, gt, planted, ((T_a, st_a, _, prob), (T_b, st_b, _, _)) = gnc_solves
    assert planted.any() and not np.array_equal(T_a, T_b)
    for est, ref in ((T_a, T_b), (T_a, gt), (T_b, gt)):
        want = float(j_rounding.ate_translation(jnp.asarray(est), jnp.asarray(ref)))
        assert record_ate.ate(est, ref) == pytest.approx(want, rel=1e-9)
        assert record_ate.span(ref) == float(np.ptp(ref[:, :, 3], axis=0).max())
    jp = JaxProblem.from_data(data, r=5, dtype=jnp.float64)
    loop = (np.asarray(jp.edges.is_loop) > 0) & (np.asarray(jp.edges.mask) > 0)
    np.testing.assert_array_equal(record_ate.loop_closures(prob), loop)
    w_a, w_b = st_a.weights.numpy(), st_b.weights.numpy()
    want = float(((w_a[loop] >= 0.5) == (w_b[loop] >= 0.5)).mean())
    assert record_ate.agreement(w_a, w_b, loop) == pytest.approx(want, rel=1e-9)
    loops = np.asarray(data.measurements.edge_type) != 0
    for w in (w_a, w_b):
        rec = record_ate.outlier_record(w, planted, loops)
        rej = w[: len(data.measurements)] < 0.5  # the JAX CLI's record
        assert rec == {"planted": int(planted.sum()),
                       "rejected_true": int((rej & planted).sum()),
                       "rejected_false": int((rej & loops & ~planted).sum()),
                       "missed": int((~rej & planted).sum()),
                       "recall": int((rej & planted).sum()) / int(planted.sum())}


def test_record_ate_configs_match_jax():
    src = (REPO / "scripts" / "record_ate.py").read_text()
    calls = _agent_configs(src)
    ours = [record_ate.distributed_cfg("float64"), record_ate.centralized_cfg("float64")]
    for theirs, mine in zip(calls[:2], ours):
        assert port_config(_eval(theirs, src, {})) == mine
    tun = calls[2]
    for rule in (UpdateRule.ROUND_ROBIN, UpdateRule.UNIFORM):
        theirs = _eval(tun, src, {"rule": j_config.UpdateRule(rule.value), "inner": 30})
        assert port_config(theirs) == record_ate.tun_cfg(rule, 30, 8, "float64")


# ---------------------------------------------------------- 4. run_baselines


def _agent_configs(src: str) -> list:
    """The ``AgentConfig(...)`` calls of a JAX script, in source order."""
    calls = [n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "AgentConfig"]
    return sorted(calls, key=lambda n: (n.lineno, n.col_offset))


def _eval(call, src: str, env: dict):
    """One call evaluated with the JAX package's config names and ``env``
    for the loop variables it reads."""
    names = {k: getattr(j_config, k) for k in
             ("AgentConfig", "InitMethod", "RobustCostType", "UpdateRule")}
    return eval(ast.get_source_segment(src, call), names, dict(env))


def test_run_baselines_configs_match_jax():
    src = (REPO / "scripts" / "run_baselines.py").read_text()
    calls = _agent_configs(src)
    assert len(calls) == 7
    single, sync2, demo, asapp_init, asapp, gnc_ref, gnc = calls
    want = {
        "tinyGrid3D_1robot_L2": _eval(single, src, {}),
        "smallGrid3D_2robot_sync": _eval(sync2, src, {"tol": 1e-2}),
        "cubicle_2robot_sync": _eval(sync2, src, {"tol": 0.5}),
        "sphere2500_5robot": _eval(demo, src, {"accel": False}),
        "sphere2500_5robot_accel": _eval(demo, src, {"accel": True}),
        "tunnels_8robot_gnc_reference_demo": _eval(gnc_ref, src, {}),
        "tunnels_8robot_gnc": _eval(gnc, src, {}),
    }
    got = {}
    for section in (1, 2, 3, 5):
        got.update(run_baselines.configs(section))
    assert set(got) == set(want)
    for tag, (world, robots, cfg) in got.items():
        assert port_config(want[tag]) == cfg, tag
        assert robots == cfg.num_robots and tag.startswith(world)
    assert port_config(_eval(asapp_init, src, {})) == run_baselines.asapp_config()
    sweeps = [n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Tuple)
              and len(n.elts) == 2 and all(isinstance(e, ast.Tuple) for e in n.elts)
              and isinstance(n.elts[0].elts[0], ast.Constant)
              and n.elts[0].elts[0].value == "parking-garage"]
    assert len(sweeps) == 1
    assert ast.literal_eval(sweeps[0]) == run_baselines.ASAPP_SWEEPS
    for _, stepsizes, _, _ in run_baselines.ASAPP_SWEEPS:
        for s in stepsizes:
            assert (port_config(_eval(asapp, src, {"stepsize": s}))
                    == run_baselines.asapp_config(s))
