"""Port parity: the headline harness (``dpgo_ros_tpu_torch/scripts/bench.py``)
against the root ``bench.py``.

1. ``make_perturb``: the same X and angle give the JAX harness's rotated X
   (fp32, 1e-6 of max |X|); the rotation keeps the cost and every pose's
   Stiefel block (the port of ``tests/test_bench_harness.py``).
2. The first solve of a chained region: each route's runner from a
   gauge-rotated state against the JAX engine's ``make_fused_run`` (its XLA
   runner on the CPU) from the same state, fp64: the same iterations, the
   final cost within rel 1e-4 (``tests/test_torch_run.py``'s cost
   tolerance for the runner).
3. A whole run on the CPU (``--world smallGrid3D --k_chain 2 --regions 1
   --iters 10``, fp64): every solve ran all updates, one JSON line with
   every key of the JAX harness's line, no kernel launched.
4. The device floor from a roofline JSON, and the refusals: no run without
   a card unless ``--device cpu``, no root record as ``--roofline`` or
   ``--out``.
The card's run is ``chip_smoke.py``'s ``phase_bench``.
"""

import ast
import importlib.util
import json
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_ros_tpu.models.problem import LiftedProblem as JaxProblem
from dpgo_ros_tpu.ops import quadratic as j_quad
from dpgo_ros_tpu.parallel.rbcd import RBCDEngine as JaxEngine
from dpgo_ros_tpu.utils.config import AgentConfig as JaxConfig
from dpgo_ros_tpu.utils.config import InitMethod as JaxInit
from dpgo_ros_tpu.utils.config import UpdateRule as JaxRule
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import quadratic
from dpgo_ros_tpu_torch.scripts import bench, roofline
from torch_parity import random_state

REPO = Path(__file__).resolve().parent.parent
ITERS = 10


@pytest.fixture(scope="module")
def jax_bench():
    """The root bench.py as a module, without its cache settings and its
    sys.path entry."""
    spec = importlib.util.spec_from_file_location("jax_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    with mock.patch.object(jax.config, "update"):
        spec.loader.exec_module(mod)
    sys.path[:] = saved
    return mod


# ---------------------------------------------------------- 1. the perturbation


@pytest.mark.parametrize("cost,i", [(0.0, 1.0), (1.7, 2.0), (123.4, 3.0), (12428.17, 23.0)])
def test_make_perturb_matches_jax(jax_bench, cost, i):
    """The angle within one fp32 ulp (XLA contracts JAX's multiply-add into
    an FMA on the CPU, the port rounds each operation: at θ ≈ 29 that is
    one ulp, 1.9e-6), and from the same X and angle the same rotated X
    within 1e-6 of max |X|."""
    X = random_state(64, 5, 3, seed=7, p_scale=10.0).astype(np.float32)
    perturb = bench.make_perturb(5, torch.float32, "cpu")
    c32, i32 = jnp.asarray(cost, jnp.float32), np.float32(i)
    theta_j = jax.jit(lambda c, k: c * 1e-3 + k * 0.7309)(c32, i32)
    theta_t = perturb.angle(torch.tensor(cost, dtype=torch.float32), i)
    assert theta_t.dtype == torch.float32
    assert abs(float(theta_t) - float(theta_j)) <= np.spacing(np.float32(theta_j))
    theirs = np.asarray(jax_bench.make_perturb(5)(jnp.asarray(X), c32, i32))
    ours = perturb.rotate(torch.as_tensor(X), torch.tensor(np.asarray(theta_j)))
    assert ours.dtype == torch.float32 and ours.is_contiguous()
    assert float(np.abs(ours.numpy() - theirs).max()) <= 1e-6 * np.abs(X).max()
    whole = perturb(torch.as_tensor(X), torch.tensor(cost, dtype=torch.float32), i)
    assert torch.equal(whole, perturb.rotate(torch.as_tensor(X), theta_t))


def test_gauge_perturbation_preserves_cost_and_manifold():
    data, _, _, _ = roofline.load_world("tinyGrid3D")
    prob = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device="cpu")
    eng, st, _, perturb = bench.setup(bench.UpdateRule.ROUND_ROBIN, data, ITERS, "cpu",
                                      torch.float32)
    f0 = float(quadratic.cost(st.X, prob.edges))
    for i, c in enumerate((0.0, 1.7, 123.4)):
        Xp = perturb(st.X, torch.tensor(c, dtype=torch.float32), i + 1.0)
        # distinct bits unless the rotation angle is ~0
        if c or i:
            assert float((Xp - st.X).abs().max()) > 1e-4
        # cost invariant (the solver does the same work)
        fp = float(quadratic.cost(Xp, prob.edges))
        assert abs(fp - f0) < 1e-3 * max(abs(f0), 1.0), (fp, f0)
        # Stiefel feasibility preserved: YᵀY = I per pose
        Y = Xp[:, :, :3].double().numpy()
        err = np.abs(np.einsum("nra,nrb->nab", Y, Y) - np.eye(3)).max()
        assert err < 1e-5, err


# ---------------------------------------------------------- 2. the first solve


@pytest.mark.parametrize("route", list(bench.ROUTES))
def test_first_solve_matches_jax_fused_run(route):
    rule, runner = bench.ROUTES[route]
    data, _, _, _ = roofline.load_world("smallGrid3D")
    eng, st0, run, perturb = bench.setup(rule, data, ITERS, "cpu", torch.float64, runner)
    Xp = perturb(st0.X, st0.cost, 1.0)
    out, tcg = run(st0._replace(X=Xp))
    jp = JaxProblem.from_data(data, r=5, dtype=jnp.float64)
    je = JaxEngine(jp, JaxConfig(
        num_robots=data.num_robots, update_rule=JaxRule(rule.value),
        local_initialization_method=JaxInit.CHORDAL, relative_change_tolerance=0.0,
        max_iteration_number=ITERS, RTR_iterations=3, RTR_tCG_iterations=50,
        RTR_gradnorm_tol=0.5, dtype="float64"))
    assert not je._use_fused  # the XLA runner: the JAX harness's CPU path
    X = jnp.asarray(Xp.numpy())
    js0 = je.initialize()._replace(X=X, X_prev=X, V=X, cost=j_quad.cost(X, jp.edges))
    js = je.make_fused_run(ITERS)(js0)
    assert out.iteration == int(js.iteration) == ITERS
    assert float(out.cost) == pytest.approx(float(js.cost), rel=1e-4)
    assert tcg > ITERS


# ---------------------------------------------------------- 3. a run on the CPU


def _jax_keys() -> set:
    """The keys of the JAX harness's JSON line (the dict literal in main)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    dicts = [n for n in ast.walk(main) if isinstance(n, ast.Dict)
             and any(isinstance(k, ast.Constant) and k.value == "metric" for k in n.keys)]
    assert len(dicts) == 1
    return {k.value for k in dicts[0].keys}


def test_bench_runs_on_the_cpu(capsys):
    out = bench.main(["--world", "smallGrid3D", "--k_chain", "2", "--regions", "1",
                      "--iters", str(ITERS), "--device", "cpu", "--dtype", "float64"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == json.loads(json.dumps(out))
    keys = _jax_keys()
    assert len(keys) == 14 and keys <= set(out)
    assert out["metric"] == "smallGrid3D_2robot_rbcd_block_updates_per_sec"
    assert out["card"]["name"] == "cpu" and out["device_floor_ms"] is None
    assert set(out["routes"]) == set(bench.ROUTES)
    for r in out["routes"].values():
        assert r["solves"] == 2 + 2 + 1
        assert set(r["launches"].values()) == {0}  # CPU tensors: plain versions
        assert r["host_reads_per_solve"] is None
        assert r["f_final_max"] - r["f_final_min"] < 1e-2 * abs(r["f_final_max"]) + 1e-3
        assert r["tcg_per_solve_min"] <= r["tcg_per_solve"] <= r["tcg_per_solve_max"]
    assert out["routes"]["parallel"]["updates_per_solve"] == ITERS  # 2 colours of 1 robot
    assert out["routes"]["roundrobin"]["updates_per_solve"] == ITERS


def test_finish_refuses_short_solves_and_spread_costs():
    data, _, _, _ = roofline.load_world("tinyGrid3D")
    eng, st0, _, _ = bench.setup(bench.UpdateRule.ROUND_ROBIN, data, ITERS, "cpu",
                                 torch.float64)
    c = torch.tensor(5.0, dtype=torch.float64)
    ok = [[(c, ITERS, 30), (c, ITERS, 31)]]
    assert bench.finish(eng, st0, [1.0], ok, bench.UpdateRule.ROUND_ROBIN, 2,
                        ITERS)["tcg_per_solve"] == 30.5
    with pytest.raises(RuntimeError, match="updates"):
        bench.finish(eng, st0, [1.0], [[(c, ITERS, 30), (c, ITERS - 1, 30)]],
                     bench.UpdateRule.ROUND_ROBIN, 2, ITERS)
    with pytest.raises(RuntimeError, match="spread"):
        bench.finish(eng, st0, [1.0], [[(c, ITERS, 30), (c + 1.0, ITERS, 30)]],
                     bench.UpdateRule.ROUND_ROBIN, 2, ITERS)


# ---------------------------------------------------------- 4. floor, refusals


def test_device_floor_takes_the_least_valid_slope():
    res = {"tcg_per_solve": 1000, "per_solve_s": 0.05}
    row = {"k1": {"per_tcg_iter_measured_s": 3e-5, "slope_valid": True},
           "k4": {"per_tcg_iter_measured_s": 1e-5, "slope_valid": True}}
    floor, ok, src = bench.device_floor_check(res, {"rows": {"sphere2500": row}}, "sphere2500")
    assert (floor, ok, src) == (pytest.approx(0.01), True, "k4")
    row["k4"]["slope_valid"] = False
    floor, ok, src = bench.device_floor_check(res, {"rows": {"sphere2500": row}}, "sphere2500")
    assert (floor, ok, src) == (pytest.approx(0.03), True, "k1")
    res["per_solve_s"] = 0.02  # under 0.9 × 0.03 s
    assert bench.device_floor_check(res, {"rows": {"sphere2500": row}}, "sphere2500")[1] is False
    assert bench.device_floor_check(res, None, "sphere2500") == (None, True, None)
    assert bench.device_floor_check(res, {"rows": {}}, "sphere2500") == (None, True, None)


def test_bench_refuses_without_a_card_and_root_records(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA device"):
            bench.main(["--world", "tinyGrid3D"])
    for flag in ("--roofline", "--out"):
        for record in ("ROOFLINE.json", "BENCH_r05.json"):
            with pytest.raises(SystemExit) as e:
                bench.main(["--device", "cpu", flag, str(REPO / record)])
            assert e.value.code == 2
