"""The port's last ten entry points (``dpgo_ros_tpu_torch/scripts/``)
against the JAX scripts they port, on the CPU.

1. ``record_scaling_r03.skew_for`` and ``record_scaling_r05.stats_for``
   (also on ``repartition_slots`` and on the work-balanced partition) equal
   the JAX scripts' exactly on the two small grids and a 500-pose,
   5-robot sphere.
2. ``exp_tunnels_schedule.CONFIGS`` equals the JAX script's.
3. The sweep's agreement, flips, flip band, ATE and common-accept-set
   refit against the JAX script's own ``main`` (run on a copy of it, its
   tunnels loader handed a small planted-outlier world) under the
   ``final`` configuration in fp64, the port given JAX's YLift and Uniform
   schedule; ``record_ate_r03`` copies the port sweep's ``final`` block
   and refuses the root record.
4. ``proto_chain_precond``'s tCG counts per robot equal the JAX script's
   on smallGrid3D in fp64.
5. ``exp_e2e``'s ``tiny`` preset and ``exp_spmd``'s 8-slot run: fp64 final
   costs within 1e-8 relative of the JAX engine's and mesh program's.

The JAX scripts set devices and compile caches when they are imported
(``ensure_cpu_devices``) or solve at import (``proto_chain_precond``), so
they run in one subprocess; JAX's mesh runs in one more, on 8 CPU devices.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dpgo_ros_tpu_torch.io.synthetic import generate_world
from dpgo_ros_tpu_torch.parallel import spmd
from dpgo_ros_tpu_torch.scripts import (
    exp_e2e,
    exp_spmd,
    exp_tunnels_schedule,
    proto_chain_precond,
    record_ate_r03,
    record_scaling_r03,
    record_scaling_r05,
    roofline,
)

REPO = Path(__file__).resolve().parent.parent
# the worlds of the skew / stats parity: (generate_world arguments, robots)
SKEW_WORLDS = {
    "tinyGrid3D": dict(roofline.STAND_INS["tinyGrid3D"], num_robots=2),
    "smallGrid3D": dict(roofline.STAND_INS["smallGrid3D"], num_robots=2),
    "sphere500": dict(kind="sphere", n=500, num_robots=5, seed=0),
}
# the sweep's small planted-outlier world (8 robots, as the sweep's)
GNC_WORLD = dict(kind="grid3d", grid_shape=(5, 5, 5), num_robots=8, seed=42,
                 outlier_ratio=0.2)
TOL_COST = 1e-8

# Runs the JAX side and prints one JSON object: argv = REPO, a scratch dir.
JAX_SIDE = r'''
import contextlib, io, json, os, re, shutil, sys, importlib.util
import numpy as np
REPO, TMP = sys.argv[1], sys.argv[2]
sys.path.insert(0, REPO)
SKEW_WORLDS, GNC_WORLD = json.loads(sys.argv[3]), json.loads(sys.argv[4])
os.makedirs(os.path.join(TMP, "scripts"))


def load(name):
    # a copy, so that a script that writes next to its parent directory
    # writes into TMP
    path = os.path.join(TMP, "scripts", name + ".py")
    shutil.copy(os.path.join(REPO, "scripts", name + ".py"), path)
    spec = importlib.util.spec_from_file_location("jax_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ets = load("exp_tunnels_schedule")
import jax, jax.numpy as jnp
jax.config.update("jax_compilation_cache_dir", os.path.join(TMP, "cache"))
from dpgo_ros_tpu.io import datasets
from dpgo_ros_tpu.io.synthetic import generate_world
from dpgo_ros_tpu.parallel import rbcd, spmd

YLIFTS = []
_init = rbcd.RBCDEngine.initialize
def initialize(self, *a, **k):
    st = _init(self, *a, **k)
    YLIFTS.append(np.asarray(self.Ylift).tolist())
    return st
rbcd.RBCDEngine.initialize = initialize


def world(args):
    args = dict(args)
    if "grid_shape" in args:
        args["grid_shape"] = tuple(args["grid_shape"])
    return generate_world(**args)[0]


out = {"configs": ets.CONFIGS}
r03, r05 = load("record_scaling_r03"), load("record_scaling_r05")
out["skew"] = {}
for name, args in SKEW_WORLDS.items():
    data, R = world(args), args["num_robots"]
    out["skew"][name] = {
        "skew": r03.skew_for(data),
        "skew_balanced": r03.skew_for(world(dict(args, balance="work"))),
        "stats": r05.stats_for(data),
        "stats_repartitioned": r05.stats_for(spmd.repartition_slots(data, R)),
    }

# the sweep's own main, under "final", on the small world
gnc = world(GNC_WORLD)
ets.load_tunnels = lambda: gnc
ets.CONFIGS = {"final": ets.CONFIGS["final"]}
sys.argv = ["exp_tunnels_schedule", "final"]
YLIFTS.clear()
with contextlib.redirect_stdout(io.StringIO()):
    ets.main()
with open(os.path.join(TMP, "exp_tunnels_schedule.json")) as f:
    out["sweep"] = json.load(f)["final"]
out["sweep_ylift"] = YLIFTS[0]
key0 = jax.random.PRNGKey(42)  # AgentConfig's seed
out["uniform_schedule"] = np.asarray(jax.vmap(
    lambda i: jax.random.randint(jax.random.fold_in(key0, i), (), 0, 8))(
        jnp.arange(4000))).tolist()

# the prototype on smallGrid3D in fp64
datasets.load_g2o_dataset = lambda name, num_robots: world(
    dict(SKEW_WORLDS["smallGrid3D"], num_robots=num_robots))
src = open(os.path.join(REPO, "scripts", "proto_chain_precond.py")).read()
src = src.replace("jnp.float32", "jnp.float64").replace('dtype="float32"', 'dtype="float64"')
YLIFTS.clear()
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    exec(compile(src, "proto_chain_precond.py", "exec"),
         {"__name__": "__main__", "__file__": os.path.join(REPO, "scripts", "x.py")})
out["proto"] = [[int(m.group(1)), m.group(2), int(m.group(3)), m.group(4)]
                for m in re.finditer(r"jacobi (\d+) \((\w+)\)  tridiag (\d+) \((\w+)\)",
                                     buf.getvalue())]
out["proto_ylift"] = YLIFTS[0]

# exp_e2e's tiny preset
e2e = load("exp_e2e")
e2e.load_g2o_dataset = lambda name, num_robots: world(
    dict(SKEW_WORLDS["tinyGrid3D"], num_robots=num_robots))
out["e2e_tiny"] = []
for R, iters in ((1, 50), (2, 100)):
    YLIFTS.clear()
    with contextlib.redirect_stdout(io.StringIO()):
        info = e2e.solve("tinyGrid3D", R, e2e.UpdateRule.ROUND_ROBIN, tol=1e-2,
                         max_iters=iters)
    out["e2e_tiny"].append({"iterations": info["iterations"],
                            "final_cost": info["final_cost"], "ylift": YLIFTS[0]})
print("JAX_SIDE " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_side")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    env.pop("XLA_FLAGS", None)
    p = subprocess.run(
        [sys.executable, "-c", JAX_SIDE, str(REPO), str(tmp / "run"),
         json.dumps(SKEW_WORLDS), json.dumps(GNC_WORLD)],
        capture_output=True, text=True, env=env, timeout=600)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("JAX_SIDE ")]
    assert p.returncode == 0 and lines, p.stderr[-4000:]
    return json.loads(lines[-1].split(" ", 1)[1])


def _world(args):
    return generate_world(**args)[0]


@pytest.mark.parametrize("name", list(SKEW_WORLDS))
def test_skew_and_stats_equal_jax(jax_side, name):
    args, ref = SKEW_WORLDS[name], jax_side["skew"][name]
    data, R = _world(args), args["num_robots"]
    assert record_scaling_r03.skew_for(data) == ref["skew"]
    assert record_scaling_r03.skew_for(_world(dict(args, balance="work"))) == \
        ref["skew_balanced"]
    assert record_scaling_r05.stats_for(data) == ref["stats"]
    assert record_scaling_r05.stats_for(spmd.repartition_slots(data, R)) == \
        ref["stats_repartitioned"]


def test_sweep_configs_equal_jax(jax_side):
    assert exp_tunnels_schedule.CONFIGS == jax_side["configs"]


@pytest.fixture(scope="module")
def port_sweep(jax_side):
    data, gt, planted = generate_world(**GNC_WORLD)
    return exp_tunnels_schedule.config_entry(
        "final", exp_tunnels_schedule.CONFIGS["final"], data, gt, planted,
        device="cpu", dtype="float64", ylift=np.asarray(jax_side["sweep_ylift"]),
        schedule=jax_side["uniform_schedule"])


def test_sweep_decisions_and_refit_match_jax(jax_side, port_sweep):
    ref, got = jax_side["sweep"], port_sweep
    assert got["config"] == ref["config"]
    for k in ("ROUND_ROBIN", "UNIFORM"):
        assert got["runs"][k]["iters"] == ref["runs"][k]["iters"], k
        assert got["runs"][k]["converged"] == ref["runs"][k]["converged"], k
        assert got["runs"][k]["cost"] == pytest.approx(ref["runs"][k]["cost"], rel=TOL_COST)
    assert got["agreement"] == ref["agreement"]
    assert got["num_flipped"] == ref["num_flipped"]
    np.testing.assert_allclose(got["flip_resid_over_barc"], ref["flip_resid_over_barc"],
                               atol=1e-3)
    for k in ("ate_rmse", "span", "ate_over_span", "common_set_refit_ate",
              "common_set_refit_ate_over_span"):
        assert got[k] == pytest.approx(ref[k], rel=1e-6, abs=1e-10), k


def test_sweep_helpers():
    loop = np.array([True, True, True, False, True])
    a = np.array([True, False, True, True, False])
    b = np.array([True, True, False, True, False])
    assert exp_tunnels_schedule.agreement(a & loop, b & loop, loop) == 0.5
    flips = exp_tunnels_schedule.flipped(a & loop, b & loop, loop)
    np.testing.assert_array_equal(flips, [False, True, True, False, False])
    r = np.array([1.0, 3.0, 6.0, 9.0, 12.0])
    assert exp_tunnels_schedule.flip_band(r, r + 0.3, flips) == [1.05, 2.05]
    np.testing.assert_array_equal(
        exp_tunnels_schedule.common_weights(a & loop, b & loop, loop), [1, 0, 0, 1, 0])


def test_record_ate_r03_takes_the_port_sweep(port_sweep, tmp_path, capsys):
    line = {"world": "smallGrid3D", "stand_in": GNC_WORLD, "configs": {"final": port_sweep},
            "card": {"name": "cpu"}, "dtype": "float64"}
    path = tmp_path / "sweep.json"
    path.write_text(json.dumps(line) + "\n")
    out = record_ate_r03.main(["--world", "tinyGrid3D", "--schedule", str(path),
                               "--device", "cpu", "--dtype", "float64"])
    block = out["tunnels_8robot_gnc_schedule_independence"]
    assert block["accept_reject_agreement"] == port_sweep["agreement"]
    assert block["common_accept_set_refit_ate"] == port_sweep["common_set_refit_ate"]
    assert block["runs"]["UNIFORM"]["iters"] == port_sweep["runs"]["UNIFORM"]["iters"]
    assert len(capsys.readouterr().out.strip().splitlines()) == 1
    with pytest.raises(SystemExit, match="root records"):
        record_ate_r03.main(["--world", "tinyGrid3D", "--device", "cpu",
                             "--schedule", str(REPO / "exp_tunnels_schedule.json")])


def test_proto_counts_equal_jax(jax_side):
    got = proto_chain_precond.run("smallGrid3D", 5, "cpu", "float64",
                                  ylift=np.asarray(jax_side["proto_ylift"]))
    rows = [[r["jacobi"], r["jacobi_end"], r["tridiag"], r["tridiag_end"]]
            for r in got["robots"]]
    assert rows == jax_side["proto"] and len(rows) == 5
    assert got["diag_block_parity_rel_err"] == 0.0


def test_e2e_tiny_matches_jax(jax_side):
    for (R, iters), ref in zip(((1, 50), (2, 100)), jax_side["e2e_tiny"]):
        row = exp_e2e.solve("tinyGrid3D", R, exp_e2e.RR, tol=1e-2, max_iters=iters,
                            device="cpu", dtype="float64", ylift=np.asarray(ref["ylift"]))
        assert row["iterations"] == ref["iterations"]
        assert row["final_cost"] == pytest.approx(ref["final_cost"], rel=TOL_COST)


# JAX's 8-slot mesh run, as the JAX script steps it (a synchronization after
# each step), on 8 CPU devices in a subprocess of its own: argv = REPO, the
# world's generate_world arguments
JAX_SPMD = r'''
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import jax
from jax.sharding import Mesh
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from dpgo_ros_tpu.io.synthetic import generate_world
from dpgo_ros_tpu.models.problem import LiftedProblem
from dpgo_ros_tpu.ops import quadratic
from dpgo_ros_tpu.parallel import spmd
from dpgo_ros_tpu.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu.utils.config import AgentConfig, InitMethod, UpdateRule
args = json.loads(sys.argv[2])
args["grid_shape"] = tuple(args["grid_shape"])
data = generate_world(**args)[0]
cfg = AgentConfig(num_robots=8, update_rule=UpdateRule.PARALLEL,
                  local_initialization_method=InitMethod.ODOMETRY,
                  relative_change_tolerance=1e-2, RTR_gradnorm_tol=0.5, dtype="float64")
prob = LiftedProblem.from_data(data, r=5, dtype=np.float64)
eng = RBCDEngine(prob, cfg)
st0 = eng.initialize()
sp = spmd.ShardedProblem.build(prob, np.asarray(st0.X), np.asarray(eng.robot_colors),
                               num_devices=8, dtype=np.float64)
st, step = spmd.build_spmd_step(sp, Mesh(np.array(jax.devices()[:8]), ("robots",)), cfg)
for it in range(60):
    st = step(np.int32(it), np.int32(0), st)
    st.X.block_until_ready()
Xg = spmd.gather_trajectory(sp, st, prob.num_poses)
print("JAX_SPMD " + json.dumps({
    "final_cost": float(quadratic.cost(np.asarray(Xg, np.float64), eng._edges(st0.weights))),
    "colors": np.asarray(eng.robot_colors).tolist(), "ylift": np.asarray(eng.Ylift).tolist()}))
'''


def test_spmd_eight_slots_matches_jax():
    args = dict(roofline.STAND_INS["smallGrid3D"], num_robots=8)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    p = subprocess.run([sys.executable, "-c", JAX_SPMD, str(REPO), json.dumps(args)],
                       capture_output=True, text=True, env=env, timeout=600)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("JAX_SPMD ")]
    assert p.returncode == 0 and lines, p.stderr[-4000:]
    ref = json.loads(lines[-1].split(" ", 1)[1])
    got = exp_spmd.run("smallGrid3D", 8, 60, "cpu", "float64", ylift=np.asarray(ref["ylift"]))
    assert got["final_cost"] == pytest.approx(ref["final_cost"], rel=TOL_COST)
    assert got["colors"] == ref["colors"]
    assert got["active_slot_steps"] == sum(
        int((np.asarray(got["colors"]) == it % got["num_colors"]).sum()) for it in range(60))
