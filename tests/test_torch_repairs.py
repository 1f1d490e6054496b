"""The port's CLI and engine against the JAX package where they used to
differ.

1. The Uniform update rule: the port's engine (K4's windowed route, plain
   version) and its fused runner (K2's plain version) against the JAX
   fp64 XLA engine and fused runner, under JAX's own schedule
   (``randint(fold_in(PRNGKey(seed), it))``, computed here and passed in):
   cost and rel-change histories, X and the final cost to 1e-7 (fp64,
   different sum orders only). The port's own draw comes from a
   ``torch.Generator`` seeded with ``config.seed``; a longer draw extends a
   shorter one, and the engine and the fused runner take the same one.
2. Every flag both CLIs define has the same default (the port's
   ``--update_rule`` defaults to Uniform, as JAX's does), the
   acceleration, certificate, fleet (``--mode``, ``--frontend``) and
   protocol flags included.
3. The GNC demo's ``--output`` HTML view, loop-closure overlay included,
   is byte-equal between the two CLIs on one small synthetic GNC world
   (fp64 on both sides; the SVG rounds coordinates to 0.1 px).
4. The JAX flags the port used to reject (``--relaxation_rank``,
   ``--dimension``, ``--partition_balance``, ``--synthetic_rot_noise``,
   ``--synthetic_trans_noise``, ``--multirobot_initialization``): one JAX
   command line each, on CPU at a small size, gives the JAX summary's
   ``final_cost`` on the port (fp64, rel 1e-7).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_ros_tpu import cli as jax_cli
from dpgo_ros_tpu.models.problem import LiftedProblem as JaxProblem
from dpgo_ros_tpu.parallel.rbcd import RBCDEngine as JaxEngine
from dpgo_ros_tpu.utils.config import AgentConfig, InitMethod, UpdateRule
from dpgo_ros_tpu_torch import cli
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from torch_parity import port_config, rel_err, world


def _jax_schedule(seed: int, R: int, upto: int):
    key0 = jax.random.PRNGKey(seed)
    return [int(jax.random.randint(jax.random.fold_in(key0, i), (), 0, R))
            for i in range(upto)]


def _uniform_cfg(**kw):
    return AgentConfig(
        num_robots=3, update_rule=UpdateRule.UNIFORM,
        local_initialization_method=InitMethod.CHORDAL, RTR_gradnorm_tol=0.5,
        relative_change_tolerance=0.0, dtype="float64", seed=7, **kw,
    )


@pytest.fixture(scope="module")
def sphere64():
    data, _ = world("sphere256")
    return (data, JaxProblem.from_data(data, r=5, dtype=jnp.float64),
            LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu"))


def test_uniform_engine_matches_jax_under_its_schedule(sphere64):
    _, jp, tp = sphere64
    cfg, cap = _uniform_cfg(), 12
    je = JaxEngine(jp, cfg)
    js, jinfo = je.run(je.initialize(), max_iters=cap)
    sched = _jax_schedule(cfg.seed, 3, cap)
    assert len(set(sched)) > 1 and sched != [i % 3 for i in range(cap)]
    te = RBCDEngine(tp, port_config(cfg))
    ts, tinfo = te.run(te.initialize(ylift=np.asarray(je.Ylift)), max_iters=cap,
                       schedule=sched)
    assert tinfo["iterations"] == jinfo["iterations"] == cap
    jh, th = jinfo["history"], tinfo["history"]
    assert rel_err(th["cost"], jh["cost"]) < 1e-7
    assert rel_err(th["rel_change"], jh["rel_change"]) < 1e-7
    assert rel_err(np.stack(th["rel_change_robots"]),
                   np.stack(jh["rel_change_robots"])) < 1e-7
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) < 1e-7
    assert float(ts.cost) == pytest.approx(float(js.cost), rel=1e-7)


def test_uniform_fused_runner_matches_jax_under_its_schedule(sphere64):
    _, jp, tp = sphere64
    cfg, cap = _uniform_cfg(), 10
    je = JaxEngine(jp, cfg)
    js = je.make_fused_run(cap)(je.initialize())
    te = RBCDEngine(tp, port_config(cfg))
    ts = te.make_fused_run(cap, schedule=_jax_schedule(cfg.seed, 3, cap))(
        te.initialize(ylift=np.asarray(je.Ylift)))
    assert ts.iteration == int(js.iteration) == cap
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) < 1e-7
    assert float(ts.cost) == pytest.approx(float(js.cost), rel=1e-7)
    assert rel_err(ts.rel_change.numpy(), np.asarray(js.rel_change)) < 1e-7


def test_uniform_draw_is_seeded_and_shared_by_both_runners(sphere64):
    _, _, tp = sphere64
    eng = RBCDEngine(tp, port_config(_uniform_cfg()))
    long, short = eng.update_schedule(40), eng.update_schedule(9)
    np.testing.assert_array_equal(long[:9], short)
    assert set(long.tolist()) == {0, 1, 2}
    other = RBCDEngine(tp, port_config(dataclasses.replace(_uniform_cfg(), seed=8)))
    assert not np.array_equal(other.update_schedule(40), long)
    _, sched = eng.mask_bank_and_schedule(40)
    np.testing.assert_array_equal(sched.numpy(), long)
    st0 = eng.initialize(ylift=np.eye(5, 3))
    s_e, _ = eng.run(st0, max_iters=6)
    s_f = eng.make_fused_run(6)(st0)
    assert rel_err(s_f.X.numpy(), s_e.X.numpy()) < 1e-9
    with pytest.raises(ValueError):
        eng.update_schedule(5, schedule=[0, 1, 3, 0, 1])  # robot 3 of 3
    with pytest.raises(ValueError):
        eng.update_schedule(5, schedule=[0, 1])  # too short


def test_shared_flags_have_the_same_defaults():
    jp, tp = jax_cli.build_parser(), cli.build_parser()
    dests = lambda p: {a.dest for a in p._actions if a.dest != "help"}
    shared = dests(jp) & dests(tp)
    assert {"update_rule", "relaxation_rank", "dimension", "partition_balance",
            "synthetic_rot_noise", "synthetic_trans_noise",
            "multirobot_initialization", "visualize_loop_closures",
            "acceleration", "restart_interval", "certify", "mode", "frontend",
            "timeout_threshold", "enable_recovery", "synchronize_measurements",
            "max_distributed_init_steps", "weight_convergence_threshold",
            "spmd_steps_per_launch", "spmd_stretch_rgd_stepsize",
            "spmd_separator_only", "spmd_repartition", "use_fused_kernel",
            "checkpoint_dir", "checkpoint_every", "resume"} <= shared
    differ = {d: (jp.get_default(d), tp.get_default(d)) for d in sorted(shared)
              if jp.get_default(d) != tp.get_default(d)}
    assert differ == {}
    assert tp.get_default("update_rule") == "Uniform"


GNC_SMALL = ["--demo", "dpgo_gnc_demo", "--synthetic", "sphere", "--synthetic_n",
             "256", "--synthetic_outlier_ratio", "0.2", "--num_robots", "4",
             "--robust_opt_inner_iters_per_robot", "3", "--dtype", "float64"]


def test_gnc_demo_html_is_byte_equal_to_jax(tmp_path, capsys):
    jpre, tpre = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_cli.main(GNC_SMALL + ["--platform", "cpu", "--output", jpre]) == 0
    jsum = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tsum, _ = cli.run(GNC_SMALL + ["--device", "cpu", "--output", tpre])
    assert tsum["iterations"] == jsum["iterations"]
    assert tsum["gnc_stats"] == jsum["gnc_stats"]
    html = open(jpre + ".html", "rb").read()
    assert html.count(b"<line ") > 0  # the loop-closure overlay is drawn
    assert open(tpre + ".html", "rb").read() == html


SMALL = ["--synthetic", "sphere", "--synthetic_n", "120", "--num_robots", "3",
         "--max_iteration_number", "8", "--relative_change_tolerance", "0",
         "--update_rule", "RoundRobin", "--dtype", "float64"]


@pytest.mark.parametrize("flags", [
    ["--relaxation_rank", "4"],
    ["--dimension", "3"],
    ["--partition_balance", "work"],
    ["--synthetic_rot_noise", "0.03"],
    ["--synthetic_trans_noise", "0.2"],
    ["--multirobot_initialization", "false"],
], ids=lambda f: f[0].lstrip("-"))
def test_jax_flag_gives_the_jax_final_cost(flags, capsys):
    assert jax_cli.main(SMALL + flags + ["--platform", "cpu"]) == 0
    jsum = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tsum, _ = cli.run(SMALL + flags + ["--device", "cpu"])
    base, _ = cli.run(SMALL + ["--device", "cpu"])
    assert tsum["iterations"] == jsum["iterations"]
    assert tsum["final_cost"] == pytest.approx(jsum["final_cost"], rel=1e-7)
    assert tsum["final_cost"] != base["final_cost"] or flags[0] == "--dimension"
