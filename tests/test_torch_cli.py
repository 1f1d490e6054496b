"""The port's CLI end to end on CPU, and its import boundary.

The solve itself is pinned to the JAX engine by test_torch_engine.py; here
the CLI's run is checked against the port's engine driven directly, and
the process-level contracts are checked in subprocesses: importing the
port loads no jax, and ``--device cuda`` without a card exits nonzero.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dpgo_ros_tpu.io.synthetic import generate_world
from dpgo_ros_tpu.utils.config import AgentConfig, InitMethod, UpdateRule
from dpgo_ros_tpu_torch import cli
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from torch_parity import port_config  # (and one torch thread per test process)

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--synthetic", "grid3d", "--synthetic_n", "64", "--num_robots", "2",
         "--device", "cpu", "--dtype", "float64"]


def _subprocess(code: str, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-c", code, *args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )


@pytest.mark.parametrize("rule", ["RoundRobin", "Parallel"])
def test_cli_end_to_end_matches_engine(tmp_path, rule, capsys):
    prefix = str(tmp_path / "sol")
    argv = SMALL + ["--demo", "dpgo_demo", "--update_rule", rule,
                    "--output", prefix]
    assert cli.main(argv) == 0
    out, err = capsys.readouterr()
    summary = json.loads(out.strip().splitlines()[-1])
    assert set(summary) >= {"iterations", "final_cost", "wall_time_sec",
                            "ate_vs_ground_truth"}
    timing = json.loads(err.split("timing_sec ", 1)[1].splitlines()[0])
    assert set(timing) == {"init", "solve", "rounding", "export", "tcg_iterations",
                           "counters"}
    assert timing["tcg_iterations"] >= summary["iterations"]
    for suffix in ["_global.g2o", "_robot0.tum", "_robot1.tum", ".html"]:
        assert Path(prefix + suffix).stat().st_size > 0
    assert math.isfinite(summary["ate_vs_ground_truth"])

    # the same run through the engine API (dpgo_demo preset values, with
    # --num_robots 2 and the selected rule)
    data, _, _ = generate_world("grid3d", grid_shape=(4, 4, 4), num_robots=2, seed=42)
    prob = LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu")
    eng = RBCDEngine(prob, port_config(AgentConfig(
        num_robots=2, update_rule=UpdateRule(rule),
        local_initialization_method=InitMethod.CHORDAL,
        relative_change_tolerance=0.2, RTR_gradnorm_tol=0.5, dtype="float64",
    )))
    st0 = eng.initialize()
    st, info = eng.run(st0)
    assert summary["iterations"] == info["iterations"]
    assert summary["final_cost"] == pytest.approx(info["final_cost"], rel=1e-12)
    assert info["final_cost"] < float(st0.cost)


def test_demo_preset_yields_to_explicit_flags():
    p = cli.build_parser()
    a = p.parse_args(["--demo", "dpgo_demo", "--num_robots", "3",
                      "--relative_change_tolerance", "0.05"])
    cli.apply_demo(a, p)
    assert (a.num_robots, a.relative_change_tolerance) == (3, 0.05)
    assert (a.update_rule, a.local_initialization_method) == ("RoundRobin", "Chordal")
    assert (a.RTR_gradnorm_tol, a.dataset) == (0.5, "sphere2500")


def test_import_and_run_load_no_jax():
    code = (
        "import sys\n"
        "import dpgo_ros_tpu_torch, dpgo_ros_tpu_torch.cli\n"
        "import dpgo_ros_tpu_torch.parallel.rbcd, dpgo_ros_tpu_torch.ops.fused_rtr\n"
        "assert 'jax' not in sys.modules, 'import loaded jax'\n"
        "dpgo_ros_tpu_torch.cli.run(sys.argv[1:])\n"
        "assert 'jax' not in sys.modules, 'run loaded jax'\n"
        "print('JAX_FREE')\n"
    )
    proc = _subprocess(code, *SMALL, "--max_iteration_number", "2")
    assert proc.returncode == 0, proc.stderr
    assert "JAX_FREE" in proc.stdout


def test_fused_gnc_run_loads_no_jax():
    code = (
        "import sys\n"
        "import dpgo_ros_tpu_torch.cli, dpgo_ros_tpu_torch.models.robust\n"
        "dpgo_ros_tpu_torch.cli.run(sys.argv[1:])\n"
        "assert 'jax' not in sys.modules, 'run loaded jax'\n"
        "print('JAX_FREE')\n"
    )
    proc = _subprocess(code, *SMALL, "--mode", "fused", "--robust_cost_type",
                       "GNC_TLS", "--robust_opt_num_weight_updates", "1",
                       "--robust_opt_inner_iters_per_robot", "2",
                       "--update_rule", "RoundRobin")
    assert proc.returncode == 0, proc.stderr
    assert "JAX_FREE" in proc.stdout


def test_cuda_without_card_exits_nonzero():
    proc = _subprocess(
        "import sys, torch\n"
        "assert not torch.cuda.is_available()\n"
        "from dpgo_ros_tpu_torch import cli\n"
        "sys.exit(cli.main(sys.argv[1:]))\n",
        "--demo", "dpgo_demo", "--synthetic", "sphere", "--synthetic_n", "100",
    )
    if "AssertionError" in proc.stderr:
        pytest.skip("this machine has a CUDA device")
    assert proc.returncode == 2
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""


def test_usage_error_without_input():
    with pytest.raises(SystemExit) as exc:
        cli.run(["--device", "cpu"])
    assert exc.value.code == 2


SPHERE = ["--demo", "dpgo_demo", "--synthetic", "sphere", "--synthetic_n", "256",
          "--device", "cpu"]


def test_fused_and_engine_modes_agree():
    """--mode fused (one K2 call) and --mode engine (one K1 call per block
    update) run the same steps."""
    s_e, x_e = cli.run(SPHERE + ["--mode", "engine"])
    s_f, x_f = cli.run(SPHERE + ["--mode", "fused"])
    assert (s_e["mode"], s_f["mode"]) == ("engine", "fused")
    assert s_f["iterations"] == s_e["iterations"] > 0
    assert s_f["final_cost"] == pytest.approx(s_e["final_cost"], rel=1e-6)
    assert x_f["timing_sec"]["tcg_iterations"] == x_e["timing_sec"]["tcg_iterations"]
    assert s_f["ate_vs_ground_truth"] == pytest.approx(s_e["ate_vs_ground_truth"], rel=1e-5)


def test_gnc_demo_reports_outliers(capsys):
    argv = ["--demo", "dpgo_gnc_demo", "--synthetic", "sphere", "--synthetic_n",
            "256", "--synthetic_outlier_ratio", "0.2", "--device", "cpu"]
    assert cli.main(argv) == 0
    out, _ = capsys.readouterr()
    summary = json.loads(out.strip().splitlines()[-1])
    gs, og = summary["gnc_stats"], summary["outlier_ground_truth"]
    assert set(gs) == {"accepted", "rejected", "undecided", "convergence_ratio"}
    assert og["planted"] == 48  # 20 % of the 240 loop closures
    assert og["rejected_true"] + og["missed"] == og["planted"]
    assert og["rejected_true"] >= 0.9 * og["planted"]
    assert og["rejected_false"] <= 0.1 * (240 - og["planted"])
    assert math.isfinite(summary["ate_vs_ground_truth"])


def test_gnc_demo_preset_yields_to_explicit_flags():
    p = cli.build_parser()
    a = p.parse_args(["--demo", "dpgo_gnc_demo", "--robust_opt_inner_tol", "0.3",
                      "--num_robots", "4"])
    cli.apply_demo(a, p)
    assert (a.num_robots, a.robust_opt_inner_tol) == (4, 0.3)
    assert (a.robust_cost_type, a.GNC_barc, a.GNC_use_probability) == ("GNC_TLS", 3.0, False)
    assert (a.robust_opt_num_weight_updates, a.robust_opt_num_resets) == (3, 3)
    assert (a.local_initialization_method, a.dataset) == ("Odometry", None)


@pytest.mark.parametrize("mode", ["engine", "fused"])
def test_log_directory_writes_per_robot_csvs(tmp_path, mode):
    argv = SMALL + ["--robust_cost_type", "GNC_TLS", "--robust_opt_num_weight_updates",
                    "1", "--robust_opt_inner_iters_per_robot", "2",
                    "--update_rule", "RoundRobin", "--mode", mode,
                    "--log_directory", str(tmp_path)]
    summary, extras = cli.run(argv)
    assert extras["weight_rounds"] == 1
    for k in range(2):
        (path,) = (tmp_path / f"agent{k}").glob("dpgo_log_*.csv")
        lines = path.read_text().splitlines()
        rows = [ln for ln in lines[1:] if ln.count(",") > 2]
        assert len(rows) == summary["iterations"]
        assert f"{k},UPDATE_WEIGHT" in lines and lines[-1] == f"{k},TERMINATE"


def test_gnc_demo_without_synthetic_loads_tunnels():
    """Without --synthetic the GNC demo reads the tunnels dataset, as the
    JAX CLI does; where the data is absent that fails."""
    p = cli.build_parser()
    a = p.parse_args(["--demo", "dpgo_gnc_demo", "--device", "cpu"])
    cli.apply_demo(a, p)
    from dpgo_ros_tpu_torch.io.datasets import tunnels_paths

    if all(os.path.exists(q) for q in tunnels_paths(None, 8)):
        data, gt, planted = cli.load_data(a)
        assert data.num_robots == 8 and gt is None and planted is None
    else:
        with pytest.raises(OSError):
            cli.load_data(a)


SPMD_FLAGS = ("mode", "use_fused_kernel", "spmd_steps_per_launch",
              "spmd_stretch_rgd_stepsize", "spmd_separator_only", "spmd_repartition",
              "checkpoint_dir", "checkpoint_every", "resume")


def test_spmd_and_checkpoint_flags_have_jax_defaults():
    from dpgo_ros_tpu import cli as jax_cli

    jp, tp = jax_cli.build_parser(), cli.build_parser()
    acts = lambda p: {a.dest: a for a in p._actions}
    ja, ta = acts(jp), acts(tp)
    for d in SPMD_FLAGS:
        assert d in ta, d
        assert ta[d].default == ja[d].default, d
        if d not in ("mode", "use_fused_kernel"):  # the port's kernels are CUDA's
            assert ta[d].help == ja[d].help, d
    assert "spmd" in ta["mode"].choices


def test_spmd_summary_matches_jax_cli(capsys):
    """``--mode spmd`` at 5 slots (the port's local slots; the JAX CLI's 8
    CPU devices, 5 robots): JAX's summary keys, the same launches and
    iterations, final cost within rel 1e-4 (fp32)."""
    from dpgo_ros_tpu import cli as jax_cli
    from dpgo_ros_tpu_torch.parallel import multihost

    argv = ["--demo", "dpgo_demo", "--synthetic", "sphere", "--synthetic_n", "500",
            "--mode", "spmd"]
    assert jax_cli.main(argv + ["--platform", "cpu"]) == 0
    jax_summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    try:
        multihost.initialize("localhost:1", 1, 0, local_slot_count=8, device="cpu")
        summary, extras = cli.run(argv + ["--device", "cpu"])
    finally:
        multihost.shutdown()
    assert set(summary) == set(jax_summary)
    assert summary["devices"] == jax_summary["devices"] == 5
    for k in ("mode", "iterations", "launches"):
        assert summary[k] == jax_summary[k], k
    assert summary["final_cost"] == pytest.approx(jax_summary["final_cost"], rel=1e-4)
    assert math.isfinite(extras["ate_vs_ground_truth"])
    assert extras["block_updates"] > 0 and extras["exchange_bytes"] > 0


def test_spmd_run_loads_no_jax():
    code = (
        "import sys\n"
        "import dpgo_ros_tpu_torch.cli\n"
        "import dpgo_ros_tpu_torch.parallel.spmd, dpgo_ros_tpu_torch.parallel.multihost\n"
        "import dpgo_ros_tpu_torch.utils.checkpoint\n"
        "import dpgo_ros_tpu_torch.scripts.multihost_demo\n"
        "s, _ = dpgo_ros_tpu_torch.cli.run(sys.argv[1:])\n"
        "assert 'jax' not in sys.modules, 'run loaded jax'\n"
        "print('JAX_FREE', sorted(s))\n"
    )
    proc = _subprocess(code, "--synthetic", "grid3d", "--synthetic_n", "64",
                       "--num_robots", "2", "--device", "cpu", "--mode", "spmd",
                       "--max_iteration_number", "4")
    assert proc.returncode == 0, proc.stderr
    assert ("JAX_FREE ['devices', 'final_cost', 'iterations', 'launches', 'mode', "
            "'wall_time_sec']") in proc.stdout
