"""Command-line entry point of the PyTorch/CUDA port.

Demo presets mirror the reference launch files:

* ``dpgo_demo`` — 5 robots, synchronous RBCD, RoundRobin, chordal init,
  rel-change tol 0.2, RTR 3×50 with gradnorm tol 0.5
  (``launch/dpgo_demo.launch``; sphere2500 unless another source is given);
* ``dpgo_gnc_demo`` — 8 robots, GNC_TLS with barc 3.0, 3 weight rounds × 50
  inner iterations per robot, 3 resets, odometry init, rounds fired on
  inner convergence (``robust_opt_inner_tol`` 0.15, as the JAX CLI does)
  (``launch/dpgo_gnc_demo.launch``; the tunnels dataset unless another
  source is given).

``--mode engine`` runs the host-driven loop, one launch of the CUDA
block-solve kernel (K1) per block update; ``--mode fused`` runs one launch
of the multi-step kernel (K2) per stretch between GNC weight rounds (one
launch in all for an L2 run). On ``--device cpu`` both run the kernels'
plain versions.

Examples::

  python -m dpgo_ros_tpu_torch.cli --demo dpgo_demo --synthetic sphere \\
      --synthetic_n 2500 --mode fused --output /tmp/out
  python -m dpgo_ros_tpu_torch.cli --demo dpgo_gnc_demo --synthetic sphere \\
      --synthetic_n 2500 --synthetic_outlier_ratio 0.1
  python -m dpgo_ros_tpu_torch.cli --synthetic grid3d --synthetic_n 64 \\
      --num_robots 2 --device cpu --dtype float64

Prints one JSON summary line on stdout (``mode``, ``iterations``,
``final_cost``, ``wall_time_sec``; ``gnc_stats`` for robust costs; for
synthetic worlds ``ate_vs_ground_truth`` and, with planted outliers,
``outlier_ground_truth``) and the time split between init, solve,
rounding and export, with the solve's tCG iterations, on stderr. Exits 2
on usage errors, including ``--device cuda`` without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, Tuple

import numpy as np
import torch


def _bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dpgo_ros_tpu_torch",
        description="distributed pose-graph optimization (PyTorch/CUDA port)",
    )
    p.add_argument("--demo", choices=["dpgo_demo", "dpgo_gnc_demo"])
    p.add_argument("--g2o", help="path to a g2o dataset file")
    p.add_argument("--dataset", help="bundled dataset name (e.g. sphere2500)")
    p.add_argument(
        "--synthetic", choices=["sphere", "grid3d"],
        help="generate a synthetic world with exact ground truth instead "
             "of loading a dataset (takes precedence over --dataset)",
    )
    p.add_argument("--synthetic_n", type=int, default=1000,
                   help="number of poses (sphere) / lattice size n^(1/3) "
                        "rounded (grid3d)")
    p.add_argument("--synthetic_outlier_ratio", type=float, default=0.0,
                   help="share of the synthetic world's loop closures "
                        "replaced by gross outliers (exact labels)")
    p.add_argument("--mode", choices=["engine", "fused"], default="engine",
                   help="engine: one block-solve launch per update; fused: "
                        "one multi-step launch per GNC stretch")
    p.add_argument("--output", help="output prefix for trajectory export")
    p.add_argument("--log_directory",
                   help="write the reference's per-robot telemetry CSVs here")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    p.add_argument("--num_robots", type=int, default=1)
    p.add_argument("--RTR_iterations", type=int, default=3)
    p.add_argument("--RTR_tCG_iterations", type=int, default=50)
    p.add_argument("--RTR_gradnorm_tol", type=float, default=1e-2)
    p.add_argument("--local_initialization_method",
                   choices=["Odometry", "Chordal", "GNC_TLS"], default="Odometry")
    p.add_argument("--update_rule", choices=["RoundRobin", "Parallel"],
                   default="RoundRobin")
    p.add_argument("--robust_cost_type",
                   choices=["L2", "L1", "Huber", "TLS", "GM", "GNC_TLS"],
                   default="L2")
    p.add_argument("--GNC_use_probability", type=_bool, default=True)
    p.add_argument("--GNC_quantile", type=float, default=0.9)
    p.add_argument("--GNC_barc", type=float, default=5.0)
    p.add_argument("--GNC_mu_step", type=float, default=2.0)
    p.add_argument("--GNC_init_mu", type=float, default=1e-5)
    p.add_argument("--GNC_schedule", choices=["adaptive", "geometric", "reference"],
                   default="adaptive")
    p.add_argument("--GNC_mu_start", type=float, default=0.05)
    p.add_argument("--GNC_mu_end", type=float, default=1e3)
    p.add_argument("--gnc_finalize_by_residual", type=_bool, default=True)
    p.add_argument("--robust_opt_num_weight_updates", type=int, default=4)
    p.add_argument("--robust_opt_num_resets", type=int, default=0)
    p.add_argument("--robust_opt_min_convergence_ratio", type=float, default=0.0)
    p.add_argument("--robust_opt_inner_iters_per_robot", type=int, default=10)
    p.add_argument("--robust_opt_inner_tol", type=float, default=None,
                   help="fire weight rounds once every robot's rel change is "
                        "below this (the fixed cadence stays as a cap)")
    p.add_argument("--robust_init_min_inliers", type=int, default=5)
    p.add_argument("--max_iteration_number", type=int, default=1000)
    p.add_argument("--relative_change_tolerance", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=42)
    return p


def apply_demo(a, parser) -> None:
    """Apply the demo preset where the flag still holds its default, so
    explicit flags win."""
    if a.demo == "dpgo_demo":
        preset = dict(
            dataset=a.dataset or "sphere2500",
            num_robots=5,
            update_rule="RoundRobin",
            local_initialization_method="Chordal",
            relative_change_tolerance=0.2,
            RTR_gradnorm_tol=0.5,
        )
    elif a.demo == "dpgo_gnc_demo":
        preset = dict(
            num_robots=8,
            robust_cost_type="GNC_TLS",
            GNC_use_probability=False,
            GNC_barc=3.0,
            robust_init_min_inliers=3,
            robust_opt_num_weight_updates=3,
            robust_opt_num_resets=3,
            robust_opt_inner_iters_per_robot=50,
            robust_opt_inner_tol=0.15,
            update_rule="RoundRobin",
            local_initialization_method="Odometry",
            relative_change_tolerance=0.2,
            RTR_gradnorm_tol=0.5,
        )
    else:
        return
    for k, v in preset.items():
        if getattr(a, k) == parser.get_default(k):
            setattr(a, k, v)


def args_to_config(a):
    from dpgo_ros_tpu.utils.config import (
        AgentConfig,
        InitMethod,
        RobustCostType,
        UpdateRule,
    )

    return AgentConfig(
        num_robots=a.num_robots,
        robust_cost_type=RobustCostType(a.robust_cost_type),
        GNC_use_probability=a.GNC_use_probability,
        GNC_quantile=a.GNC_quantile,
        GNC_barc=a.GNC_barc,
        GNC_mu_step=a.GNC_mu_step,
        GNC_init_mu=a.GNC_init_mu,
        GNC_schedule=a.GNC_schedule,
        GNC_mu_start=a.GNC_mu_start,
        GNC_mu_end=a.GNC_mu_end,
        gnc_finalize_by_residual=a.gnc_finalize_by_residual,
        robust_opt_num_weight_updates=a.robust_opt_num_weight_updates,
        robust_opt_num_resets=a.robust_opt_num_resets,
        robust_opt_min_convergence_ratio=a.robust_opt_min_convergence_ratio,
        robust_opt_inner_iters_per_robot=a.robust_opt_inner_iters_per_robot,
        robust_opt_inner_tol=a.robust_opt_inner_tol,
        robust_init_min_inliers=a.robust_init_min_inliers,
        RTR_iterations=a.RTR_iterations,
        RTR_tCG_iterations=a.RTR_tCG_iterations,
        RTR_gradnorm_tol=a.RTR_gradnorm_tol,
        local_initialization_method=InitMethod(a.local_initialization_method),
        update_rule=UpdateRule(a.update_rule),
        max_iteration_number=a.max_iteration_number,
        relative_change_tolerance=a.relative_change_tolerance,
        dtype=a.dtype,
        seed=a.seed,
    )


def load_data(a):
    """(data, ground truth or None, planted-outlier mask or None) for the
    selected source."""
    if a.synthetic:
        from dpgo_ros_tpu.io.synthetic import generate_world

        kw = dict(n=a.synthetic_n)
        if a.synthetic == "grid3d":
            side = max(2, round(a.synthetic_n ** (1.0 / 3.0)))
            kw = dict(grid_shape=(side, side, side))
        return generate_world(
            a.synthetic, num_robots=a.num_robots, seed=a.seed,
            outlier_ratio=a.synthetic_outlier_ratio, **kw
        )
    if a.g2o:
        from dpgo_ros_tpu.io.partition import partition_g2o

        return partition_g2o(a.g2o, a.num_robots), None, None
    if a.dataset:
        from dpgo_ros_tpu.io.datasets import load_g2o_dataset

        return load_g2o_dataset(a.dataset, num_robots=a.num_robots), None, None
    if a.demo == "dpgo_gnc_demo":
        from dpgo_ros_tpu.io.datasets import load_tunnels

        return load_tunnels(num_robots=a.num_robots), None, None
    return None, None, None


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()


def run(argv=None) -> Tuple[Dict, Dict]:
    """Parse, solve, export. Returns (summary, extras): the JSON summary and
    ``{"timing_sec": {init, solve, rounding, export, tcg_iterations},
    "initial_cost", "block_updates", "weight_rounds", "weights"}`` (the
    final weights as numpy). Raises SystemExit(2) on usage errors."""
    parser = build_parser()
    a = parser.parse_args(argv)
    apply_demo(a, parser)
    if a.device == "cuda" and not torch.cuda.is_available():
        parser.exit(2, "error: --device cuda but no CUDA device is available\n")
    data, gt, planted = load_data(a)
    if data is None:
        parser.exit(2, "error: provide --demo, --synthetic, --dataset or --g2o\n")

    from dpgo_ros_tpu.utils import export
    from dpgo_ros_tpu.utils.config import RobustCostType
    from dpgo_ros_tpu_torch.models.problem import LiftedProblem
    from dpgo_ros_tpu_torch.ops import rounding
    from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine

    cfg = dataclasses.replace(args_to_config(a), num_robots=data.num_robots)
    device = torch.device(a.device)
    dtype = torch.float64 if a.dtype == "float64" else torch.float32

    t0 = _clock(device)
    prob = LiftedProblem.from_data(
        data, r=cfg.relaxation_rank, dtype=dtype, device=device
    )
    eng = RBCDEngine(prob, cfg)
    st = eng.initialize()
    initial_cost = float(st.cost)
    t1 = _clock(device)
    if a.mode == "fused":
        # the engine's resolved config carries the GNC iteration budget
        record = bool(a.log_directory)
        out = eng.make_fused_run(eng.config.max_iteration_number,
                                 record=record, return_stats=True)(st)
        st, tcg = out[0], out[-1]
        info = {"iterations": st.iteration, "final_cost": float(st.cost),
                "tcg_iterations": tcg}
        if eng.config.robust_cost_type != RobustCostType.L2:
            info.update(eng.gnc_info(st.weights))
        rows, events = None, []
        if record:
            rows = out[1][:st.iteration].cpu().numpy()
            events = [(int(i), "UPDATE_WEIGHT") for i in np.flatnonzero(out[2].numpy())]
    else:
        st, info = eng.run(st)
        h = info["history"]
        rows = np.stack(h["rel_change_robots"]) if h["rel_change_robots"] else None
        iter_times, events = h["iter_time_sec"], h["event"]
    t2 = _clock(device)
    if rows is not None and a.mode == "fused":
        # one launch per stretch, no per-iteration host clock: the mean
        iter_times = np.full(len(rows), (t2 - t1) / max(len(rows), 1))
    T, st = eng.finalize(st)
    summary = {
        "mode": a.mode,
        "device": a.device,
        "iterations": info["iterations"],
        "final_cost": info["final_cost"],
    }
    if "gnc_stats" in info:
        summary["gnc_stats"] = info["gnc_stats"]
    weights = st.weights.cpu().numpy()
    if gt is not None:
        summary["ate_vs_ground_truth"] = float(rounding.ate_translation(
            torch.as_tensor(T, dtype=torch.float64, device=device),
            torch.as_tensor(gt, dtype=torch.float64, device=device),
        ))
    if planted is not None and planted.any():
        rej = weights[: len(planted)] < 0.5
        loops = np.asarray(data.measurements.edge_type) != 0
        summary["outlier_ground_truth"] = {
            "planted": int(planted.sum()),
            "rejected_true": int((rej & planted).sum()),
            "rejected_false": int((rej & loops & ~planted).sum()),
            "missed": int((~rej & planted).sum()),
        }
    t3 = _clock(device)
    summary["wall_time_sec"] = round(t3 - t0, 3)
    if a.output:
        export.export_solution(
            a.output, T, data.num_poses, data.measurements,
            weights[: len(data.measurements)], show_loops=False,
        )
        print(f"wrote {a.output}_global.g2o and per-robot TUM files",
              file=sys.stderr)
    if a.log_directory and rows is not None and len(rows):
        from dpgo_ros_tpu.utils import telemetry

        telemetry.write_run_logs(
            a.log_directory, problem=prob, rel_change_rows=rows,
            iter_times=iter_times, events=events,
        )
        print(f"per-agent telemetry CSVs in {a.log_directory}", file=sys.stderr)
    t4 = time.time()
    timing = {"init": t1 - t0, "solve": t2 - t1, "rounding": t3 - t2,
              "export": t4 - t3, "tcg_iterations": info["tcg_iterations"]}
    print("timing_sec " + json.dumps(timing), file=sys.stderr)
    return summary, {
        "timing_sec": timing,
        "initial_cost": initial_cost,
        "block_updates": info["iterations"],
        "weight_rounds": st.weight_update_count,
        "weights": weights,
    }


def main(argv=None) -> int:
    summary, _ = run(argv)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
