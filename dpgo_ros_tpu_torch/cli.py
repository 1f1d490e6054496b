"""Command-line entry point of the PyTorch/CUDA port (engine mode).

The ``dpgo_demo`` preset mirrors the reference launch file: 5 robots,
synchronous RBCD, RoundRobin, chordal init, rel-change tol 0.2, RTR 3×50
with gradnorm tol 0.5. On ``--device cuda`` (the default) every block
update is one launch of the CUDA block-solve kernel.

Examples::

  python -m dpgo_ros_tpu_torch.cli --demo dpgo_demo --synthetic sphere \\
      --synthetic_n 2500 --output /tmp/out
  python -m dpgo_ros_tpu_torch.cli --synthetic grid3d --synthetic_n 64 \\
      --num_robots 2 --device cpu --dtype float64

Prints one JSON summary line on stdout (``iterations``, ``final_cost``,
``wall_time_sec`` and, for synthetic worlds, ``ate_vs_ground_truth``) and
the time split between init, solve, rounding and export on stderr. Exits 2
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dpgo_ros_tpu_torch",
        description="distributed pose-graph optimization (PyTorch/CUDA port)",
    )
    p.add_argument("--demo", choices=["dpgo_demo"])
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
    p.add_argument("--output", help="output prefix for trajectory export")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    p.add_argument("--num_robots", type=int, default=1)
    p.add_argument("--RTR_iterations", type=int, default=3)
    p.add_argument("--RTR_tCG_iterations", type=int, default=50)
    p.add_argument("--RTR_gradnorm_tol", type=float, default=1e-2)
    p.add_argument("--local_initialization_method",
                   choices=["Odometry", "Chordal"], default="Odometry")
    p.add_argument("--update_rule", choices=["RoundRobin", "Parallel"],
                   default="RoundRobin")
    p.add_argument("--max_iteration_number", type=int, default=1000)
    p.add_argument("--relative_change_tolerance", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=42)
    return p


def apply_demo(a, parser) -> None:
    """Apply the demo preset where the flag still holds its default, so
    explicit flags win."""
    if a.demo != "dpgo_demo":
        return
    preset = dict(
        dataset=a.dataset or "sphere2500",
        num_robots=5,
        update_rule="RoundRobin",
        local_initialization_method="Chordal",
        relative_change_tolerance=0.2,
        RTR_gradnorm_tol=0.5,
    )
    for k, v in preset.items():
        if getattr(a, k) == parser.get_default(k):
            setattr(a, k, v)


def args_to_config(a):
    from dpgo_ros_tpu.utils.config import AgentConfig, InitMethod, UpdateRule

    return AgentConfig(
        num_robots=a.num_robots,
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
    """(data, ground truth or None) for the selected source."""
    if a.synthetic:
        from dpgo_ros_tpu.io.synthetic import generate_world

        kw = dict(n=a.synthetic_n)
        if a.synthetic == "grid3d":
            side = max(2, round(a.synthetic_n ** (1.0 / 3.0)))
            kw = dict(grid_shape=(side, side, side))
        data, gt, _ = generate_world(
            a.synthetic, num_robots=a.num_robots, seed=a.seed, **kw
        )
        return data, gt
    if a.g2o:
        from dpgo_ros_tpu.io.partition import partition_g2o

        return partition_g2o(a.g2o, a.num_robots), None
    if a.dataset:
        from dpgo_ros_tpu.io.datasets import load_g2o_dataset

        return load_g2o_dataset(a.dataset, num_robots=a.num_robots), None
    return None, None


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()


def run(argv=None) -> Tuple[Dict, Dict]:
    """Parse, solve, export. Returns (summary, extras): the JSON summary and
    ``{"timing_sec": {init, solve, rounding, export}, "initial_cost",
    "block_updates"}``. Raises SystemExit(2) on usage errors."""
    parser = build_parser()
    a = parser.parse_args(argv)
    apply_demo(a, parser)
    if a.device == "cuda" and not torch.cuda.is_available():
        parser.exit(2, "error: --device cuda but no CUDA device is available\n")
    data, gt = load_data(a)
    if data is None:
        parser.exit(2, "error: provide --demo, --synthetic, --dataset or --g2o\n")

    from dpgo_ros_tpu.utils import export
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
    st, info = eng.run(st)
    t2 = _clock(device)
    T, st = eng.finalize(st)
    summary = {
        "mode": "engine",
        "device": a.device,
        "iterations": info["iterations"],
        "final_cost": info["final_cost"],
    }
    if gt is not None:
        summary["ate_vs_ground_truth"] = float(rounding.ate_translation(
            torch.as_tensor(T, dtype=torch.float64, device=device),
            torch.as_tensor(gt, dtype=torch.float64, device=device),
        ))
    t3 = _clock(device)
    summary["wall_time_sec"] = round(t3 - t0, 3)
    if a.output:
        export.export_solution(
            a.output, T, data.num_poses, data.measurements,
            np.ones(len(data.measurements)), show_loops=False,
        )
        print(f"wrote {a.output}_global.g2o and per-robot TUM files",
              file=sys.stderr)
    t4 = time.time()
    timing = {"init": t1 - t0, "solve": t2 - t1, "rounding": t3 - t2,
              "export": t4 - t3}
    print("timing_sec " + json.dumps(timing), file=sys.stderr)
    return summary, {
        "timing_sec": timing,
        "initial_cost": initial_cost,
        "block_updates": info["iterations"],
    }


def main(argv=None) -> int:
    summary, _ = run(argv)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
