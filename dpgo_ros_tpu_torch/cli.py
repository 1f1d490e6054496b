"""Command-line entry point of the PyTorch/CUDA port.

Demo presets mirror the reference launch files:

* ``dpgo_demo`` — 5 robots, synchronous RBCD, RoundRobin, chordal init,
  rel-change tol 0.2, RTR 3×50 with gradnorm tol 0.5
  (``launch/dpgo_demo.launch``; sphere2500 unless another source is given);
* ``dpgo_gnc_demo`` — 8 robots, GNC_TLS with barc 3.0, 3 weight rounds × 50
  inner iterations per robot, 3 resets, odometry init, rounds fired on
  inner convergence (``robust_opt_inner_tol`` 0.15, as the JAX CLI does)
  (``launch/dpgo_gnc_demo.launch``; the tunnels dataset unless another
  source is given);
* ``asapp_demo`` — 5 robots, asynchronous ASAPP, RGD stepsize 0.2 with the
  preconditioner, rate 100 (1 step per tick), chordal init, staleness
  K = max(3, ``--max_delayed_iterations``) (``launch/asapp_demo.launch``;
  sphere2500 unless another source is given).

``--update_rule`` is Uniform (JAX's default: each update's robot drawn
from a generator seeded with ``--seed``), RoundRobin or Parallel.
``--mode engine`` runs the host-driven loop, one launch of a CUDA
block-solve kernel per block update: the windowed solve (K4) for Uniform
and RoundRobin, the full-width solve (K1) for Parallel; ``--mode fused``
runs one launch of the multi-step kernel (K2, each step on its robot's or
colour class's window) per stretch between GNC weight rounds (one launch
in all for an L2 run); ``--mode async`` (or ``--asynchronous true``
in engine mode) runs the ASAPP ticks, one launch of the tick kernel (K3)
per tick. On ``--device cpu`` all run the kernels' plain versions.
``--acceleration true`` runs Nesterov-accelerated RBCD: each update one
block-solve launch (K4, or K1 for Parallel) against the extrapolated
state, one more where the step restarts; in ``--mode fused`` too, which
then leaves K2 for a loop of such steps, as the JAX CLI's does.
``--certify`` runs the dual certificate on the final iterate (the
``certificate`` key of the summary). ``--mode fleet`` runs the distributed
protocol simulation (``parallel/controller.py``): one agent per robot
exchanging the reference's messages, each synchronous RTR agent solve one
K4 launch on the agent's local window (the asynchronous agents' RGD steps
plain PyTorch on the card); the agents initialize themselves.
``--frontend HOST:PORT`` pulls the pose graphs from a front-end process
(``parallel/frontend.py``; the fleet's agents each pull their own) and
sends the solved trajectories back to it. ``--mode spmd`` runs the mesh
program (``parallel/spmd.py``) on this process's slots
(``parallel/multihost.py``; one slot unless ``multihost.initialize`` set
more): each active slot's solve one K1 launch on its slot window, or one
K2 launch per ``--spmd_steps_per_launch`` steps. ``--checkpoint_dir`` /
``--checkpoint_every`` / ``--resume`` checkpoint and resume the engine,
fused, async and spmd solves (``utils/checkpoint.py``, the JAX package's
format) and the fleet's warm-start caches.

Examples::

  python -m dpgo_ros_tpu_torch.cli --demo dpgo_demo --synthetic sphere \\
      --synthetic_n 2500 --mode fused --output /tmp/out
  python -m dpgo_ros_tpu_torch.cli --demo dpgo_gnc_demo --synthetic sphere \\
      --synthetic_n 2500 --synthetic_outlier_ratio 0.1
  python -m dpgo_ros_tpu_torch.cli --synthetic grid3d --synthetic_n 64 \\
      --num_robots 2 --device cpu --dtype float64
  python -m dpgo_ros_tpu_torch.cli --demo asapp_demo --synthetic sphere \\
      --synthetic_n 256 --device cpu
  python -m dpgo_ros_tpu_torch.cli --demo dpgo_demo --synthetic sphere \\
      --synthetic_n 500 --acceleration true --certify --device cpu \\
      --dtype float64
  python -m dpgo_ros_tpu_torch.cli --demo dpgo_demo --mode fleet \\
      --synthetic sphere --synthetic_n 500 --device cpu
  python -m dpgo_ros_tpu_torch.cli --demo dpgo_demo --mode spmd \\
      --synthetic sphere --synthetic_n 500 --device cpu

Prints one JSON summary line on stdout (``mode``, ``iterations``,
``final_cost``, ``wall_time_sec``; ``gnc_stats`` for robust costs; for
synthetic worlds ``ate_vs_ground_truth`` and, with planted outliers,
``outlier_ground_truth``) and the time split between init, solve,
rounding and export, with the solve's tCG iterations, on stderr. The async
mode prints the JAX CLI's async keys (``mode``, ``ticks``,
``steps_per_tick``, ``converged``, ``final_cost``, ``wall_time_sec``) and
keeps the ATE for the caller of :func:`run`; so does the fleet mode, whose
summary has the JAX CLI's fleet keys (``mode``, ``ticks``, ``iterations``,
``messages_sent``, ``gnc_stats``, ``wall_time_sec``), and so does the spmd
mode (``mode``, ``iterations``, ``launches``, ``devices``, ``final_cost``,
``gnc_stats``, ``wall_time_sec``). Exits 2 on usage errors, including
``--device cuda`` without a CUDA device and ``--resume latest`` with
nothing to resume.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def _bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dpgo_ros_tpu_torch",
        description="distributed pose-graph optimization (PyTorch/CUDA port)",
    )
    from dpgo_ros_tpu_torch import __version__

    p.add_argument("--version", action="version", version=f"%(prog)s {__version__}")
    p.add_argument("--demo", choices=["dpgo_demo", "asapp_demo", "dpgo_gnc_demo"])
    p.add_argument("--g2o", help="path to a g2o dataset file")
    p.add_argument("--dataset", help="bundled dataset name (e.g. sphere2500)")
    p.add_argument(
        "--synthetic", choices=["sphere", "grid3d"],
        help="generate a synthetic world with exact ground truth instead "
             "of loading a dataset (takes precedence over --dataset)",
    )
    p.add_argument(
        "--frontend", metavar="HOST:PORT",
        help="pull pose graphs from an out-of-process front-end service "
             "(parallel/frontend.py) and push solved trajectories back to it",
    )
    p.add_argument("--csv", nargs="*", help="per-robot measurements.csv paths")
    p.add_argument("--synthetic_n", type=int, default=1000,
                   help="number of poses (sphere) / lattice size n^(1/3) "
                        "rounded (grid3d)")
    p.add_argument("--synthetic_outlier_ratio", type=float, default=0.0,
                   help="share of the synthetic world's loop closures "
                        "replaced by gross outliers (exact labels)")
    p.add_argument("--synthetic_rot_noise", type=float, default=0.01,
                   help="rotation noise (rad) of the synthetic measurements")
    p.add_argument("--synthetic_trans_noise", type=float, default=0.05,
                   help="translation noise of the synthetic measurements")
    p.add_argument("--mode", choices=["engine", "fused", "fleet", "spmd", "async"],
                   default="engine",
                   help="engine: one block-solve launch per update; fused: "
                        "one multi-step launch per GNC stretch; fleet: the "
                        "distributed protocol simulation, one agent per "
                        "robot; spmd: the mesh program, one slot per robot "
                        "block (parallel/spmd.py; slots from "
                        "parallel/multihost.py); async: one ASAPP tick launch "
                        "per tick (also selected by --asynchronous in engine "
                        "mode)")
    p.add_argument("--output", help="output prefix for trajectory export")
    p.add_argument(
        "--checkpoint_dir",
        help="directory for periodic solver-state checkpoints "
        "(capability beyond the reference, which has no persistence)",
    )
    p.add_argument(
        "--checkpoint_every",
        type=int,
        default=50,
        help="checkpoint cadence in block updates (engine mode)",
    )
    p.add_argument(
        "--resume",
        help="checkpoint path to resume from, or 'latest' to pick the "
        "newest step under --checkpoint_dir",
    )
    p.add_argument("--log_directory",
                   help="write the reference's per-robot telemetry CSVs here")
    p.add_argument(
        "--profile_dir",
        help="capture a torch.profiler trace of the build, initialization and "
             "solve (the card's kernels and copies when on CUDA) into this dir "
             "as a Chrome trace (Perfetto, chrome://tracing), with "
             "spans_<pid>.json beside it: per span, calls, total, self and the "
             "card's idle seconds",
    )
    p.add_argument(
        "--viz_interval", type=float, default=0.0,
        help="seconds between mid-run trajectory snapshots (0 = off; the "
             "reference republishes rviz trajectories every 30 s, "
             "PGOAgentROS.cpp:85-86). Engine/spmd/async/fleet modes.",
    )
    p.add_argument(
        "--viz_interval_iters", type=int, default=None,
        help="snapshot every N iterations/ticks instead of (or in "
             "addition to) the wall-clock interval",
    )
    p.add_argument(
        "--viz_dir", default=None,
        help="snapshot directory (default: <output>_snapshots)",
    )
    p.add_argument("--verbose", type=_bool, default=False,
                   help="print the resolved config and, in engine mode, one "
                        "line per block update on stderr")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    p.add_argument("--num_robots", type=int, default=1)
    p.add_argument("--partition_balance", choices=["poses", "work"], default="poses",
                   help="contiguous partition cut rule: 'poses' = the "
                        "reference's equal-pose-count blocks; 'work' = "
                        "balance poses + owned edges")
    p.add_argument("--dimension", type=int, default=3)
    p.add_argument("--relaxation_rank", type=int, default=5)
    p.add_argument("--RTR_iterations", type=int, default=3)
    p.add_argument("--RTR_tCG_iterations", type=int, default=50)
    p.add_argument("--RTR_gradnorm_tol", type=float, default=1e-2)
    p.add_argument("--local_initialization_method",
                   choices=["Odometry", "Chordal", "GNC_TLS"], default="Odometry")
    p.add_argument("--update_rule", choices=["Uniform", "RoundRobin", "Parallel"],
                   default="Uniform")
    p.add_argument("--acceleration", type=_bool, default=False,
                   help="Nesterov-accelerated RBCD: each block solved against "
                        "the extrapolated auxiliary state, with adaptive and "
                        "periodic restarts")
    p.add_argument("--restart_interval", type=int, default=50,
                   help="periodic momentum restart of the accelerated mode, "
                        "in iterations")
    p.add_argument("--multirobot_initialization", type=_bool, default=True,
                   help="align the robots' local trajectories into one frame "
                        "through their shared loop closures")
    p.add_argument("--asynchronous", type=_bool, default=False)
    p.add_argument("--asynchronous_rate", type=float, default=10.0,
                   help="local RGD loop rate in Hz; max(1, round(rate/100)) "
                        "steps per tick")
    p.add_argument("--RGD_stepsize", type=float, default=1e-3)
    p.add_argument("--RGD_use_preconditioner", type=_bool, default=True)
    p.add_argument("--max_delayed_iterations", type=int, default=3,
                   help="staleness bound K of the async ring buffer")
    p.add_argument("--asapp_tolerance", type=float, default=1e-3,
                   help="async stop: every robot's movement per tick below "
                        "this")
    p.add_argument("--asapp_stepsize_decay_ticks", type=int, default=0,
                   help="T0 of the async stepsize decay RGD_stepsize*T0/(T0+t); "
                        "0 keeps it constant")
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
    # the fleet's protocol knobs (reference PGOAgentROS.h:33-119)
    p.add_argument("--publish_iterate", type=_bool, default=False)
    p.add_argument("--complete_reset", type=_bool, default=False)
    p.add_argument("--enable_recovery", type=_bool, default=False)
    p.add_argument("--synchronize_measurements", type=_bool, default=True)
    p.add_argument("--max_distributed_init_steps", type=int, default=30)
    p.add_argument("--inter_update_sleep_time", type=float, default=0.0)
    p.add_argument("--weight_convergence_threshold", type=float, default=-1.0)
    p.add_argument("--timeout_threshold", type=float, default=15.0,
                   help="fleet: ticks without a status from the scheduled "
                        "robot before the leader times it out")
    p.add_argument("--visualize_loop_closures", type=_bool, default=False,
                   help="draw the loop closures, coloured by final weight, in "
                        "the --output HTML view")
    p.add_argument(
        "--use_fused_kernel", type=_bool, default=None,
        help="spmd mode: the CUDA block-solve kernels (K1, K2 for stretches) "
             "for each slot's solve (default: auto, on for fp32 on the card; "
             "false runs the plain solve)",
    )
    p.add_argument(
        "--spmd_steps_per_launch", type=int, default=1,
        help="spmd mode: solver steps executed INSIDE one kernel launch "
        "per mesh slot between separator all_gathers (round 5; >1 "
        "requires the fused kernel; exact on a 1-slot mesh). On "
        "multi-slot meshes the stretch steps default to ASAPP RGD "
        "ticks (cheap units — raise --max_iteration_number "
        "accordingly)",
    )
    p.add_argument(
        "--spmd_stretch_rgd_stepsize", type=float, default=None,
        help="spmd stretch step rule: preconditioned RGD ticks of this "
        "stepsize (the ASAPP rule — the staleness-robust multi-slot "
        "choice); default None = trust-region block solves",
    )
    p.add_argument(
        "--spmd_separator_only", type=_bool, default=None,
        help="spmd mode: exchange only separator poses between mesh "
        "slots (the PublicPoses payload; ~12x less exchange volume). "
        "Default: auto — on for non-robust runs",
    )
    p.add_argument(
        "--spmd_repartition", type=_bool, default=False,
        help="spmd mode: re-cut the global pose sequence into "
        "work-balanced contiguous slot blocks (splits hot robots — "
        "fixes dataset-pinned load skew, SCALING_r05.json)",
    )
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--certify", action="store_true",
                   help="after the solve, run the dual certificate on the final "
                        "iterate: reports whether it is the certified global "
                        "optimum of the final-weights problem, min eig(S) and "
                        "the criticality residual (fp64 runs certify sharply, "
                        "fp32 within looser tolerances)")
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
    elif a.demo == "asapp_demo":
        preset = dict(
            dataset=a.dataset or "sphere2500",
            num_robots=5,
            asynchronous=True,
            asynchronous_rate=100.0,
            RGD_stepsize=0.2,
            local_initialization_method="Chordal",
            max_delayed_iterations=max(a.max_delayed_iterations, 3),
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
            synchronize_measurements=False,
            # reference dpgo_gnc_demo.launch:44 draws GNC-coloured loop markers
            visualize_loop_closures=True,
        )
    else:
        return
    for k, v in preset.items():
        if getattr(a, k) == parser.get_default(k):
            setattr(a, k, v)


def args_to_config(a):
    from dpgo_ros_tpu_torch.utils.config import (
        AgentConfig,
        InitMethod,
        RobustCostType,
        UpdateRule,
    )

    return AgentConfig(
        num_robots=a.num_robots,
        dimension=a.dimension,
        relaxation_rank=a.relaxation_rank,
        multirobot_initialization=a.multirobot_initialization,
        visualize_loop_closures=a.visualize_loop_closures,
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
        acceleration=a.acceleration,
        restart_interval=a.restart_interval,
        max_iteration_number=a.max_iteration_number,
        relative_change_tolerance=a.relative_change_tolerance,
        asynchronous=a.asynchronous,
        asynchronous_rate=a.asynchronous_rate,
        RGD_stepsize=a.RGD_stepsize,
        RGD_use_preconditioner=a.RGD_use_preconditioner,
        max_delayed_iterations=a.max_delayed_iterations,
        asapp_tolerance=a.asapp_tolerance,
        asapp_stepsize_decay_ticks=a.asapp_stepsize_decay_ticks,
        publish_iterate=a.publish_iterate,
        complete_reset=a.complete_reset,
        enable_recovery=a.enable_recovery,
        synchronize_measurements=a.synchronize_measurements,
        max_distributed_init_steps=a.max_distributed_init_steps,
        inter_update_sleep_time=a.inter_update_sleep_time,
        weight_convergence_threshold=a.weight_convergence_threshold,
        timeout_threshold=a.timeout_threshold,
        log_directory=a.log_directory,
        dtype=a.dtype,
        use_fused_kernel=a.use_fused_kernel,
        spmd_steps_per_launch=a.spmd_steps_per_launch,
        spmd_stretch_rgd_stepsize=a.spmd_stretch_rgd_stepsize,
        spmd_separator_only=a.spmd_separator_only,
        verbose=a.verbose,
        seed=a.seed,
    )


def load_data(a):
    """(data, ground truth or None, planted-outlier mask or None) for the
    selected source."""
    if a.synthetic:
        from dpgo_ros_tpu_torch.io.synthetic import generate_world

        kw = dict(n=a.synthetic_n)
        if a.synthetic == "grid3d":
            side = max(2, round(a.synthetic_n ** (1.0 / 3.0)))
            kw = dict(grid_shape=(side, side, side))
        return generate_world(
            a.synthetic, num_robots=a.num_robots, seed=a.seed,
            rot_noise=a.synthetic_rot_noise, trans_noise=a.synthetic_trans_noise,
            outlier_ratio=a.synthetic_outlier_ratio, balance=a.partition_balance,
            **kw
        )
    if a.csv:
        from dpgo_ros_tpu_torch.io.csv_loader import load_multi_robot_csv

        return load_multi_robot_csv(a.csv), None, None
    if a.g2o:
        from dpgo_ros_tpu_torch.io.partition import partition_g2o

        return partition_g2o(a.g2o, a.num_robots, balance=a.partition_balance), None, None
    if a.dataset:
        from dpgo_ros_tpu_torch.io.datasets import load_g2o_dataset

        return load_g2o_dataset(a.dataset, num_robots=a.num_robots,
                                balance=a.partition_balance), None, None
    if a.demo == "dpgo_gnc_demo":
        from dpgo_ros_tpu_torch.io.datasets import load_tunnels

        return load_tunnels(num_robots=a.num_robots), None, None
    return None, None, None


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()


@dataclasses.dataclass
class _Solved:
    """What a mode's solve hands to the shared tail of :func:`run`."""

    summary: Dict  # the mode's summary keys; the tail adds the wall time
    extras: Dict
    T: Optional[np.ndarray]  # (n, d, d+1) rounded poses (fleet: None if
    # no agent finished)
    weights: np.ndarray  # (E,) final edge weights, for the export
    work: Tuple[str, int]  # the solve's work unit for the timing line
    rows: Optional[np.ndarray] = None  # per-iteration rel changes (telemetry)
    iter_times: Optional[np.ndarray] = None  # None: the solve's mean
    events: List = dataclasses.field(default_factory=list)


def run(argv=None) -> Tuple[Dict, Dict]:
    """Parse, solve, export. Returns (summary, extras): the JSON summary and
    ``{"timing_sec": {init, solve, rounding, export, tcg_iterations or
    ticks, counters}, "initial_cost", ...}`` (``counters``: each counter
    of ``utils/profiling`` that moved during the solve, by how much: kernel
    launches, chordal CG steps and host syncs) with, for the RBCD modes,
    ``"block_updates", "restarts"`` (accelerated steps that restarted),
    ``"weight_rounds", "weights"`` (the final weights as numpy), for
    the async mode ``"ticks", "costs"`` and ``"ate_vs_ground_truth"``, and
    for the fleet ``"ticks", "terminated", "active_robots",
    "bytes_received", "weights"`` (the fleet's global weights) and the
    ATE and outlier counts (``initial_cost`` None: the agents initialize
    themselves). Raises SystemExit(2) on usage errors."""
    parser = build_parser()
    a = parser.parse_args(argv)
    apply_demo(a, parser)
    if a.device == "cuda" and not torch.cuda.is_available():
        parser.exit(2, "error: --device cuda but no CUDA device is available\n")
    frontend = None
    if a.frontend:
        # out-of-process SLAM front-end (reference request_pose_graph
        # service, ``src/PGODatasetPublisherNode.cpp:46-51``)
        from dpgo_ros_tpu_torch.parallel.frontend import RemoteDatasetServer

        host, _, port = a.frontend.rpartition(":")
        frontend = RemoteDatasetServer(host or "127.0.0.1", int(port))
        data, gt, planted = frontend.fetch_data(), None, None
    else:
        data, gt, planted = load_data(a)
    if data is None:
        parser.exit(2, "error: provide --demo, --synthetic, --dataset, --g2o "
                       "or --csv\n")

    from dpgo_ros_tpu_torch.models.problem import LiftedProblem
    from dpgo_ros_tpu_torch.ops import rounding
    from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
    from dpgo_ros_tpu_torch.utils import export, profiling

    cfg = dataclasses.replace(args_to_config(a), num_robots=data.num_robots)
    snap = _snapshot_writer(a, data)
    if cfg.verbose:
        print("resolved config: "
              + json.dumps(dataclasses.asdict(cfg), default=str), file=sys.stderr)
    device = torch.device(a.device)
    dtype = torch.float64 if a.dtype == "float64" else torch.float32
    is_async = a.mode == "async" or (a.asynchronous and a.mode == "engine")
    mgr, resume = _checkpoints(a, parser)
    mesh = None
    if a.mode == "spmd":
        from dpgo_ros_tpu_torch.parallel import multihost, spmd

        mesh = multihost.global_mesh(device)
        if mesh.device.type != device.type:
            parser.exit(2, f"error: --device {a.device} but the mesh runs on "
                           f"{mesh.device}\n")
        # fleets larger than the mesh: robots grouped into super-blocks, or
        # the pose sequence re-cut into work-balanced slot blocks
        M = min(mesh.global_slots, max(data.num_robots, 1))
        if a.spmd_repartition:
            data = spmd.repartition_slots(data, M)
        elif data.num_robots > M:
            data = spmd.group_robots(data, M)
        # the mesh program runs fp32, as the JAX CLI's; the engine serves
        # its initialization and finalize only
        dtype = torch.float32
        cfg = dataclasses.replace(cfg, num_robots=data.num_robots, dtype="float32")

    def init_and_solve():
        t0 = _clock(device)
        if a.mode == "fleet":  # the agents initialize themselves
            prob, st, initial_cost = None, None, None
            solve = _solve_fleet(data, cfg, device, frontend, a.checkpoint_dir, resume,
                                 snap)
        else:
            prob = LiftedProblem.from_data(
                data, r=cfg.relaxation_rank, dtype=dtype, device=device
            )
            # the init pipeline of the other modes
            eng = RBCDEngine(prob, dataclasses.replace(cfg, use_fused_kernel=None)
                             if a.mode == "spmd" else cfg)
            st = eng.initialize()
            initial_cost = float(st.cost)
            if is_async:
                solve = _solve_async(a, eng, mgr, resume, snap)
            elif a.mode == "spmd":
                solve = _solve_spmd(a, cfg, eng, st, mesh, mgr, resume, snap)
            else:
                if resume is not None:
                    st = _resume_rbcd(eng, resume)
                solve = _solve_rbcd(a, eng, mgr, snap)
        t1 = _clock(device)
        before = profiling.counters()
        out = solve(st)
        t2 = _clock(device)
        counted = {k: v - before.get(k, 0) for k, v in profiling.counters().items()
                   if v != before.get(k, 0)}
        return prob, initial_cost, out, (t0, t1, t2), counted

    with profiling.device_trace(a.profile_dir, device, spans=True):
        prob, initial_cost, out, (t0, t1, t2), counted = init_and_solve()
    t_traced = time.time()  # the trace's export is in no phase
    # the async, fleet and spmd summaries have JAX's keys only: their ATE
    # goes to the extras
    scored = out.extras if is_async or a.mode in ("fleet", "spmd") else out.summary
    if gt is not None and out.T is not None and len(out.T) == len(gt):
        scored["ate_vs_ground_truth"] = float(rounding.ate_translation(
            torch.as_tensor(out.T, dtype=torch.float64, device=device),
            torch.as_tensor(gt, dtype=torch.float64, device=device),
        ))
    if planted is not None and planted.any():
        rej = out.weights[: len(planted)] < 0.5
        loops = np.asarray(data.measurements.edge_type) != 0
        scored["outlier_ground_truth"] = {
            "planted": int(planted.sum()),
            "rejected_true": int((rej & planted).sum()),
            "rejected_false": int((rej & loops & ~planted).sum()),
            "missed": int((~rej & planted).sum()),
        }
    t3 = _clock(device)
    out.summary["wall_time_sec"] = round(t3 - t0, 3)
    if a.output and out.T is not None:
        export.export_solution(
            a.output, out.T, data.num_poses, data.measurements,
            out.weights[: len(data.measurements)],
            show_loops=a.visualize_loop_closures,
        )
        print(f"wrote {a.output}_global.g2o and per-robot TUM files",
              file=sys.stderr)
    rows = out.rows
    if a.log_directory and rows is not None and len(rows):
        from dpgo_ros_tpu_torch.utils import telemetry

        iter_times = out.iter_times
        if iter_times is None:  # no per-iteration host clock: the mean
            iter_times = np.full(len(rows), (t2 - t1) / len(rows))
        telemetry.write_run_logs(
            a.log_directory, problem=prob, rel_change_rows=rows,
            iter_times=iter_times, events=out.events,
        )
        print(f"per-agent telemetry CSVs in {a.log_directory}", file=sys.stderr)
    if frontend is not None:
        _publish_to_frontend(frontend, out.T, data.num_poses)
    t4 = time.time()
    timing = {"init": t1 - t0, "solve": t2 - t1, "rounding": t3 - t_traced,
              "export": t4 - t3, out.work[0]: out.work[1], "counters": counted}
    print("timing_sec " + json.dumps(timing), file=sys.stderr)
    return out.summary, dict(out.extras, timing_sec=timing,
                             initial_cost=initial_cost)


def _snapshot_writer(a, data):
    """The mid-run snapshot writer of ``--viz_interval`` /
    ``--viz_interval_iters`` (into ``--viz_dir``, default
    ``<output>_snapshots``, else ``dpgo_snapshots``), or None when both are
    off. The engine, spmd, async and fleet modes write snapshots; the fused
    runner has no step between its launches to write them at."""
    if not (a.viz_interval > 0 or a.viz_interval_iters is not None):
        return None
    from dpgo_ros_tpu_torch.utils.snapshots import SnapshotWriter

    snap_dir = a.viz_dir or ((a.output + "_snapshots") if a.output else "dpgo_snapshots")
    print(f"mid-run snapshots -> {snap_dir}", file=sys.stderr)
    return SnapshotWriter(snap_dir, data, interval_sec=a.viz_interval,
                          interval_iters=a.viz_interval_iters)


def _checkpoints(a, parser):
    """(CheckpointManager or None, the checkpoint path to resume from or
    None) of ``--checkpoint_dir`` / ``--checkpoint_every`` / ``--resume``
    ("latest": the newest step under the directory; the fleet resumes from
    the directory itself, as the JAX CLI's). Exits 2 on a "latest" with
    nothing to resume."""
    from dpgo_ros_tpu_torch.utils import checkpoint as ckpt

    mgr = (ckpt.CheckpointManager(a.checkpoint_dir, every=a.checkpoint_every)
           if a.checkpoint_dir and a.mode != "fleet" else None)
    rp = a.resume
    if rp == "latest" and a.mode == "fleet":
        rp = a.checkpoint_dir or rp
    elif rp == "latest":
        if mgr is None or mgr.latest() is None:
            parser.exit(2, "error: --resume latest needs a --checkpoint_dir "
                           "with checkpoints\n")
        rp = mgr.latest()[1]
    if rp is not None and not os.path.isdir(rp):
        parser.exit(2, f"error: no checkpoint at {rp}\n")
    return mgr, rp


def _resume_rbcd(eng, path):
    """The engine's state (and YLift) from the checkpoint at ``path``, on
    the engine's device in its dtype."""
    from dpgo_ros_tpu_torch.utils import checkpoint as ckpt

    st, ylift, _ = ckpt.load_state(path, device=eng.device, dtype=eng.dtype)
    if ylift is not None:
        eng.Ylift = torch.as_tensor(ylift, dtype=eng.dtype, device=eng.device)
    print(f"resumed from {path} (iteration {st.iteration})", file=sys.stderr)
    return st


def _solve_rbcd(a, eng, mgr=None, snap=None):
    """The synchronous modes' solve from the initial (or resumed) state:
    ``--mode fused`` (one K2 launch per GNC stretch) or the engine loop
    (checkpointed every ``--checkpoint_every`` global iterations, a
    snapshot where ``snap`` has one due: the state is read back only
    then; with ``--verbose`` one line per update), then the final
    checkpoint, the TERMINATE finalize and rounding."""
    from dpgo_ros_tpu_torch.utils import profiling
    from dpgo_ros_tpu_torch.utils.config import RobustCostType

    def cb(_, s):
        # the cadences follow the global iteration, so a resumed run
        # continues the same checkpoint grid
        if mgr is not None:
            mgr.maybe_save(s.iteration, s, eng.Ylift)
        if snap is not None and snap._due(s.iteration):
            with profiling.span("snapshot"):
                snap.snapshot(s.iteration, s.X, weights=s.weights, cost=float(s.cost))

    def solve(st) -> _Solved:
        rows, iter_times, events = None, None, []
        if a.mode == "fused":
            # the engine's resolved config carries the GNC iteration budget
            record = bool(a.log_directory)
            cap = eng.config.max_iteration_number
            if eng.config.acceleration:  # a loop of per-step solves, no K2
                runner = eng.make_fused_run(cap, record=record)
                out = runner(st)
                out = (out,) if not record else out
                stats = runner.last_stats
            else:
                runner = eng.make_fused_run(cap, record=record, return_stats=True)
                out = runner(st)
                stats = {"tcg_iterations": out[-1], "restarts": 0}
            st = out[0]
            info = {"iterations": st.iteration, "final_cost": float(st.cost), **stats}
            if eng.config.robust_cost_type != RobustCostType.L2:
                info.update(eng.gnc_info(st.weights))
            if record:
                rows = out[1][:st.iteration].cpu().numpy()
                events = [(int(i), "UPDATE_WEIGHT")
                          for i in np.flatnonzero(out[2].numpy())]
        else:
            st, info = eng.run(st, callback=cb if mgr is not None or snap is not None
                               else None)
            h = info["history"]
            if h["rel_change_robots"]:
                rows = np.stack(h["rel_change_robots"])
                if eng.config.verbose:
                    _print_updates(h)
            iter_times, events = h["iter_time_sec"], h["event"]
        if mgr is not None:
            mgr.save(st.iteration, st, eng.Ylift,
                     meta={"final": True, "cost": float(st.cost)})
        T, st = eng.finalize(st)
        summary = {"mode": a.mode, "device": a.device,
                   "iterations": info["iterations"],
                   "final_cost": info["final_cost"]}
        if "gnc_stats" in info:
            summary["gnc_stats"] = info["gnc_stats"]
        weights = st.weights.cpu().numpy()
        _maybe_certify(summary, a, st.X, eng._edges(st.weights))
        extras = {"block_updates": info["iterations"], "restarts": info["restarts"],
                  "weight_rounds": st.weight_update_count, "weights": weights}
        return _Solved(summary, extras, T, weights,
                       ("tcg_iterations", info["tcg_iterations"]),
                       rows, iter_times, events)

    return solve


def _print_updates(h) -> None:
    """``--verbose`` in engine mode: one line per block update on stderr,
    the JAX CLI's text (reference verbose telemetry,
    ``PGOAgentROS.cpp:166-172``), tagged ``[UPDATE_WEIGHT]`` where a weight
    round fired before the update."""
    rounds = {i for i, ev in h["event"] if ev == "UPDATE_WEIGHT"}
    for i, rr in enumerate(h["rel_change_robots"]):
        print(f"iter {i}: max_rel_change {float(np.max(rr)):.6g} "
              f"iter_time {h['iter_time_sec'][i]:.4f}s"
              + (" [UPDATE_WEIGHT]" if i in rounds else ""), file=sys.stderr)


def _solve_fleet(data, cfg, device, dataset, checkpoint_dir=None, resume=None,
                 snap=None):
    """The fleet: one agent per robot on ``device`` (the protocol on the
    host, every synchronous RTR solve one K4 launch on the card), ticked to
    termination; the global trajectory of the agents' final ones and the
    fleet's GNC weights on the global measurements (the loop overlay's).
    On the card K4 is built here, in the init phase, so that no agent's
    first solve holds a compile. ``dataset`` is a front-end client or
    None. ``resume`` restores the agents' warm-start caches first;
    ``checkpoint_dir`` saves them after the run (the controller's
    ``restore_checkpoint`` / ``save_checkpoint``); ``snap`` writes the live
    global trajectory on its cadence in ticks."""
    from dpgo_ros_tpu_torch.parallel.controller import DistributedController
    from dpgo_ros_tpu_torch.utils.config import SolverMethod

    ctl = DistributedController(data, cfg, dataset=dataset, device=device)
    if device.type == "cuda" and ctl.config.solver == SolverMethod.RTR:
        from dpgo_ros_tpu_torch.ops import hbm_rtr, kernels

        kernels.load(kernels.WINDOW_SOURCE, hbm_rtr.ENTRIES)
    if resume is not None:
        ctl.restore_checkpoint(resume)
        print(f"fleet resumed warm-start caches from {resume}", file=sys.stderr)

    def solve(_) -> _Solved:
        res = ctl.run(snapshot=snap)
        if checkpoint_dir:
            ctl.save_checkpoint(checkpoint_dir, meta={"ticks": res["ticks"]})
            print(f"fleet checkpoint written to {checkpoint_dir}", file=sys.stderr)
        m = data.measurements
        gw = ctl.global_weights(res, m)
        weights = gw if gw is not None else np.ones(len(m))
        summary = {"mode": "fleet", "ticks": res["ticks"],
                   "iterations": res["iterations"],
                   "messages_sent": res["messages_sent"]}
        gs = ctl.gnc_statistics(res)
        if gs is not None:
            summary["gnc_stats"] = gs
        extras = {"ticks": res["ticks"], "terminated": res["terminated"],
                  "active_robots": res["active_robots"],
                  "bytes_received": res["bytes_received"], "weights": weights}
        return _Solved(summary, extras, ctl.global_trajectory(res), weights,
                       ("ticks", res["ticks"]))

    return solve


def _publish_to_frontend(frontend, T, num_poses) -> None:
    """The return path: each robot's solved trajectory back to the
    front-end (reference publishOptimizedTrajectory,
    ``src/PGOAgentROS.cpp:622-660``)."""
    if T is not None:
        off = 0
        for k, nk in enumerate(np.asarray(num_poses)):
            frontend.publish_trajectory(k, T[off:off + int(nk)])
            off += int(nk)
        print(f"published {len(num_poses)} trajectories to --frontend",
              file=sys.stderr)
    frontend.close()


def _maybe_certify(summary, a, X, edges) -> None:
    """``--certify``: the dual certificate of the final iterate under the
    final weights (under GNC, the accepted edges' L2 problem), with the JAX
    CLI's tolerances (looser in fp32), into ``summary["certificate"]``. Its
    time counts in the timing line's solve phase."""
    if not a.certify:
        return
    from dpgo_ros_tpu_torch.ops import certificate

    fp64 = X.dtype == torch.float64
    cert = certificate.certify(
        X, edges,
        eig_tol=1e-5 if fp64 else 1e-3,
        crit_tol=1e-4 if fp64 else 3e-2,
        lanczos_tol=1e-6 if fp64 else 1e-4,
    )
    summary["certificate"] = {
        "certified_global": bool(cert.is_global),
        "min_eig": cert.min_eig,
        "crit_residual": cert.crit_residual,
        "scale": cert.scale,
    }


def _solve_spmd(a, cfg, eng, st_init, mesh, mgr=None, resume=None, snap=None):
    """The spmd mode (the JAX CLI's loop): the mesh program of
    ``parallel/spmd.py`` on this process's slots of ``mesh`` (M = the
    problem's robots, grouped or repartitioned to fit the mesh), one step
    per launch — each active slot's solve one K1 launch on the card, or one
    K2 launch of ``--spmd_steps_per_launch`` steps (GNC runs keep 1: its
    weight rounds are per-iteration host events) — weight rounds on the
    reference cadence, the rel-change check every 20 launches, checkpoints
    of the gathered state (process 0 writes), then the engine's finalize.
    ``cfg`` is the unresolved config (the loop's iteration budget is
    ``max_iteration_number`` as given, as in the JAX CLI). The slots'
    tables and, on the card, the kernels are built here, in the init
    phase, from the initial state ``st_init``. ``snap`` writes the gathered
    trajectory and weights after each launch it has one due at."""
    from dpgo_ros_tpu_torch.ops import fused_rtr, kernels, quadratic
    from dpgo_ros_tpu_torch.parallel import spmd
    from dpgo_ros_tpu_torch.utils import checkpoint as ckpt
    from dpgo_ros_tpu_torch.utils.config import RobustCostType

    prob = eng.problem
    gnc = cfg.robust_cost_type == RobustCostType.GNC_TLS
    if gnc and cfg.spmd_steps_per_launch > 1:
        print("spmd: GNC runs use spmd_steps_per_launch=1 (weight rounds are "
              "per-iteration host events)", file=sys.stderr)
        cfg = dataclasses.replace(cfg, spmd_steps_per_launch=1)

    sp = spmd.ShardedProblem.build(
        prob, st_init.X.cpu().numpy().astype(np.float32), eng.robot_colors,
        num_devices=prob.num_robots)
    M = sp.M
    st_first, step = spmd.build_spmd_step(sp, cfg, mesh)
    if mesh.device.type == "cuda" and step.use_kernel:
        if step.S > 1:
            kernels.load(kernels.RUN_SOURCE, fused_rtr.RUN_ENTRIES)
        else:
            kernels.load(kernels.BLOCK_SOURCE, fused_rtr.BLOCK_ENTRIES)

    def solve(st0) -> _Solved:
        st = st_first
        rank0 = mesh.process_id == 0
        it0 = 0
        if resume is not None:
            host, _, meta = ckpt.load_state(resume, spmd.SpmdState)
            st = spmd.place_state(host, st, mesh)
            it0 = int(meta.get("it", 0))
            print(f"spmd resumed from {resume} (iteration {it0})", file=sys.stderr)
        inner = cfg.robust_opt_inner_iters_per_robot * cfg.num_robots
        n_launches = -(-cfg.max_iteration_number // step.S)
        rows, iter_times, events = [], [], []
        gather_rel = lambda s: spmd._gather_slots(mesh, s.rel_change, M)[:, 0]
        it = it0 - 1
        for it in range(it0, n_launches):
            wu = int(gnc and it > 0 and it % inner == 0
                     and st.wuc < cfg.robust_opt_num_weight_updates)
            t_it = time.time()
            st = step(it, wu, st)
            if a.log_directory:
                # one read per step, as the reference pays to write its rows
                rows.append(gather_rel(st).cpu().numpy().astype(np.float64))
                iter_times.append(time.time() - t_it)
                if wu:
                    events.append((it - it0, "UPDATE_WEIGHT"))
            if snap is not None and snap._due(it + 1):
                snap.snapshot(
                    it + 1, spmd.gather_trajectory(sp, st, prob.num_poses, mesh),
                    weights=spmd.gather_weights(sp, st, prob.edges.num_edges, mesh))
            if mgr is not None and mgr.every > 0 and (it + 1) % mgr.every == 0:
                host = spmd.gather_state(st, M, mesh)
                if rank0:
                    mgr.save(it + 1, host, None, meta={"it": it + 1})
            if it % 20 == 19:
                rc = float(torch.max(gather_rel(st)))
                if rc < cfg.relative_change_tolerance and (
                        not gnc or st.wuc >= cfg.robust_opt_num_weight_updates):
                    break
        if mgr is not None:
            host = spmd.gather_state(st, M, mesh)
            if rank0:
                mgr.save(it + 1, host, None, meta={"it": it + 1, "final": True})
        Xg = spmd.gather_trajectory(sp, st, prob.num_poses, mesh)
        w = spmd.gather_weights(sp, st, prob.edges.num_edges, mesh)
        # TERMINATE through the engine's finalize: undecided GNC weights
        # settled by final residual, rounding, anchoring
        t = lambda x: torch.as_tensor(x, dtype=eng.dtype, device=eng.device)
        T, st_fin = eng.finalize(st0._replace(X=t(Xg), weights=t(w)))
        summary = {
            "mode": "spmd", "iterations": st.iteration, "launches": it + 1,
            "devices": M,
            "final_cost": float(quadratic.cost(t(Xg), eng._edges(st_fin.weights))),
        }
        if gnc:
            summary["gnc_stats"] = eng.gnc_info(st_fin.weights)["gnc_stats"]
        weights = st_fin.weights.cpu().numpy()
        extras = {"launches": it + 1, "block_updates": step.solves,
                  "restarts": step.restarts, "exchange_bytes": step.exchange_bytes,
                  "weight_rounds": st.wuc, "weights": weights}
        return _Solved(summary, extras, T, weights, ("launches", it + 1),
                       np.stack(rows) if rows else None,
                       np.asarray(iter_times) if rows else None, events)

    return solve


def _solve_async(a, eng, mgr=None, resume=None, snap=None):
    """The asynchronous (ASAPP) mode's solve from the initial state, or
    from the ASAPP state at ``resume`` (tick counter, ring buffer and delay
    generator included): ASAPP ticks up to ``max_iteration_number`` with
    the per-tick stop at ``asapp_tolerance`` (reference
    ``runOnceAsynchronous``, ``src/PGOAgentROS.cpp:119-127``;
    ``launch/asapp_demo.launch``), a snapshot after each chunk where
    ``snap`` has one due, a final checkpoint, then rounding. P⁻¹ is built
    here, in the init phase."""
    from dpgo_ros_tpu_torch.ops import quadratic, rounding
    from dpgo_ros_tpu_torch.parallel.asapp import ASAPPEngine, ASAPPState
    from dpgo_ros_tpu_torch.utils import checkpoint as ckpt

    prob = eng.problem
    aeng = ASAPPEngine(prob, eng.config)
    resumed = None
    if resume is not None:
        resumed, _, _ = ckpt.load_state(resume, ASAPPState, device=eng.device,
                                        dtype=eng.dtype)
        print(f"async resumed from {resume} (tick {resumed.tick})", file=sys.stderr)

    def solve(st) -> _Solved:
        on_chunk = (lambda t, s: snap.maybe_snapshot(t, s.X)) if snap is not None else None
        ast, info = aeng.run(
            st.X if resumed is None else None, state=resumed,
            num_ticks=aeng.config.max_iteration_number,
            tol=aeng.config.asapp_tolerance, record=bool(a.log_directory),
            on_chunk=on_chunk,
        )
        if mgr is not None:
            mgr.save(ast.tick, ast, None, meta={"tick": ast.tick, "final": True})
            print(f"async checkpoint written to {mgr.step_path(ast.tick)}",
                  file=sys.stderr)
        T = rounding.anchor_to_first_pose(rounding.round_solution(ast.X))
        summary = {
            "mode": "async",
            "ticks": info["ticks"],
            "steps_per_tick": aeng.steps_per_tick,
            "converged": info["converged"],
            "final_cost": float(quadratic.cost(ast.X, prob.edges)),
        }
        extras = {"ticks": info["ticks"], "costs": info["costs"]}
        return _Solved(summary, extras, T.cpu().numpy(),
                       prob.host_edges.weight, ("ticks", info["ticks"]),
                       info.get("rel_hist"))

    return solve


def main(argv=None) -> int:
    summary, _ = run(argv)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
