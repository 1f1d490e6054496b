#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (dpgo_ros_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the six kernel libraries, K1 (csrc/rtr_block.cu), K2
     (csrc/rtr_run.cu), K3 (csrc/asapp_tick.cu), K4 (csrc/rtr_window.cu),
     K5 + K6 (csrc/peak_chains.cu) and K7 (csrc/nesterov_extrapolate.cu),
     one nvcc per source started
     together; print ptxas's report, and the registers and stack of each
     (d, r) instance of the cluster kernels K1–K4 (K3's also per
     preconditioner flag);
  3. hold K1, the cluster kernel that solves its mask's window, against
     its plain PyTorch version (full-width under the mask) on the card, on
     the 2,500-pose 5-robot synthetic sphere (every robot mask, every
     Parallel colour union on the colour windows, the all-ones mask on the
     all-robots window), on a 1,000-pose grid3d world (irregular loop
     closures), on an SE(2) ring and on two robots of the 50,000-pose
     world, from noisy states: the same TR count, f0, f and X within
     tolerance, the same updated flags, moved within rtol 1e-3, a second
     launch bit-identical; the wrapper raises on the card without windows
     and on a mask that is not its row's block;
  4. hold K2, the cluster kernel that solves each step on its bank row's
     window, against its plain version (full-width, the same function) on
     the sphere (10 RoundRobin steps, 10 Uniform steps on a schedule passed
     in and 10 on the rule's own draw, 6 Parallel steps on the colour
     classes' windows, a GNC exit on the cadence, 10 RGD steps; r = 8
     too) and on the SE(2) ring (r = 2 and 5, d = 2): the same exit, steps
     and tCG iterations, and a second launch bit-identical; where the
     schedule solves a robot twice in a row or the tCG totals differ, each
     step also once through both from the kernel's own state, the tCG
     count equal on every step but those that revisit a robot; print each
     case's cluster and shared memory;
  5. hold K3, one cluster per robot on the robot's window, against its
     plain version on the sphere from a noisy state: K = 3, 20 chained
     ticks with one fixed delay table, 1 or 2 steps per tick, with and
     without the preconditioner, and on the SE(2) ring (d = 2) (X,
     movement, ring buffer), a repeated chain bit-identical; the wrapper
     raises on the card without windows;
  6. drive the CLI main path (``--demo dpgo_demo --synthetic sphere
     --synthetic_n 2500 --device cuda``) in engine mode to its rel-change
     tolerance with the launch counters zeroed just before, and check cost
     decrease, K4 launches == block updates (RoundRobin), export files and
     a finite ATE; the same with ``--update_rule Parallel``, K1 launches ==
     block updates; then run 20 fixed RoundRobin iterations on the card
     (K4, fp32) and on the CPU (plain path, fp64) from one initial state and
     compare the histories;
  7. drive the same main path with ``--mode fused``: one K2 launch, no K1
     launch, the engine run's iterations and cost;
  8. drive the async main path (``--demo asapp_demo --synthetic sphere
     --synthetic_n 2500 --device cuda``) with the counters zeroed just
     before: one K3 launch per tick, cost decrease, final cost within 1 %
     of the JAX CLI's, finite ATE; then 50 ticks on the card (K3, fp32)
     and on the CPU (plain, fp64) from one state and one delay table; then
     a run whose device-side stop falls mid-chunk: it stops at the first
     tick after which every robot's recorded movement is below the
     tolerance, with X, the ring buffer and the generator of a run of
     exactly that many ticks;
  9. drive the GNC demo at full width (``--demo dpgo_gnc_demo --synthetic
     sphere --synthetic_n 2500 --synthetic_outlier_ratio 0.1``: 8 robots,
     245 planted outliers) in both modes: 3 weight rounds, K2 launches ==
     rounds + 1 (fused), K4 launches == block updates (engine), the modes'
     accept/reject sets agree, outlier recall no worse than the JAX CLI's;
 10. hold K4, the windowed block solve on a thread-block cluster, against
     its plain version and against K1 (which solves the same window) on
     the 50,000-pose 16-robot sphere from a noisy state, robots 0, 5, 10
     and 15, banded and with 1,000 extra loop closures between random pose
     pairs, and at r = 8 (whose slices do not fit in shared memory): the
     same TR and tCG counts, X, f − f0 and gn within tolerance, every pose
     outside the block bit-identical to the input, a second launch
     bit-identical; the same against the plain version on the sphere (r =
     5, 8) and the SE(2) ring (r = 2, 5; d = 2); the first robot of each
     case solved again at once from K4's result, through both (the same
     TR count, X and f within the K2 run tolerances);
 11. drive the large-world main path (``--synthetic sphere --synthetic_n
     50000 --num_robots 16``, Odometry init, RoundRobin, at most 10
     sweeps) in engine mode with the counters zeroed just before: K4
     launches == block updates, no K1 launch, cost decrease, export files
     and a finite ATE; then one sweep of 16 updates from one state through
     K4 and through K1 full-width (``rbcd.SEQUENTIAL_ON_WINDOWS`` off),
     cost and rel-change histories compared;
 12. time K1 per solve (on the device from a profiler trace and per
     wrapper call; on the sphere's colour masks, the Parallel path's
     work, and on its robot masks), K2 per step and K3 per launch against
     their plain versions at these shapes (K3 also per whole tick, the ring
     write included), the dpgo_demo solve phase of both modes and of the
     Parallel rule, and the asapp_demo solve phase; K4 per solve over the
     16 blocks of the 50,000-pose world, K1 on 4 of them and the plain
     version, and the large-world solve phase;
 13. time K4 against K1 per block solve below the large world:
     the dpgo_demo world, and worlds whose window is the whole world (1
     robot) or most of it (the measurement behind ``SEQUENTIAL_ON_WINDOWS``;
     the one behind ``hbm_rtr.POSE_WORK`` is ``slice_sweep.py``'s);
 14. hold K5 and K6, the calibration chains (csrc/peak_chains.cu), against
     their plain versions on measure_peaks' inputs at 1, 7, 500 and 2,000
     steps: bit-identical (max abs error 0);
 15. drive the roofline path (``dpgo_ros_tpu_torch.scripts.roofline`` on
     the sphere2500 stand-in, short chains) with the counters zeroed just
     before: both calibrations (K5, K6) valid and within a factor 2 of each
     other, the K1 (all-ones mask) and K4 (robot 0) forced sweeps running
     3·K tCG iterations in every solve with valid slopes; K1, K4, K5 and K6
     launched;
 16. time K5 and K6 against their plain versions at 2,000 steps;
 17. (after 11) drive dpgo_demo with ``--acceleration true`` in engine
     mode, fused mode and under the Parallel rule, the counters zeroed just
     before each: K4 (K1 for Parallel) launches == updates + restarts, K7
     launches == updates and no K2 launch, cost decrease, the final cost within rel 1e-4 of the
     JAX CLI's fp32 value and the update count within 2 of its;
 18. (after 6's fixed iterations) 30 accelerated RoundRobin steps with a
     periodic restart every 10, card fp32 (K4 on the auxiliary state V) vs
     CPU fp64, cost histories within 2e-3;
 19. the certificate: ``--certify`` on the accelerated dpgo_demo run; one
     fp32 X certified on the card and on the CPU (the same verdict, crit
     residual and min eig within tolerance; Λ, S assembly and ARPACK
     timed); the fp64 staircase on the card on the 1,000-pose grid3d world
     (certified at the JAX package's rank and cost, rel 1e-8; a JSON line
     ``{"certificate": ...}`` before the card line). Phase 12's mode timing
     also times the accelerated forms. ``phase_fstar`` (the dpgo_demo
     world's certified f*, ~23 s) is left to probes.
 20. (after 17) the fleet main path: the dpgo_demo, GNC (245 planted
     outliers, 8 robots) and asapp_demo fleets at 2,500 poses through the
     CLI (``--mode fleet --device cuda``), each with the counters zeroed just
     before: K4 launched once per synchronous iteration (the ASAPP fleet's
     RGD agents launch no kernel), ticks, iterations and messages against
     the JAX CLI's (JAX_FLEETS, within the FLEET_*_SLACK bounds), the
     exported trajectory's cost (``exported_cost``) within rel 1e-4 of the
     JAX CLI's (the GNC fleet: where its accept split is JAX's), a finite
     ATE, the GNC fleet every closure decided and recall ≥ JAX's − 0.02;
 21. K4 against its plain version on one agent's local window (robot 2 of
     the dpgo_demo fleet mid-round, a third of its separator slots made
     unknown so their edges are masked; with their last poses and with
     identity placeholders): the same TR and tCG counts, f0 and gn0, X
     within 1e-4 of max |X|, separators untouched, a repeated launch
     bit-identical;
 22. fleet faults on 1,000-pose spheres: a lossy transport (drop 0.2,
     delay 1 tick, seed 3; 2 robots) and a robot killed mid-solve (3
     robots, recovery on): the survivors terminate, K4 once per iteration;
 23. (after 16) each fleet once more under torch.profiler: the card's busy
     time, K4's device time and share of it, the idle share;
 24. (after 9) the spmd mesh program: K1 and K2 against their plain
     versions on slot windows (the dpgo_demo world on 3 slots, a slot with
     1,000 padded rows and the 1,500-pose one, full and separator-only
     exchange): the same TR and tCG counts, X within tolerance, every pose
     outside the block untouched, a repeat bit-identical;
 25. the spmd main path through the CLI (``--mode spmd``) at M = 1 and at
     5 local slots (``multihost.initialize(..., local_slot_count=5)``),
     and accelerated at 5, the counters zeroed just before each: K1
     launches == the active slot-steps (+ restarts), nothing else; the JAX
     CLI's launches (within 20) and final cost (rel 1e-4; ``JAX_SPMD``); a
     finite ATE; the GNC demo at 8 slots: recall ≥ JAX's − 0.02,
     convergence ratio 1.0;
 26. stretches: M = 1, S = 8 RTR through the CLI (K2 launches ==
     launches) and against 16 per-step launches (JAX's pin), M = 5, S = 16
     RGD to ≤ 1.02·f* (launches and seconds);
 27. two processes × 2 slots on the card (gloo) against one × 4 (the
     multihost demo, 24 steps): bit-identical X and cost, and a run
     checkpointed at 12 steps and resumed by fresh processes, too;
 28. spmd timing: K1 on a slot window (device ms, ms per wrapper call with
     its mask-check read, plain, bound), K2's RGD step, and the M = 5 run
     under torch.profiler (busy, K1 share, idle share);
 29. (after 23, with 30–33) K2's RGD variant as the engine launches it (one step on the
     robot's or colour class's window, the cost carried by the window's
     f − f0) against its plain version on the dpgo_demo world after 5 RTR
     updates and on the GNC world after its first weight round (fractional
     and zero weights asserted), every robot and colour window: X and cost
     within K2's tolerances, the poses outside the block untouched, a
     repeat bit-identical;
 30. the engine with ``solver = RGD`` (stepsize 0.2) on the dpgo_demo world,
     30 updates under RoundRobin, Parallel and acceleration, the counters
     zeroed just before each: K2 launches == updates + restarts, nothing
     else; the cost history against the plain route (K2's plain version on
     the card in its wrapper's place);
 31. the fused RGD runner: 30 steps in one K2 launch (the engine route's
     cost), the GNC demo in one K2 launch per stretch (its rounds and cost
     against the engine RGD route's);
 32. the CLI's observability flags: the dpgo_demo engine run with
     ``--viz_interval_iters 10 --viz_dir --profile_dir --verbose true``
     (snapshot files and manifest; the trace's K4 launches by kernel name;
     its device-to-host copies outside the snapshots equal a run without
     ``--viz_*``: an update that writes no snapshot reads nothing more;
     the verbose lines), and ``--csv`` on per-robot CSVs of the world
     written in the phase;
 33. K2's one-step RGD launch on robot 0's window timed (device ms, ms per
     wrapper call, plain, bound);
 34. (after every traced phase) checkpoints: the dpgo_demo engine (fp32,
     K4) run 7 updates, its CUDA state saved through the dcp backend
     (``torch.distributed.checkpoint``) and through npz, each loaded onto
     the card by the CLI's resume into a fresh engine and run 5 more: cost
     and X bit-identical to the uninterrupted 12-update run, K4 once per
     resumed update; two processes on the card (gloo) save and load one
     state collectively (``scripts/dcp_check.py``), bit for bit; one line
     ``checkpoint_dcp: {...}`` with the save and load ms, the bytes on
     disk and the card's name and power limit;
 35. (after 34) the port's headline harness (``scripts/bench.py``) on the
     dpgo_demo world, one region of 4 chained gauge-rotated solves of 100
     updates per route, the counters zeroed just before: every solve ran
     100 updates, the final costs within bench.py's band, K2 once per solve
     on the fused routes (Parallel, RoundRobin), K4 once per update on the
     engine route, nothing else, and each route's per-solve wall at least
     0.9 × its tCG per solve × phase 15's least per-tCG slope; the bench's
     JSON line (block updates/s, tCG per solve, host reads per solve);
 36. (after 35) the roofline's first traces in 6 fresh processes
     (``scripts/first_trace.py``): 3 whose first padded session traces one
     reference-budget K4 solve, 3 whose first one is empty, each with a
     second trace; every trace holds every K4 launch;
 37. (after 36) the ten remaining entry points of ``scripts/``
     (``exp_tunnels_schedule`` baseline and final on the tunnels stand-in,
     ``record_ate_r03`` on its output, ``scaling_bench``,
     ``record_scaling`` (1 and 2 gloo processes), ``record_scaling_r03``,
     ``record_scaling_r05``, ``exp_spmd``, ``exp_e2e``'s four presets,
     ``micro_bench``, ``proto_chain_precond`` on smallGrid3D) in this
     process, the counters zeroed before each: one JSON line naming the
     card; K4 once per engine update (+ restart) of the sweep's runs and
     refits, of ``record_ate_r03`` and of ``exp_e2e``'s RoundRobin rows, K1
     once per Parallel update and per active slot-step of the mesh rows,
     36 K1 launches in ``micro_bench``, none in the prototype; the
     dpgo_demo solves at the JAX CLI's updates and costs, GNC recall ≥
     JAX's − 0.02, the multi-process meshes bit-identical; all ten in at
     most 90 s;
 38. (after 18) K7, the accelerated step's extrapolation, against its
     plain version on the operands of 12 accelerated dpgo_demo updates on
     the card (β 0.3 and the θ-sequence; 2,500 poses, r = 5, d = 3, a
     500-pose block): X_acc bit-equal, V_new within 1e-5, V outside the
     block untouched, a repeat bit-identical; K7 once per update, restarts
     adding none; then timed (device µs per launch, per wrapper call, the
     host's µs per call, the plain version's, the bound by bytes).

The last stdout line is ``{"ok": true, "device": {...}}``; the line before
it is the kernels JSON (name, route, source, replaced TPU kernel, launches
in the main-path run, max abs error, ms per solve, step or tick of kernel
(K1–K4: its device time from a torch.profiler trace, and in ``call_ms`` the
wrapper call's, CUDA events around it) and plain version, the bound — the larger of the bytes the call must move
over the card's memory rate and its operations over the fp32 rate, counted
over the poses and edges each block solve or robot step needs (K1 also
the world's edges outside its window, for the world's cost), with which
of the two bounds it — and the library call's time, null: no single
PyTorch call computes these functions; K1–K4 also their cluster, shared
memory per CTA and ptxas registers and stack per (d, r) instance; K1 also
its ms per robot-mask solve and per tCG, K3 its whole tick's ms, K4 K1's
ms on the same blocks and phase 13's pairs; K5 and K6 their ms at 2,000 steps, their
rate and the calibration's, and ``unfused_bound_ms``, their flops at one per
instruction: half the fp32 FMA peak, since they forbid contraction), and the line before that the card's name and
power limit. K1's launches are the
Parallel main path's, K4's the large world's, K5's and K6's the roofline
path's; ``accel_launches`` are K1's on the accelerated Parallel path and
K4's on the accelerated engine and fused paths, ``fleet_launches`` K4's on
each fleet's main path (with ``fleets``, the fleets' readings, and
``fleet_timing``, their profiles); ``spmd_launches`` are K1's on each spmd
main path and K2's on each stretch path, with the slot-window times
(``spmd_slot_ms`` and the plain and bound beside it); K2's
``engine_rgd_launches`` and ``fused_rgd_launches`` are its launches on the
engine and fused RGD paths, with the one-step RGD launch's times on a
robot window (``rgd_robot_ms`` and the plain, bound and call times beside
it); K4's ``observability`` holds phase 32's readings; ``bench_launches``
are K2's on the bench's fused routes and K4's on its engine route;
``entry_point_launches`` are K1's, K4's and K7's in each of phase 37's
scripts, and K4's ``first_trace`` holds phase 36's counts. K7's launches
are the accelerated engine path's (``accel_launches`` per form, one per
update), with ``host_us`` and ``plain_host_us``, the host's time per call
of the kernel's wrapper and of the plain version.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
from torch.profiler import ProfilerActivity

from dpgo_ros_tpu_torch.io.g2o import _quat_to_rot
from dpgo_ros_tpu_torch.io.synthetic import add_random_loop_closures, generate_world
from dpgo_ros_tpu_torch.types import EdgeType, MeasurementBatch, PoseGraphData
from dpgo_ros_tpu_torch.utils.config import AgentConfig, InitMethod, SolverMethod, UpdateRule
from dpgo_ros_tpu_torch import cli
from dpgo_ros_tpu_torch.models import certified
from dpgo_ros_tpu_torch.models.local_solvers import RTRParams
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import (
    certificate,
    fused_asapp,
    fused_rtr,
    hbm_rtr,
    nesterov,
    peak_chains,
    quadratic,
    stiefel,
)
from dpgo_ros_tpu_torch.parallel import rbcd
from dpgo_ros_tpu_torch.parallel.asapp import ASAPPEngine
from dpgo_ros_tpu_torch.parallel.comm import LossyTransport
from dpgo_ros_tpu_torch.parallel.controller import DistributedController
from dpgo_ros_tpu_torch.parallel.rbcd import (
    RBCDEngine,
    state_from_numpy,
    state_to_numpy,
)
from dpgo_ros_tpu_torch.parallel.multihost import free_port
from dpgo_ros_tpu_torch.scripts import common, dcp_check, measure_peaks, roofline
from dpgo_ros_tpu_torch.utils import checkpoint as ckpt, hostmath, profiling
from dpgo_ros_tpu_torch.utils.work import (
    FP32_FLOPS_PER_S,
    block_work,
    bound,
    edge_bytes,
    outside_work,
    rtr_flops,
    solve_bytes,
    tick_bytes,
    tick_flops,
)

# tolerances: kernel vs plain fp32 on the card (sum orders differ, the
# TR decisions must not); CPU fp64 vs card fp32 cost histories as in
# tests/test_fused_rtr.py's engine-equivalence pin
TOL_F0, TOL_F, TOL_X, TOL_HIST = 1e-5, 1e-4, 1e-4, 2e-3
# K2 vs plain over many chained steps (K1's tolerances of
# tests/test_torch_fused_rtr.py, as the CPU parity tests use for K2)
TOL_RUN_X, TOL_RUN_REL, TOL_RUN_COST = 1e-3, 1e-3, 1e-4
DEMO_PARAMS = RTRParams(max_iterations=3, max_tcg_iterations=50, gradnorm_tol=0.5)
DEV = torch.device("cuda")
# a Uniform K2 case's schedule, passed in as a caller would (the CPU tests
# pass JAX's draw this way); the uniform-draw case runs the rule's own
# draw (seed 42: robots 2, 2, 1, 4, 1, 0, 0, 4, 0, 3), a robot twice in a
# row at steps 1 and 6
UNIFORM_SCHED = [3, 0, 4, 1, 0, 2, 4, 3, 1, 2]
# ms per K2 step and per K4 solve of the one-block design the clusters
# replaced (one 256-thread block; PERF.md §6, NVIDIA H100 80GB HBM3, 700 W),
# printed beside this run's times on the timing lines only
ONE_BLOCK_K2_MS, ONE_BLOCK_K4_MS = 18.945, 7.672
# ms per K1 solve (sphere2500 robot blocks) and per K3 launch (asapp_demo)
# of the one-block designs (PERF.md §6), printed the same way
ONE_BLOCK_K1_MS, ONE_BLOCK_K3_MS = 10.943, 0.3289
# K3 vs plain over 20 chained fp32 ticks: X and the ring buffer within
# TOL_TICK_X of max |X|, the per-tick movement history within rel
# TOL_TICK_MOVED (sum orders differ; the ticks are contractive RGD steps)
TOL_TICK_X, TOL_TICK_MOVED = 1e-4, 1e-3


# template instances per cluster kernel: 16 (d, r) pairs, K3's twice (with
# and without the preconditioner)
CLUSTER_INSTANCES = {fused_rtr.SOURCE: 16, fused_rtr.RUN_SOURCE: 16,
                     fused_rtr.TICK_SOURCE: 32, fused_rtr.WINDOW_SOURCE: 16}


def phase_build() -> dict:
    """Every kernel's library, one nvcc per source started together; the
    ptxas register, stack and spill report of each. Returns {each cluster
    kernel's source stem: ptxas_instances}."""
    t = time.time()
    built = fused_rtr.build_all()
    print(f"build: {', '.join(p.name for p, _ in built)} in "
          f"{time.time() - t:.1f} s", flush=True)
    for path, log in built:
        for line in log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "stack")):
                print(f"  ptxas {path.stem}: " + line.strip())
    out = {}
    for src, (path, log) in zip(fused_rtr.ALL_SOURCES, built):
        if src in CLUSTER_INSTANCES:
            out[src.stem] = ptxas_instances(log)
            print(f"ptxas {src.stem} per (d, r) instance: "
                  + json.dumps(out[src.stem]), flush=True)
            assert len(out[src.stem]) == CLUSTER_INSTANCES[src], out[src.stem]
    return out


def ptxas_instances(log: str) -> dict:
    """{"d3r5": {"stack": bytes, "registers": n}, ...}: each template
    instance of a cluster kernel in a ptxas report (K3's keys also name the
    preconditioner flag: "d3r5p1")."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?ILi(\d)ELi(\d)E(Lb(\d)E)?", line)
        if m:
            cur = out.setdefault(f"d{m[1]}r{m[2]}" + (f"p{m[4]}" if m[4] else ""), {})
            continue
        if cur is not None:
            for key, pat in (("stack", r"(\d+) bytes stack frame"),
                             ("registers", r"Used (\d+) registers")):
                m = re.search(pat, line)
                if m:
                    cur[key] = int(m[1])
    return out


def launch_shape(w: hbm_rtr.Windows, d: int, r: int, tick: bool = False) -> dict:
    """The cluster one launch on the windows ``w`` takes: CTAs, the largest
    slice and the dynamic shared memory of each CTA (K1, K2, K4: the
    owner-only vectors, 0 when they live in the workspace; K3, ``tick``:
    the slice's P⁻¹), and for K3 the clusters of one launch."""
    if tick:
        return {"clusters": w.num_rows, "cluster": w.cluster, "threads": 256,
                "slice_max": w.slice_max, "smem_bytes_per_cta": 4 * (d + 1) ** 2 * w.slice_max}
    lib = fused_rtr._library(fused_rtr.WINDOW_SOURCE)
    return {"cluster": w.cluster, "threads": 256, "slice_max": w.slice_max,
            "smem_bytes_per_cta": int(lib.dpgo_rtr_window_smem_bytes(d, r, w.slice_max))}


def se2_world(n: int, num_robots: int, seed: int):
    """Planar ring with odometry and loop closures at index offset 50 (the
    synthetic generators are 3D; the kernel also takes d = 2)."""
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n) / 100.0
    pos = np.stack([np.cos(ang), np.sin(ang)], 1) * (5.0 + 0.01 * np.arange(n))[:, None]
    c, s = np.cos(ang + np.pi / 2), np.sin(ang + np.pi / 2)
    Rg = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], 1)
    src = np.concatenate([np.arange(n - 1), np.arange(n - 50)])
    dst = np.concatenate([np.arange(1, n), np.arange(50, n)])
    E = src.size
    th = 0.01 * rng.standard_normal(E)
    Rn = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                   np.stack([np.sin(th), np.cos(th)], -1)], 1)
    R = np.einsum("eji,ejk->eik", Rg[src], Rg[dst]) @ Rn
    t = np.einsum("eji,ej->ei", Rg[src], pos[dst] - pos[src])
    t = t + 0.05 * rng.standard_normal((E, 2))
    robot = np.minimum(np.arange(n) * num_robots // n, num_robots - 1)
    start = np.searchsorted(robot, np.arange(num_robots))
    local = np.arange(n) - start[robot]
    sr, dr = robot[src], robot[dst]
    et = np.where(sr != dr, EdgeType.SHARED_LOOP_CLOSURE,
                  np.where(dst == src + 1, EdgeType.ODOMETRY,
                           EdgeType.PRIVATE_LOOP_CLOSURE)).astype(np.int32)
    m = MeasurementBatch(
        src_robot=sr.astype(np.int32), src_frame=local[src].astype(np.int32),
        dst_robot=dr.astype(np.int32), dst_frame=local[dst].astype(np.int32),
        R=R, t=t, kappa=np.full(E, 1e4), tau=np.full(E, 400.0),
        weight=np.ones(E), fixed_weight=et == EdgeType.ODOMETRY, edge_type=et,
    )
    data = PoseGraphData(measurements=m, num_poses=np.bincount(robot).astype(np.int64), d=2)
    return data, np.concatenate([Rg, pos[:, :, None]], -1)


def noisy_state(prob: LiftedProblem, gt: np.ndarray, seed: int) -> torch.Tensor:
    """Lifted ground truth moved by a random ambient step, retracted."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((prob.r, prob.d))
    Yl, _ = np.linalg.qr(A)
    X = np.einsum("rd,ndk->nrk", Yl, gt)
    V = rng.standard_normal(X.shape)
    V[..., :-1] *= 0.05
    V[..., -1] *= 0.5
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=prob.device)
    return stiefel.retract_polar_ns(f(X), f(V))


def solve_cases(large: bool = True):
    """(name, prob, X, mask, Pinv, offsets, windows, row) for every K1
    case: each world's robot masks (on the robots' windows) and Parallel
    colour unions (on the colour windows), the sphere's all-ones mask (on
    the all-robots window) and, with ``large``, two robots of the
    50,000-pose world."""
    worlds = [
        ("sphere2500", *generate_world("sphere", n=2500, num_robots=5, seed=1)[:2]),
        ("grid3d-10", *generate_world("grid3d", grid_shape=(10, 10, 10),
                                      num_robots=5, seed=2)[:2]),
        ("se2-ring", *se2_world(1200, 4, seed=3)),
    ]
    cfg = AgentConfig(update_rule=UpdateRule.PARALLEL, dtype="float32")
    for wi, (name, data, gt) in enumerate(worlds):
        prob = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device=DEV)
        eng = RBCDEngine(prob, cfg)
        Pinv = eng._solver_cache(prob.edges)
        masks = [(f"robot{k}", eng._masks[k], eng._windows, k)
                 for k in range(prob.num_robots)]
        masks += [(f"color{c}", eng._color_masks[c], eng._row_windows, c)
                  for c in range(eng.num_colors)]
        if name == "sphere2500":
            ones = torch.ones(prob.n, device=DEV)
            masks.append(("all", ones, hbm_rtr.prepare_mask_window(prob, ones), 0))
        for mi, (mname, mask, w, row) in enumerate(masks):
            X = noisy_state(prob, gt, seed=100 * wi + mi)
            yield f"{name}/{mname}", prob, X, mask, Pinv, eng._offsets, w, row
    if large:
        name, prob, X, Pinv, w, _ = large_cases()[0]
        offs = w.offsets
        for k in K1_LARGE_ROBOTS:
            yield f"{name}/robot{k}", prob, X, prob.block_mask(k), Pinv, offs, w, k


def phase_compare() -> float:
    """K1 vs plain on every case, and K1 twice; returns the max abs X
    error. Gates: the same TR count, f0, f and X within TOL_F0 / TOL_F /
    TOL_X, the same updated flags, moved within rtol 1e-3, the second
    launch bit-identical; the wrapper raises without windows and on a mask
    that is not its row's block. Returns (max abs X error, {case: launch
    shape})."""
    worst, launches, shapes = 0.0, 0, {}
    before = _launches("k1")
    for name, prob, X, mask, Pinv, offs, w, row in solve_cases():
        kw = dict(windows=w, row=row)
        Xk, sk = fused_rtr.rtr_solve_fused(X, mask, Pinv, prob.edges, DEMO_PARAMS, offs, **kw)
        Xk2, sk2 = fused_rtr.rtr_solve_fused(X, mask, Pinv, prob.edges, DEMO_PARAMS, offs, **kw)
        launches += 2
        same = torch.equal(Xk, Xk2) and torch.equal(sk, sk2)
        Xp, sp = fused_rtr.rtr_solve_fused_ref(X, mask, Pinv, prob.edges, DEMO_PARAMS, offs)
        m3 = mask.reshape(-1, 1, 1)
        Xk = torch.where(m3 > 0, Xk, X)
        Xp = torch.where(m3 > 0, Xp, X)
        sk, sp = sk.double().cpu().numpy(), sp.double().cpu().numpy()
        err = float((Xk - Xp).abs().max())
        xrel = err / float(Xp.abs().max())
        f0rel = abs(sk[0] - sp[0]) / abs(sp[0])
        frel = abs(sk[1] - sp[1]) / abs(sp[1])
        worst = max(worst, err)
        shapes[name] = dict(launch_shape(w, prob.d, prob.r), block=int(w.num_poses[row]),
                            separators=int(w.pose_off[row + 1] - w.pose_off[row]
                                           - w.num_poses[row]))
        print(
            f"compare {name}: TR {int(sk[4])}/{int(sp[4])} tCG {int(sk[5])}/"
            f"{int(sp[5])} f0 {sk[0]:.7g} rel {f0rel:.2e} f {sk[1]:.7g} rel "
            f"{frel:.2e} X rel {xrel:.2e} (max abs {err:.2e}); repeat bit-identical "
            f"{same}; {json.dumps(shapes[name])}", flush=True,
        )
        assert np.isfinite(sk).all(), f"{name}: non-finite stats {sk}"
        assert int(sk[4]) == int(sp[4]), f"{name}: TR iterations differ"
        assert f0rel <= TOL_F0 and frel <= TOL_F and xrel <= TOL_X, name
        n_r = prob.num_robots
        upd_k = sk[6 + n_r:6 + 2 * n_r]
        assert np.array_equal(upd_k, sp[6 + n_r:6 + 2 * n_r]), f"{name}: updated flags"
        assert np.allclose(sk[6:6 + n_r], sp[6:6 + n_r], rtol=1e-3, atol=1e-6), name
        assert same, f"{name}: a second launch differs"
        assert torch.equal(Xk2[m3[:, 0, 0] == 0], X[m3[:, 0, 0] == 0]), name
    # the card's wrapper needs the windows, and the mask must be the row's block
    _, prob, X, mask, Pinv, offs, w, row = next(iter(solve_cases(large=False)))
    for bad in (dict(), dict(windows=w, row=row + 1)):
        try:
            fused_rtr.rtr_solve_fused(X, mask, Pinv, prob.edges, DEMO_PARAMS, offs, **bad)
        except ValueError as e:
            print(f"compare: refused as it must be ({e})", flush=True)
        else:
            raise AssertionError(f"K1's wrapper took {list(bad)}")
    assert _launches("k1") == before + launches
    _set_launches(k1=before)  # comparison launches
    return worst, shapes


def run_cases():
    """(name, prob, X, bank, sched, Pinv, adj, offsets, windows, run) for
    every K2 comparison case: the 2,500-pose 5-robot sphere from a noisy
    state (RoundRobin, Uniform on UNIFORM_SCHED and on the rule's own draw,
    Parallel on the colour classes' windows, a GNC exit on the cadence,
    RGD steps; RoundRobin at r = 8) and the SE(2) ring (d = 2: r = 5
    RoundRobin and Parallel, r = 2 RoundRobin)."""
    worlds = [("sphere2500", *generate_world("sphere", n=2500, num_robots=5, seed=1)[:2]),
              ("se2-ring", *se2_world(1200, 4, seed=3))]
    base = dict(last_wu=0, gnc_pending=False, tol=0.0, gnc=False, inner=1,
                inner_tol=None, record=True, rgd_stepsize=0.0)
    for wi, (name, data, gt) in enumerate(worlds):
        cases = [(5, "roundrobin", UpdateRule.ROUND_ROBIN, 10, {}),
                 (5, "uniform", UpdateRule.UNIFORM, 10, {}),
                 (5, "uniform-draw", UpdateRule.UNIFORM, 10, {}),
                 (5, "parallel", UpdateRule.PARALLEL, 6, {}),
                 (5, "gnc-exit", UpdateRule.ROUND_ROBIN, 10,
                  dict(gnc=True, gnc_pending=True, inner=3)),
                 (5, "rgd", UpdateRule.ROUND_ROBIN, 10, dict(rgd_stepsize=0.2)),
                 (8, "roundrobin", UpdateRule.ROUND_ROBIN, 5, {})]
        if name == "se2-ring":
            cases = [(5, "roundrobin", UpdateRule.ROUND_ROBIN, 4, {}),
                     (5, "parallel", UpdateRule.PARALLEL, 4, {}),
                     (2, "roundrobin", UpdateRule.ROUND_ROBIN, 4, {})]
        probs = {}
        for r, cname, rule, steps, kw in cases:
            if r not in probs:
                prob = LiftedProblem.from_data(data, r=r, dtype=torch.float32, device=DEV)
                probs[r] = (prob, noisy_state(prob, gt, seed=200 + wi))
            prob, X = probs[r]
            eng = RBCDEngine(prob, AgentConfig(num_robots=prob.num_robots,
                                               update_rule=rule, dtype="float32"))
            sched_in = UNIFORM_SCHED if cname == "uniform" else None
            bank, sched = eng.mask_bank_and_schedule(steps, sched_in)
            run = dict(base, it0=0, it_cap=steps, **kw)
            yield (f"{name}/r{r}/{cname}", prob, X, bank, sched,
                   eng._solver_cache(prob.edges), eng._adjf, eng._offsets,
                   eng._row_windows, run)


def _run_pair(prob, X, bank, sched, Pinv, adj, offs, windows, run, fn):
    rel0 = torch.full((prob.num_robots,), float("inf"), device=DEV)
    cost0 = quadratic.cost(X, prob.edges).reshape(1)
    kw = dict(adj=adj, rel0=rel0, cost0=cost0, offsets=offs, **run)
    if fn is fused_rtr.rtr_run_fused:
        kw["windows"] = windows
    return fn(X, bank, sched, Pinv, prob.edges, DEMO_PARAMS, **kw)


def phase_compare_run():
    """K2 vs its plain version on every run case; returns (the max abs X
    error, {case: launch shape})."""
    worst, shapes = 0.0, {}
    for case in run_cases():
        err, shapes[case[0]] = check_run_case(case)
        worst = max(worst, err)
    return worst, shapes


def _revisits(sched, steps: int) -> list:
    """The steps whose bank row an earlier step of the run solved."""
    s = sched[:steps].tolist()
    return [j for j in range(steps) if s[j] in s[:j]]


def check_run_case(case):
    """One K2 case against its plain version; returns (max abs X error,
    launch shape). Gates: the same exit iteration and steps, X within
    TOL_RUN_X of max |X|, rel change and history rows within rel
    TOL_RUN_REL, cost within rel TOL_RUN_COST (the kernel carries it by the
    windows' f − f0, the plain version reads the full-width f), a second
    launch bit-identical, and the same tCG iterations. Where the run's tCG
    totals differ, or the schedule solves a row twice in a row, each step
    is held alone (:func:`check_run_steps`): the tCG totals may then
    differ by steps that revisit a row, and by no other."""
    name, prob, X, bank, sched, Pinv, adj, offs, w, run = case
    args = (prob, X, bank, sched, Pinv, adj, offs, w, run)
    Xk, relk, sk, hk = _run_pair(*args, fused_rtr.rtr_run_fused)
    Xk2, relk2, sk2, hk2 = _run_pair(*args, fused_rtr.rtr_run_fused)
    Xp, relp, sp, hp = _run_pair(*args, fused_rtr.rtr_run_fused_ref)
    same = (torch.equal(Xk, Xk2) and torch.equal(sk, sk2) and torch.equal(relk, relk2)
            and torch.equal(hk.nan_to_num(), hk2.nan_to_num()))
    sk, sp = sk.double().cpu().numpy(), sp.double().cpu().numpy()
    err = float((Xk - Xp).abs().max())
    xrel = err / float(Xp.abs().max())
    rrel = _rel(relk, relp)
    hrel = _rel(hk, hp)
    crel = abs(sk[0] - sp[0]) / abs(sp[0])
    shape = launch_shape(w, prob.d, prob.r)
    steps = run["it_cap"]
    revisits = _revisits(sched, steps)
    twice = [j for j in revisits if sched[j] == sched[j - 1]]
    print(f"run {name}: it {int(sk[1])}/{int(sp[1])} steps {int(sk[2])}/"
          f"{int(sp[2])} tCG {int(sk[3])}/{int(sp[3])} cost {sk[0]:.7g} rel "
          f"{crel:.2e} X rel {xrel:.2e} (max abs {err:.2e}) rel-change rel "
          f"{rrel:.2e} history rel {hrel:.2e}; repeat bit-identical {same}; "
          f"schedule {sched.tolist()}, row twice in a row at {twice}; "
          f"{json.dumps(shape)}", flush=True)
    assert np.isfinite(sk).all() and torch.isfinite(Xk).all(), name
    assert int(sk[1]) == int(sp[1]) and int(sk[2]) == int(sp[2]), name
    assert xrel <= TOL_RUN_X and rrel <= TOL_RUN_REL and hrel <= TOL_RUN_REL, name
    assert crel <= TOL_RUN_COST, name
    assert same, f"{name}: a second launch differs"
    if run["gnc"]:
        assert int(sk[1]) == run["inner"], f"{name}: GNC exit at {int(sk[1])}"
    if int(sk[3]) != int(sp[3]) or twice:
        check_run_steps(case, revisits)
    return err, shape


def check_run_steps(case, revisits) -> None:
    """Each step j of a K2 case alone, from the kernel's own state after j
    steps (a K2 run cut there), once through K2 and once through its plain
    version. Gates: X within TOL_RUN_X of max |X| on every step, the same
    tCG count on every step not in ``revisits``. A revisited block starts
    near its local optimum (gn within a few times ``gradnorm_tol``), where
    the TR exit test and tCG's stagnation follow the fp32 sum order; where
    the counts differ, the step's block solve through K4 and its plain
    version from the same state prints the TR iterations and gn."""
    name, prob, X, bank, sched, Pinv, adj, offs, w, run = case
    rows = []
    for j in range(run["it_cap"]):
        Xj = X if j == 0 else _run_pair(prob, X, bank, sched, Pinv, adj, offs, w,
                                        dict(run, it_cap=j), fused_rtr.rtr_run_fused)[0]
        one = dict(run, it0=j, it_cap=j + 1, last_wu=j)
        Xk, _, sk, _ = _run_pair(prob, Xj, bank, sched, Pinv, adj, offs, w, one,
                                 fused_rtr.rtr_run_fused)
        Xp, _, sp, _ = _run_pair(prob, Xj, bank, sched, Pinv, adj, offs, w, one,
                                 fused_rtr.rtr_run_fused_ref)
        xrel = float((Xk - Xp).abs().max()) / float(Xp.abs().max())
        row = int(sched[j])
        rows.append((row, int(sk[3]), int(sp[3]), xrel))
        if int(sk[3]) != int(sp[3]) and not run["rgd_stepsize"]:
            s4, s4p = (fn(Xj, row, Pinv, prob.edges, DEMO_PARAMS, w)[1].tolist()
                       for fn in (hbm_rtr.rtr_solve_hbm, hbm_rtr.rtr_solve_hbm_ref))
            print(f"run {name} step {j} (row {row}) through K4/plain: TR "
                  f"{int(s4[4])}/{int(s4p[4])} tCG {int(s4[5])}/{int(s4p[5])} gn0 "
                  f"{s4[2]:.5g} gn {s4[3]:.5g}/{s4p[3]:.5g}", flush=True)
    print(f"run {name} step by step (row, tCG K2/plain, X rel; revisits {revisits}): "
          + "; ".join(f"{j}: {r} {a}/{b} {x:.2e}" for j, (r, a, b, x) in enumerate(rows)),
          flush=True)
    for j, (_, a, b, x) in enumerate(rows):
        assert x <= TOL_RUN_X, f"{name}: step {j} X"
        if j not in revisits:
            assert a == b, f"{name}: step {j} tCG {a}/{b}"


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| / max |b| over finite entries of b; non-finite entries
    (inf rel change, NaN history rows) must match exactly, else inf."""
    a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
    fin = np.isfinite(b)
    if not np.array_equal(a[~fin], b[~fin], equal_nan=True):
        return float("inf")
    if not fin.any():
        return 0.0
    return float(np.max(np.abs(a[fin] - b[fin])) / max(np.max(np.abs(b[fin])), 1e-30))


def phase_main_path(tmp: str, rule: str):
    """The CLI main path on the card under ``rule``, counting kernel
    launches: one K4 launch per RoundRobin block update, one K1 launch per
    Parallel one. Returns (launches, summary)."""
    prefix = os.path.join(tmp, f"demo-{rule}")
    summary, extras, counts = _counted_run(
        DPGO_DEMO + ["--update_rule", rule, "--output", prefix]
    )
    print(f"main path {rule}: " + json.dumps(summary), flush=True)
    print(f"main path {rule} timing_sec " + json.dumps(extras["timing_sec"]))
    print(f"main path {rule}: launches {counts} block updates "
          f"{extras['block_updates']} initial cost {extras['initial_cost']:.7g}")
    kernel = "k1" if rule == "Parallel" else "k4"
    assert extras["block_updates"] > 0
    _only(counts, **{kernel: extras["block_updates"]})
    if rule == "RoundRobin":
        assert extras["block_updates"] == DEMO_UPDATES, extras["block_updates"]
        assert abs(summary["final_cost"] - ONE_BLOCK_DEMO_COST) <= (
            TOL_MODES_COST * ONE_BLOCK_DEMO_COST), summary["final_cost"]
    assert summary["final_cost"] < extras["initial_cost"]
    assert math.isfinite(summary["ate_vs_ground_truth"])
    for suffix in ["_global.g2o", ".html"] + [f"_robot{k}.tum" for k in range(5)]:
        assert os.path.getsize(prefix + suffix) > 0, suffix
    return counts[kernel], summary


def phase_fixed_iterations() -> None:
    """20 RoundRobin iterations (tol 0) from one initial state: card fp32
    (K4) vs CPU fp64 plain path."""
    data, _, _ = generate_world("sphere", n=2500, num_robots=5, seed=42)
    base = dict(num_robots=5, update_rule=UpdateRule.ROUND_ROBIN,
                local_initialization_method=InitMethod.CHORDAL,
                relative_change_tolerance=0.0, max_iteration_number=20,
                RTR_gradnorm_tol=0.5)
    p64 = LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu")
    e64 = RBCDEngine(p64, AgentConfig(dtype="float64", **base))
    s64 = e64.initialize()
    p32 = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device=DEV)
    e32 = RBCDEngine(p32, AgentConfig(dtype="float32", **base))
    s32 = state_from_numpy(state_to_numpy(s64), dtype=torch.float32, device=DEV)
    _, i64 = e64.run(s64)
    _, i32 = e32.run(s32)
    h64 = np.array(i64["history"]["cost"])
    h32 = np.array(i32["history"]["cost"])
    rel = float(np.max(np.abs(h32 - h64) / np.abs(h64)))
    print(f"fixed 20 iterations: cost {h64[0]:.7g} -> {h64[-1]:.7g} (CPU fp64), "
          f"{h32[-1]:.7g} (card fp32), max rel history deviation {rel:.2e}")
    assert len(h64) == len(h32) == 20 and rel <= TOL_HIST


def _time(fn, reps: int) -> float:
    """ms per call: CUDA events around `reps` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _kernel_ms(fn, kernel: str, reps: int = 3) -> float:
    """Device ms per launch of the kernel whose name holds ``kernel`` over
    ``reps`` calls of ``fn`` after one warm-up, from a torch.profiler trace:
    the kernel's own time. CUDA events around a call also hold the host's
    work of the call wherever the card waits for it (a small kernel, a
    wrapper that reads a check back)."""
    fn()
    with roofline.padded_profile([ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
    rows = [r for r in prof.key_averages() if kernel in r.key]
    count = sum(r.count for r in rows)
    assert count > 0, f"the trace holds no {kernel} launch"
    return sum(r.device_time_total for r in rows) / count / 1e3


def _time_k1(kind: str):
    """K1 and its plain version per solve on the sphere2500 ``kind`` masks
    ("color": the Parallel path's, or "robot"), same inputs; returns (kernel
    device ms, plain ms, bound (ms, by), kernel ms per tCG iteration, ms
    per wrapper call)."""
    cases = [c for c in solve_cases(large=False)
             if c[0].startswith(f"sphere2500/{kind}")]
    launches_before = _launches("k1")

    def run_all(fn, windowed):
        def go():
            for _, prob, X, mask, Pinv, offs, w, row in cases:
                kw = dict(windows=w, row=row) if windowed else {}
                fn(X, mask, Pinv, prob.edges, DEMO_PARAMS, offs, **kw)
        return go

    k_ms = _time(run_all(fused_rtr.rtr_solve_fused, True), 4) / len(cases)
    p_ms = _time(run_all(fused_rtr.rtr_solve_fused_ref, False), 1) / len(cases)
    k2_ms = _time(run_all(fused_rtr.rtr_solve_fused, True), 4) / len(cases)
    dev_ms = _kernel_ms(run_all(fused_rtr.rtr_solve_fused, True), "rtr_block_kernel")
    stats = [fused_rtr.rtr_solve_fused(X, m, P, pr.edges, DEMO_PARAMS, o, windows=w,
                                       row=row)[1]
             for _, pr, X, m, P, o, w, row in cases]
    _set_launches(k1=launches_before)  # timing launches are not main path
    tcg = [int(st[5]) for st in stats]
    prob = cases[0][1]
    blocks = [m.reshape(-1).cpu().numpy() > 0 for _, _, _, m, *_ in cases]
    work = [block_work(prob, b) for b in blocks]
    outside = [outside_work(prob, b) for b in blocks]
    flops = np.mean([rtr_flops(nk, Ek, prob.r, prob.d, int(st[4]), int(st[5])) + of
                     for (nk, Ek, _), st, (_, of) in zip(work, stats, outside)])
    nbytes = np.mean([solve_bytes(prob, *w) + ob for w, (ob, _) in zip(work, outside)])
    bnd = bound(nbytes, flops)
    per_tcg = dev_ms * len(cases) / sum(tcg)
    print(f"timing per solve (sphere2500 {kind} blocks, tCG/solve {tcg}): "
          f"kernel {dev_ms:.4f} ms on the device, {per_tcg:.5f} ms per tCG iteration "
          f"(one block: {ONE_BLOCK_K1_MS} ms per robot solve); per wrapper call "
          f"{k_ms:.4f} ms, {k2_ms:.4f} ms (second pass; CUDA events, the mask check's "
          f"read-back included); plain {p_ms:.3f} ms; bound {bnd[0] * 1e3:.4f} us by "
          f"{bnd[1]} ({nbytes:.0f} B, {flops:.4g} flop; per block: poses, edges, "
          f"separator poses {work})", flush=True)
    return dev_ms, p_ms, bnd, per_tcg, min(k_ms, k2_ms)


def phase_timing():
    """K1 per solve on the sphere2500 colour masks (the Parallel path's
    work: its ms, plain ms and bound go to the kernels line) and on its
    robot masks."""
    color = _time_k1("color")
    robot = _time_k1("robot")
    return color, robot


DPGO_DEMO = ["--demo", "dpgo_demo", "--synthetic", "sphere", "--synthetic_n", "2500",
             "--device", "cuda"]
GNC_DEMO = ["--demo", "dpgo_gnc_demo", "--synthetic", "sphere", "--synthetic_n", "2500",
            "--synthetic_outlier_ratio", "0.1", "--device", "cuda"]
# outlier recall (rejected_true / planted) of the JAX CLI on the same world,
# 245 of 245 (run on a CPU host; PERF.md has the whole summary):
#   python -m dpgo_ros_tpu.cli --demo dpgo_gnc_demo --synthetic sphere \
#       --synthetic_n 2500 --synthetic_outlier_ratio 0.1 --platform cpu
JAX_GNC_RECALL = 1.0
GNC_PLANTED = 245  # 10 % of the world's 2,450 loop closures
TOL_MODES_COST, MIN_MODE_AGREEMENT = 1e-4, 0.99
# the dpgo_demo main path on the one-block kernels (engine mode, PERF.md
# §6): its updates and final cost; both modes must keep them
DEMO_UPDATES, ONE_BLOCK_DEMO_COST = 66, 12448.797


def _launches(kernel: str) -> int:
    """``kernel``'s ("k1" … "k6") launches so far (the registry's counter)."""
    return profiling.launches()[kernel]


def _set_launches(**values: int) -> None:
    """Sets kernels' launch counters, e.g. back to a reading taken before
    launches that are not the path being counted."""
    profiling.set_counters({f"{k}.launches": v for k, v in values.items()})


def _zero_counts() -> None:
    _set_launches(**{k: 0 for k in profiling.KERNELS})


# {"k1": .., ..., "k6": ..}: every kernel's launches since the zeroing
_counts = common.counts


def _counted_run(argv):
    """cli.run with every launch counter zeroed just before; returns
    (summary, extras, counts), each kernel's launches in the run."""
    _zero_counts()
    summary, extras = cli.run(argv)
    return summary, extras, _counts()


def _only(counts, **want):
    """Every kernel not named in ``want`` made no launch, the named ones
    made the launches given."""
    assert counts == dict(dict.fromkeys(counts, 0), **want), (counts, want)


def phase_fused_main_path(engine_summary):
    """--mode fused on the dpgo_demo main path: one K2 launch, no K1."""
    summary, extras, counts = _counted_run(DPGO_DEMO + ["--mode", "fused"])
    print("fused main path: " + json.dumps(summary), flush=True)
    print("fused main path timing_sec " + json.dumps(extras["timing_sec"]))
    print(f"fused main path: launches {counts}")
    _only(counts, k2=1)
    assert summary["iterations"] == DEMO_UPDATES, summary["iterations"]
    assert abs(summary["final_cost"] - ONE_BLOCK_DEMO_COST) <= (
        TOL_MODES_COST * ONE_BLOCK_DEMO_COST), summary["final_cost"]
    assert abs(summary["iterations"] - engine_summary["iterations"]) <= 1
    assert abs(summary["final_cost"] - engine_summary["final_cost"]) <= (
        TOL_MODES_COST * abs(engine_summary["final_cost"]))
    assert math.isfinite(summary["ate_vs_ground_truth"])
    return counts["k2"]


def phase_gnc():
    """The GNC demo at full width in both modes."""
    runs = {}
    for mode in ("engine", "fused"):
        t = time.time()
        summary, extras, counts = _counted_run(GNC_DEMO + ["--mode", mode])
        runs[mode] = (summary, extras)
        og = summary["outlier_ground_truth"]
        print(f"gnc {mode}: " + json.dumps(summary), flush=True)
        print(f"gnc {mode} timing_sec " + json.dumps(extras["timing_sec"]))
        print(f"gnc {mode}: weight rounds {extras['weight_rounds']}, launches "
              f"{counts}, block updates {extras['block_updates']}, "
              f"{time.time() - t:.1f} s", flush=True)
        assert extras["weight_rounds"] == 3
        if mode == "fused":
            _only(counts, k2=extras["weight_rounds"] + 1)
        else:
            _only(counts, k4=extras["block_updates"])
        assert og["planted"] == GNC_PLANTED
        assert og["rejected_true"] / og["planted"] >= JAX_GNC_RECALL - 0.02, og
        assert math.isfinite(summary["ate_vs_ground_truth"])
    n = int(GNC_DEMO[GNC_DEMO.index("--synthetic_n") + 1])
    loops = np.asarray(generate_world("sphere", n=n, num_robots=8, seed=42,
                                      outlier_ratio=0.1)[0].measurements.edge_type) != 0
    acc = {m: runs[m][1]["weights"][: loops.size][loops] > 0.5 for m in runs}
    agree = float(np.mean(acc["engine"] == acc["fused"]))
    print(f"gnc: engine and fused agree on {100 * agree:.2f} % of "
          f"{int(loops.sum())} loop closures")
    assert agree >= MIN_MODE_AGREEMENT


def phase_timing_run():
    """K2 ms per step and its plain version's, on the 10-step RoundRobin
    sphere case of phase 4 (same inputs); returns (kernel device ms, plain
    ms, bound (ms, by), ms per step of a wrapper call)."""
    case = next(c for c in run_cases() if c[0] == "sphere2500/r5/roundrobin")
    _, prob, X, bank, sched, Pinv, adj, offs, w, run = case
    steps = run["it_cap"]
    launches_before = _launches("k2")
    go = lambda fn: (lambda: _run_pair(prob, X, bank, sched, Pinv, adj, offs, w, run, fn))
    k_ms = _time(go(fused_rtr.rtr_run_fused), 3) / steps
    p_ms = _time(go(fused_rtr.rtr_run_fused_ref), 1) / steps
    k2_ms = _time(go(fused_rtr.rtr_run_fused), 3) / steps
    dev_ms = _kernel_ms(go(fused_rtr.rtr_run_fused), "rtr_run_kernel") / steps
    tcg = int(go(fused_rtr.rtr_run_fused)()[2][3])
    _set_launches(k2=launches_before)  # timing launches are not main path
    n, r, d, R = prob.n, prob.r, prob.d, prob.num_robots
    C = r * (d + 1)
    masks = bank.cpu().numpy() > 0
    work = [block_work(prob, masks[i]) for i in sched[:steps].tolist()]
    # per step its block's solve and rel change; K2 reports no TR count (one
    # TR iteration per step, the least there is) and only the run's tCG
    # total (spread evenly over the steps)
    flops = np.mean([rtr_flops(nk, Ek, r, d, 1, tcg / steps) + 3 * nk * C
                     for nk, Ek, _ in work])
    # the run reads X, P⁻¹, the schedule, the adjacency and every edge once
    # and writes X, the rel changes, the history rows and the stats once
    nbytes = (4 * (2 * n * C + n * (d + 1) ** 2 + steps + R * R + R + steps * R + 4)
              + edge_bytes(prob.edges.num_edges, d)) / steps
    bnd = bound(nbytes, flops)
    print(f"timing per step (sphere2500, 10 RoundRobin steps, {tcg} tCG): K2 "
          f"{dev_ms:.4f} ms on the device, {k_ms:.4f} ms, {k2_ms:.4f} ms per call "
          f"(CUDA events), {dev_ms * steps / tcg:.4f} ms per tCG iteration (one block: "
          f"{ONE_BLOCK_K2_MS} ms per step); plain {p_ms:.3f} ms; "
          f"bound {bnd[0] * 1e3:.4f} us by {bnd[1]} ({nbytes:.0f} B, {flops:.4g} flop)")
    return dev_ms, p_ms, bnd, min(k_ms, k2_ms)


def phase_timing_modes():
    """Solve seconds of the dpgo_demo path, engine, fused and the Parallel
    rule's engine route (K1), without and with ``--acceleration true``,
    twice in turn, all warm; with the update counts."""
    runs = {"engine": ["--mode", "engine"], "fused": ["--mode", "fused"],
            "parallel": ["--update_rule", "Parallel"]}
    runs.update({f"accel-{k}": v + ["--acceleration", "true"] for k, v in runs.items()})
    out = {k: [] for k in runs}
    updates = {}
    for key in list(runs) * 2:
        _, extras, _ = _counted_run(DPGO_DEMO + runs[key])
        out[key].append(extras["timing_sec"]["solve"])
        updates[key] = (extras["block_updates"], extras["restarts"])
    print("dpgo_demo solve seconds (warm; engine / fused / Parallel engine, then "
          "accelerated): " + json.dumps(out) + "; (updates, restarts) "
          + json.dumps(updates))
    return out


# ---------------------------------------------------------------- K3

ASAPP_DEMO = ["--demo", "asapp_demo", "--synthetic", "sphere", "--synthetic_n", "2500",
              "--device", "cuda"]
# final cost of the JAX CLI on the same world (run on a CPU host; 1,000
# ticks, the tick cap, not converged; PERF.md has the whole summary):
#   python -m dpgo_ros_tpu.cli --demo asapp_demo --synthetic sphere \
#       --synthetic_n 2500 --platform cpu
JAX_ASAPP_COST = 12551.484375
TOL_ASAPP_COST = 0.01
TICKS = 20
# the mid-chunk stop: a free run of this many ticks picks the tolerance,
# the stopped run goes in chunks of this many
ASYNC_STOP_TICKS, ASYNC_STOP_CHUNK = 120, 25


def _tick_chain(fn, eng: ASAPPEngine, X0, hist0, table, events=None):
    """``len(table)`` ticks through ``fn`` (K3's wrapper or its plain
    version) from (X0, hist0), with the engine's operands and the ring
    write after each tick; with a list ``events``, a pair of CUDA events
    around each call of ``fn`` (the ring write outside) is appended to it.
    Returns (X, ring buffer, movement (T, R))."""
    X, hist, moved = X0, hist0.clone(), []
    for t in range(table.shape[0]):
        if events is not None:
            events.append([torch.cuda.Event(enable_timing=True) for _ in range(2)])
            events[-1][0].record()
        kw = {"windows": eng._windows} if fn is fused_asapp.asapp_tick_fused else {}
        Xn, m = fn(X, hist, eng._masks, eng._Pinv, eng.problem.edges, table[t],
                   eng.rgd.stepsize, eng.steps_per_tick, eng.rgd.use_preconditioner,
                   eng._offsets, **kw)
        if events is not None:
            events[-1][1].record()
        hist[t % (eng.K + 1)].copy_(X)
        X = Xn
        moved.append(m)
    return X, hist, torch.stack(moved)


def tick_cases():
    """(name, engine, X0, hist0, delay table) of the K3 comparison: the
    2,500-pose 5-robot sphere from a noisy state and a ring of distinct
    noisy states, K = 3, one fixed (TICKS, R) delay table, 1 or 2 steps per
    tick, with the preconditioner (stepsize 0.2, asapp_demo's) and without
    (stepsize 5e-6: unpreconditioned steps need one below 1/‖Q‖); then the
    1,200-pose 4-robot SE(2) ring (d = 2), 1 and 2 preconditioned steps; and
    the 50,000-pose 16-robot world, 1 preconditioned step (16 clusters of 14
    CTAs in one launch)."""
    worlds = [  # (name, world, cases): each world made when its turn comes
        ("sphere2500", lambda: generate_world("sphere", n=2500, num_robots=5, seed=1)[:2],
         ((1, True, 0.2), (1, False, 5e-6), (2, True, 0.2), (2, False, 5e-6))),
        ("se2-ring", lambda: se2_world(1200, 4, seed=3), ((1, True, 0.2), (2, True, 0.2))),
        ("sphere50k", lambda: generate_world("sphere", n=LARGE_N, num_robots=LARGE_ROBOTS,
                                             seed=0)[:2], ((1, True, 0.2),))]
    for wi, (wname, make, cases) in enumerate(worlds):
        data, gt = make()
        prob = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device=DEV)
        R = prob.num_robots
        X0 = noisy_state(prob, gt, seed=300 + 10 * wi)
        hist0 = torch.stack([noisy_state(prob, gt, seed=301 + 10 * wi + j) for j in range(4)])
        table = torch.randint(0, 4, (TICKS, R), generator=torch.Generator().manual_seed(5),
                              dtype=torch.int32).to(DEV)
        for steps, precond, gamma in cases:
            cfg = AgentConfig(num_robots=R, asynchronous=True, dtype="float32",
                              asynchronous_rate=100.0 * steps, RGD_stepsize=gamma,
                              RGD_use_preconditioner=precond, max_delayed_iterations=3)
            name = f"{wname}/steps{steps}/{'precond' if precond else 'plain-rgd'}"
            yield name, ASAPPEngine(prob, cfg), X0, hist0, table


def phase_compare_tick():
    """K3 vs its plain version over TICKS chained ticks per case, and the
    kernel's chain twice; returns (the max abs X error, {world: launch
    shape}). Gates: X and the ring buffer within TOL_TICK_X of max |X|, the
    movement history within rel TOL_TICK_MOVED, the second chain
    bit-identical; the wrapper raises without windows."""
    worst, shapes, launches = 0.0, {}, 0
    launches_before = _launches("k3")
    k3 = fused_asapp.asapp_tick_fused
    for name, eng, X0, hist0, table in tick_cases():
        Xk, Hk, mk = _tick_chain(k3, eng, X0, hist0, table)
        Xk2, Hk2, mk2 = _tick_chain(k3, eng, X0, hist0, table)
        launches += 2 * TICKS
        same = torch.equal(Xk, Xk2) and torch.equal(Hk, Hk2) and torch.equal(mk, mk2)
        Xp, Hp, mp = _tick_chain(fused_asapp.asapp_tick_fused_ref, eng, X0, hist0, table)
        scale = float(Xp.abs().max())
        err = float((Xk - Xp).abs().max())
        herr = float((Hk - Hp).abs().max())
        mrel = _rel(mk, mp)
        worst = max(worst, err)
        shapes[name.split("/")[0]] = launch_shape(eng._windows, eng.problem.d,
                                                  eng.problem.r, tick=True)
        print(f"tick {name}: X rel {err / scale:.2e} (max abs {err:.2e}) ring rel "
              f"{herr / scale:.2e} movement rel {mrel:.2e} (last tick "
              f"{float(mp[-1].max()):.4g}); repeat bit-identical {same}; "
              f"{json.dumps(shapes[name.split('/')[0]])}", flush=True)
        assert torch.isfinite(Xk).all() and torch.isfinite(mk).all(), name
        assert err <= TOL_TICK_X * scale and herr <= TOL_TICK_X * scale, name
        assert mrel <= TOL_TICK_MOVED, name
        assert same, f"{name}: a repeated chain differs"
    _, eng, X0, hist0, table = next(iter(tick_cases()))
    try:
        k3(X0, hist0, eng._masks, eng._Pinv, eng.problem.edges, table[0], 0.2, 1, True,
           eng._offsets)
    except ValueError as e:
        print(f"tick: refused as it must be ({e})", flush=True)
    else:
        raise AssertionError("K3's wrapper took no windows on the card")
    assert _launches("k3") == launches_before + launches
    _set_launches(k3=launches_before)  # comparison launches
    return worst, shapes


def phase_async_main_path():
    """The async main path on the card, counting K3 launches."""
    summary, extras, counts = _counted_run(ASAPP_DEMO)
    launches = counts["k3"]
    print("async main path: " + json.dumps(summary), flush=True)
    print("async main path timing_sec " + json.dumps(extras["timing_sec"]))
    print(f"async main path: launches {counts}, ticks {summary['ticks']}, "
          f"initial cost {extras['initial_cost']:.7g}, "
          f"ATE {extras['ate_vs_ground_truth']:.6g}, JAX CLI cost {JAX_ASAPP_COST}")
    assert summary["ticks"] > 0
    _only(counts, k3=summary["ticks"])
    assert summary["final_cost"] < extras["initial_cost"]
    assert summary["final_cost"] <= (1 + TOL_ASAPP_COST) * JAX_ASAPP_COST
    assert math.isfinite(extras["ate_vs_ground_truth"])
    return launches, summary, extras


def phase_async_fixed_ticks() -> None:
    """50 asapp_demo ticks (tol 0) from one chordal initial state and one
    delay table: card fp32 (K3) vs CPU fp64 (plain), cost after each tick."""
    data, _, _ = generate_world("sphere", n=2500, num_robots=5, seed=42)
    base = dict(num_robots=5, asynchronous=True, asynchronous_rate=100.0,
                RGD_stepsize=0.2, max_delayed_iterations=3,
                update_rule=UpdateRule.ROUND_ROBIN,  # the CLI's, for initialize
                local_initialization_method=InitMethod.CHORDAL)
    p64 = LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu")
    X0 = RBCDEngine(p64, AgentConfig(dtype="float64", **base)).initialize().X
    p32 = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device=DEV)
    table = torch.randint(0, 4, (50, 5), generator=torch.Generator().manual_seed(7))
    launches_before = _launches("k3")
    _, i64 = ASAPPEngine(p64, AgentConfig(dtype="float64", **base)).run(
        X0, num_ticks=50, chunk=1, delays=table)
    _, i32 = ASAPPEngine(p32, AgentConfig(dtype="float32", **base)).run(
        X0.to(device=DEV, dtype=torch.float32), num_ticks=50, chunk=1, delays=table)
    assert _launches("k3") == launches_before + 50
    _set_launches(k3=launches_before)  # not the main path
    h64, h32 = np.array(i64["costs"]), np.array(i32["costs"])
    rel = float(np.max(np.abs(h32 - h64) / np.abs(h64)))
    print(f"fixed 50 ticks: cost {h64[0]:.7g} -> {h64[-1]:.7g} (CPU fp64), "
          f"{h32[-1]:.7g} (card fp32), max rel history deviation {rel:.2e}")
    assert len(h64) == len(h32) == 51 and rel <= TOL_HIST


def phase_async_stop():
    """The async runner on the card with a tolerance whose stop falls
    mid-chunk. A free run of ASYNC_STOP_TICKS ticks (tol 0) records every
    tick's movement; the tolerance is picked from it so that the first tick
    after which every robot moved less than it is not a chunk's last. The
    stopped run (chunks of ASYNC_STOP_CHUNK) must end there, its recorded
    movement be the free run's rows up to it, and its X, ring buffer and
    generator equal those of a run of exactly that many ticks; the launches
    run on to the chunk's end (the stopped ticks copy X)."""
    data, gt, _ = generate_world("sphere", n=2500, num_robots=5, seed=42)
    prob = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device=DEV)
    eng = ASAPPEngine(prob, AgentConfig(num_robots=5, asynchronous=True, dtype="float32",
                                        asynchronous_rate=100.0, RGD_stepsize=0.2,
                                        max_delayed_iterations=3))
    X0 = noisy_state(prob, gt, seed=700)
    N, chunk = ASYNC_STOP_TICKS, ASYNC_STOP_CHUNK
    before = _launches("k3")
    _, free = eng.run(X0, num_ticks=N, chunk=N, record=True)
    M = free["rel_hist"].max(axis=1)  # every robot below tol after tick t iff M[t] < tol
    stop = None
    for t in range(N // 3, N - 1):  # a tick that sets a new low, not at a chunk's end
        if M[t] < M[:t].min() and (t + 1) % chunk:
            stop = t
            break
    assert stop is not None, M
    tol = float(np.sqrt(M[stop] * M[:stop].min()))  # between the new low and the last
    st, info = eng.run(X0, num_ticks=N, chunk=chunk, tol=tol, record=True)
    ref, _ = eng.run(X0, num_ticks=stop + 1, chunk=N)
    gen = torch.Generator().manual_seed(eng.config.seed)
    torch.randint(0, eng.K + 1, (stop + 1, 5), generator=gen)
    launched = _launches("k3") - before
    _set_launches(k3=before)  # not the main path
    rows = info["rel_hist"]
    print(f"async stop: tol {tol:.6g}, stop after tick {stop} (chunk {chunk}), ran "
          f"{info['ticks']} ticks, converged {info['converged']}, rows recorded "
          f"{rows.shape[0]}, max movement of the last {float(rows[-1].max()):.6g}; K3 "
          f"launches {launched}", flush=True)
    assert info["ticks"] == stop + 1 and info["converged"], info["ticks"]
    assert np.array_equal(rows, free["rel_hist"][:stop + 1])
    assert torch.equal(st.X, ref.X) and torch.equal(st.hist, ref.hist)
    assert torch.equal(st.rng, gen.get_state())
    assert launched == N + min(-(-(stop + 1) // chunk) * chunk, N) + stop + 1, launched


def _time_calls(fn, eng, X0, hist0, table, reps: int) -> float:
    """ms per call of ``fn`` alone (CUDA events around each call, the ring
    write outside them) over ``reps`` TICKS-tick chains after one warm-up."""
    _tick_chain(fn, eng, X0, hist0, table)
    events = []
    for _ in range(reps):
        _tick_chain(fn, eng, X0, hist0, table, events)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / len(events)


def phase_timing_tick():
    """K3 ms per launch (on the device, from the profiler) and per wrapper
    call (CUDA events around it) and its plain version's per call, over the
    TICKS-tick chain of the asapp_demo case (1 step, preconditioned), and
    the whole tick's (ring write and glue included); returns (kernel device
    ms, plain ms, bound (ms, by), tick ms, ms per wrapper call)."""
    name, eng, X0, hist0, table = next(iter(tick_cases()))
    launches_before = _launches("k3")
    k3, ref = fused_asapp.asapp_tick_fused, fused_asapp.asapp_tick_fused_ref
    k_ms = _time_calls(k3, eng, X0, hist0, table, 5)
    p_ms = _time_calls(ref, eng, X0, hist0, table, 1)
    k2_ms = _time_calls(k3, eng, X0, hist0, table, 5)
    tick_ms = _time(lambda: _tick_chain(k3, eng, X0, hist0, table), 5) / TICKS
    dev_ms = _kernel_ms(lambda: _tick_chain(k3, eng, X0, hist0, table), "asapp_tick_kernel")
    _set_launches(k3=launches_before)  # timing launches are not main path
    prob, precond = eng.problem, eng.rgd.use_preconditioner
    nbytes = tick_bytes(prob, precond)
    flops = tick_flops(prob, eng.steps_per_tick, precond)
    bnd = bound(nbytes, flops)
    print(f"timing per tick ({name}, {TICKS} ticks): K3 {dev_ms:.4f} ms per launch on "
          f"the device (one block: {ONE_BLOCK_K3_MS} ms), {k_ms:.4f} ms, {k2_ms:.4f} ms "
          f"per wrapper call (CUDA events), plain {p_ms:.3f} ms per call; whole tick "
          f"with the ring write {tick_ms:.4f} ms; bound {bnd[0] * 1e3:.4f} us by "
          f"{bnd[1]} ({nbytes:.0f} B, {flops:.4g} flop)")
    return dev_ms, p_ms, bnd, tick_ms, min(k_ms, k2_ms)


def phase_timing_async():
    """Solve seconds of the asapp_demo path, twice, warm."""
    out = []
    for _ in range(2):
        _, extras, _ = _counted_run(ASAPP_DEMO)
        t = extras["timing_sec"]
        out.append(t["solve"])
        print(f"asapp_demo solve {t['solve']:.4f} s over {t['ticks']} ticks "
              f"({1e3 * t['solve'] / t['ticks']:.4f} ms per tick), init "
              f"{t['init']:.3f} s", flush=True)
    return out


# ---------------------------------------------------------------- K4

# the large world: the largest row of the JAX package's large-world record
# (scripts/bench_scale_hbm.py), 50,000 poses, 99,775 edges, 16 robots
LARGE_N, LARGE_ROBOTS, LARGE_LOOPS = 50000, 16, 1000
K4_ROBOTS = (0, 5, 10, 15)
K1_LARGE_ROBOTS = (0, 10)  # K1 against its plain version (full-width at 50k)
# K4 vs plain (fp32 on the card; sum orders differ, the TR decisions must
# not): X within TOL_K4_X of max |X|, f − f0 within rel TOL_K4_DF; K4 vs
# K1 (on the same window; K1's f adds the world's edges outside it): gn and
# f − f0 within rel TOL_K4_K1, X within TOL_K4_X of max |X|; the two
# routes' sweep histories within rel TOL_SWEEP
TOL_K4_X, TOL_K4_DF, TOL_K4_K1, TOL_SWEEP = 1e-4, 1e-4, 1e-3, 1e-3
# bench_scale_hbm.py's settings, capped at 10 sweeps
LARGE = ["--synthetic", "sphere", "--synthetic_n", str(LARGE_N), "--num_robots",
         str(LARGE_ROBOTS), "--local_initialization_method", "Odometry",
         "--update_rule", "RoundRobin", "--RTR_gradnorm_tol", "0.5",
         "--relative_change_tolerance", "0.2", "--max_iteration_number",
         str(10 * LARGE_ROBOTS), "--device", "cuda"]
_large = {}


def large_cases():
    """(name, prob, X, Pinv, windows, robots) of the 50,000-pose 16-robot
    sphere from a noisy state, banded (r = 5 and r = 8, whose slices do
    not fit in shared memory) and with LARGE_LOOPS loop closures between
    random pose pairs (built once)."""
    if not _large:
        data, gt, _ = generate_world("sphere", n=LARGE_N, num_robots=LARGE_ROBOTS, seed=0)
        worlds = [("sphere50k", data, 5, K4_ROBOTS),
                  ("sphere50k+loops",
                   add_random_loop_closures(data, gt, LARGE_LOOPS, seed=9), 5, K4_ROBOTS),
                  ("sphere50k/r8", data, 8, (0, 15))]
        for wi, (name, d, r, robots) in enumerate(worlds):
            prob = LiftedProblem.from_data(d, r=r, dtype=torch.float32, device=DEV)
            Pinv = quadratic.precond_inverse(
                quadratic.precond_blocks(prob.edges, prob.n)).contiguous()
            _large[name] = (name, prob, noisy_state(prob, gt, seed=400 + wi), Pinv,
                            hbm_rtr.prepare_windows(prob), robots)
    return list(_large.values())


def rank_cases():
    """(name, prob, X, Pinv, windows, robots) below the large world: the
    2,500-pose 5-robot sphere at r = 5 and 8 (d = 3) and the 1,200-pose
    SE(2) ring at r = 2 and 5 (d = 2), from noisy states."""
    worlds = [("sphere2500", *generate_world("sphere", n=2500, num_robots=5, seed=1)[:2],
               (5, 8), (0, 2, 4)),
              ("se2-ring", *se2_world(1200, 4, seed=3), (2, 5), (0, 3))]
    for name, data, gt, ranks, robots in worlds:
        for r in ranks:
            prob = LiftedProblem.from_data(data, r=r, dtype=torch.float32, device=DEV)
            Pinv = quadratic.precond_inverse(
                quadratic.precond_blocks(prob.edges, prob.n)).contiguous()
            yield (f"{name}/r{r}", prob, noisy_state(prob, gt, seed=450 + r), Pinv,
                   hbm_rtr.prepare_windows(prob), robots)


def _df_rel(a, b) -> float:
    """rel deviation of the cost change f − f0 of two stats vectors."""
    return abs((a[1] - a[0]) - (b[1] - b[0])) / abs(b[1] - b[0])


def phase_compare_window():
    """K4 vs its plain version and vs K1 (on the same robot window) on
    every large and rank case; returns (the max abs X error against the
    plain version, {case: launch shape}). Gates: the same TR and tCG
    counts, X within TOL_K4_X of max |X|, f − f0 within rel TOL_K4_DF
    (plain) or TOL_K4_K1 (K1, with gn), every pose outside the block
    bit-identical to the input, a second launch bit-identical; for the
    first robot of each case, :func:`check_window_repeat`."""
    worst, shapes, launches = 0.0, {}, 0
    before = _launches("k4"), _launches("k1")
    for name, prob, X, Pinv, w, robots in [*large_cases(), *rank_cases()]:
        shapes[name] = launch_shape(w, prob.d, prob.r)
        print(f"window {name}: {w.max_poses} poses and {w.max_edges} edges at most; "
              + json.dumps(shapes[name]), flush=True)
        for k in robots:
            mask = prob.block_mask(k)
            out = mask[:, 0, 0] == 0
            Xk, sk = hbm_rtr.rtr_solve_hbm(X, k, Pinv, prob.edges, DEMO_PARAMS, w)
            Xk2, sk2 = hbm_rtr.rtr_solve_hbm(X, k, Pinv, prob.edges, DEMO_PARAMS, w)
            launches += 2
            same = torch.equal(Xk, Xk2) and torch.equal(sk, sk2)
            Xp, sp = hbm_rtr.rtr_solve_hbm_ref(X, k, Pinv, prob.edges, DEMO_PARAMS, w)
            X1, s1 = fused_rtr.rtr_solve_fused(X, mask, Pinv, prob.edges, DEMO_PARAMS,
                                               windows=w, row=k)
            X1 = torch.where(mask > 0, X1, X)
            sk, sp, s1 = (v.double().cpu().numpy() for v in (sk, sp, s1))
            scale = float(Xp.abs().max())
            err, err1 = float((Xk - Xp).abs().max()), float((Xk - X1).abs().max())
            dfp, df1 = _df_rel(sk, sp), _df_rel(sk, s1)
            gn1 = abs(sk[3] - s1[3]) / abs(s1[3])
            worst = max(worst, err)
            print(f"window {name}/robot{k}: TR {int(sk[4])}/{int(sp[4])}/{int(s1[4])} "
                  f"tCG {int(sk[5])}/{int(sp[5])}/{int(s1[5])} (K4/plain/K1) f-f0 "
                  f"{sk[1] - sk[0]:.7g} rel {dfp:.2e} / K1 {df1:.2e}; X rel "
                  f"{err / scale:.2e} / K1 {err1 / scale:.2e}; gn {sk[3]:.5g} K1 rel "
                  f"{gn1:.2e}; moved {sk[6]:.5g}; repeat bit-identical {same}", flush=True)
            assert np.isfinite(sk).all() and torch.isfinite(Xk).all(), name
            assert int(sk[4]) == int(sp[4]) == int(s1[4]), f"{name}/{k}: TR iterations"
            assert int(sk[5]) == int(sp[5]) == int(s1[5]), f"{name}/{k}: tCG iterations"
            assert err <= TOL_K4_X * scale and dfp <= TOL_K4_DF, f"{name}/{k}: vs plain"
            assert err1 <= TOL_K4_X * scale, f"{name}/{k}: X vs K1"
            assert df1 <= TOL_K4_K1 and gn1 <= TOL_K4_K1, f"{name}/{k}: vs K1"
            assert torch.equal(Xk[out], X[out]) and torch.equal(Xp[out], X[out]), name
            assert same, f"{name}/{k}: a second launch differs"
            if k == robots[0]:
                check_window_repeat(f"{name}/robot{k}", prob, Xk, k, Pinv, w)
                launches += 1
    assert _launches("k4") == before[0] + launches
    _set_launches(k4=before[0], k1=before[1])  # comparison launches
    return worst, shapes


def check_window_repeat(name, prob, X1, k, Pinv, w) -> None:
    """Robot k solved again at once from K4's first solve ``X1``, through
    K4 and its plain version (a RoundRobin sweep never does this, a
    Uniform draw does). Gates: the same TR iterations, X within TOL_RUN_X
    of max |X|, f within rel TOL_RUN_COST (K2's tolerances over chained
    steps: this is a chain of two); the tCG count may differ."""
    Xk, sk = hbm_rtr.rtr_solve_hbm(X1, k, Pinv, prob.edges, DEMO_PARAMS, w)
    Xp, sp = hbm_rtr.rtr_solve_hbm_ref(X1, k, Pinv, prob.edges, DEMO_PARAMS, w)
    sk, sp = sk.double().cpu().numpy(), sp.double().cpu().numpy()
    xrel = float((Xk - Xp).abs().max()) / float(Xp.abs().max())
    frel = abs(sk[1] - sp[1]) / abs(sp[1])
    print(f"window {name} solved again: TR {int(sk[4])}/{int(sp[4])} tCG "
          f"{int(sk[5])}/{int(sp[5])} (K4/plain) gn0 {sk[2]:.5g} gn {sk[3]:.5g}/"
          f"{sp[3]:.5g} f {sk[1]:.7g} rel {frel:.2e} X rel {xrel:.2e}", flush=True)
    assert np.isfinite(sk).all() and torch.isfinite(Xk).all(), name
    assert int(sk[4]) == int(sp[4]), f"{name}: TR iterations when solved again"
    assert xrel <= TOL_RUN_X and frel <= TOL_RUN_COST, f"{name}: solved again"


def phase_large_main_path(tmp: str):
    """The large-world main path on the card, counting kernel launches;
    returns (K4 launches, summary, extras)."""
    prefix = os.path.join(tmp, "large")
    summary, extras, counts = _counted_run(LARGE + ["--output", prefix])
    k4 = counts["k4"]
    t = extras["timing_sec"]
    print("large main path: " + json.dumps(summary), flush=True)
    print("large main path timing_sec " + json.dumps(t))
    print(f"large main path: launches {counts}, block "
          f"updates {extras['block_updates']}, initial cost "
          f"{extras['initial_cost']:.7g}, solve {t['solve']:.4f} s = "
          f"{1e3 * t['solve'] / extras['block_updates']:.4f} ms per block update")
    assert extras["block_updates"] > 0
    _only(counts, k4=extras["block_updates"])
    assert summary["final_cost"] < extras["initial_cost"]
    assert math.isfinite(summary["ate_vs_ground_truth"])
    for suffix in ["_global.g2o"] + [f"_robot{k}.tum" for k in range(LARGE_ROBOTS)]:
        assert os.path.getsize(prefix + suffix) > 0, suffix
    return k4, summary, extras


def phase_large_sweep() -> None:
    """One sweep of 16 RoundRobin updates (tol 0) on the CLI's large world
    from one Odometry state: K4, then K1 (``SEQUENTIAL_ON_WINDOWS`` off),
    both on the robots' windows; cost and rel-change histories within
    TOL_SWEEP."""
    data, _, _ = generate_world("sphere", n=LARGE_N, num_robots=LARGE_ROBOTS, seed=42)
    prob = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device=DEV)
    cfg = AgentConfig(num_robots=LARGE_ROBOTS, update_rule=UpdateRule.ROUND_ROBIN,
                      local_initialization_method=InitMethod.ODOMETRY,
                      relative_change_tolerance=0.0, RTR_gradnorm_tol=0.5,
                      max_iteration_number=LARGE_ROBOTS, dtype="float32")
    eng = RBCDEngine(prob, cfg)
    st0 = eng.initialize()
    before = _launches("k4"), _launches("k1")
    _, i4 = eng.run(st0)
    with mock.patch.object(rbcd, "SEQUENTIAL_ON_WINDOWS", False):
        _, i1 = eng.run(st0)
    assert _launches("k4") == before[0] + LARGE_ROBOTS
    assert _launches("k1") == before[1] + LARGE_ROBOTS
    _set_launches(k4=before[0], k1=before[1])  # not the main path
    h4, h1 = i4["history"], i1["history"]
    crel = _rel(torch.tensor(h4["cost"]), torch.tensor(h1["cost"]))
    rrel = _rel(torch.tensor(h4["rel_change"]), torch.tensor(h1["rel_change"]))
    rrob = _rel(torch.tensor(np.stack(h4["rel_change_robots"])),
                torch.tensor(np.stack(h1["rel_change_robots"])))
    print(f"large sweep: cost {float(st0.cost):.7g} -> {h4['cost'][-1]:.7g} (K4), "
          f"{h1['cost'][-1]:.7g} (K1); history rel: cost {crel:.2e}, "
          f"rel change {rrel:.2e}, per robot {rrob:.2e}; solve {i4['total_time_sec']:.3f} s "
          f"(K4) vs {i1['total_time_sec']:.3f} s (K1)", flush=True)
    assert len(h4["cost"]) == len(h1["cost"]) == LARGE_ROBOTS
    assert crel <= TOL_SWEEP and rrel <= TOL_SWEEP and rrob <= TOL_SWEEP


def phase_timing_window():
    """K4 ms per solve over the 16 blocks of the banded large case, K1 (on
    the same windows) per solve on K4_ROBOTS, the plain version per solve
    over the 16 blocks, same inputs; returns (K4 device ms, plain ms, bound
    (ms, by), K4 ms per wrapper call, K1 device ms, K1 ms per call)."""
    _, prob, X, Pinv, w, _ = large_cases()[0]
    before = _launches("k4"), _launches("k1")
    robots = range(LARGE_ROBOTS)
    masks = {k: prob.block_mask(k) for k in K4_ROBOTS}
    k4 = lambda: [hbm_rtr.rtr_solve_hbm(X, k, Pinv, prob.edges, DEMO_PARAMS, w)
                  for k in robots]
    ref = lambda: [hbm_rtr.rtr_solve_hbm_ref(X, k, Pinv, prob.edges, DEMO_PARAMS, w)
                   for k in robots]
    k1 = lambda: [fused_rtr.rtr_solve_fused(X, masks[k], Pinv, prob.edges, DEMO_PARAMS,
                                            windows=w, row=k)
                  for k in K4_ROBOTS]
    k_ms = _time(k4, 3) / LARGE_ROBOTS
    p_ms = _time(ref, 1) / LARGE_ROBOTS
    k1_ms = _time(k1, 3) / len(K4_ROBOTS)
    k2_ms = _time(k4, 3) / LARGE_ROBOTS
    dev_ms = _kernel_ms(k4, "rtr_window_kernel")
    k1_dev_ms = _kernel_ms(k1, "rtr_block_kernel")
    stats = [s.double().cpu().numpy() for _, s in k4()]
    stats1 = [s.double().cpu().numpy() for _, s in k1()]
    _set_launches(k4=before[0], k1=before[1])  # timing launches
    tcg = [int(s[5]) for s in stats]
    tcg1 = [int(s[5]) for s in stats1]
    rof = np.asarray(prob.robot_of_pose)
    work = [block_work(prob, rof == k) for k in robots]
    flops = np.mean([rtr_flops(nk, Ek, prob.r, prob.d, int(s[4]), int(s[5]))
                     for (nk, Ek, _), s in zip(work, stats)])
    nbytes = np.mean([solve_bytes(prob, *wk, stats=hbm_rtr.STATS_LEN) for wk in work])
    bnd = bound(nbytes, flops)
    km = min(k_ms, k2_ms)
    print(f"timing per solve (sphere50k, 16 robot blocks, tCG/solve {tcg}): K4 "
          f"{dev_ms:.4f} ms on the device, {dev_ms / np.mean(tcg):.4f} ms per tCG "
          f"iteration (one block: {ONE_BLOCK_K4_MS} ms per solve), {k_ms:.4f} ms, "
          f"{k2_ms:.4f} ms per wrapper call (CUDA events); K1 {k1_dev_ms:.4f} ms on the "
          f"device, {k1_ms:.4f} ms per call on robots {K4_ROBOTS} "
          f"(tCG {tcg1}, {k1_dev_ms / np.mean(tcg1):.4f} ms per tCG iteration); plain "
          f"{p_ms:.3f} ms; bound {bnd[0] * 1e3:.4f} us by {bnd[1]} ({nbytes:.0f} B, "
          f"{flops:.4g} flop; per block: poses, edges, separator poses "
          f"{sorted(set(work))})")
    return dev_ms, p_ms, bnd, km, k1_dev_ms, k1_ms


# K4 against K1 (on the same window) per block solve, below the large world: the
# dpgo_demo world (2,500 poses, 5 robots) and worlds whose block is the
# whole world (1 robot) or most of it; (n, robots)
GATE_WORLDS = ((2500, 5), (2500, 1), (2500, 2), (10000, 4), (20000, 8))


def phase_gate_sweep():
    """K4 and K1 ms per block solve on the same inputs and windows (noisy
    state, the same robots, up to 4 per world) for every GATE_WORLDS
    world; returns {world: (K4 ms, K1 ms)}."""
    before = _launches("k4"), _launches("k1")
    out = {}
    for n, R in GATE_WORLDS:
        data, gt, _ = generate_world("sphere", n=n, num_robots=R, seed=1)
        prob = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device=DEV)
        Pinv = quadratic.precond_inverse(
            quadratic.precond_blocks(prob.edges, prob.n)).contiguous()
        w = hbm_rtr.prepare_windows(prob)
        X = noisy_state(prob, gt, seed=500 + R)
        robots = range(min(R, 4))
        masks = {k: prob.block_mask(k) for k in robots}
        k4 = lambda: [hbm_rtr.rtr_solve_hbm(X, k, Pinv, prob.edges, DEMO_PARAMS, w)
                      for k in robots]
        k1 = lambda: [fused_rtr.rtr_solve_fused(X, masks[k], Pinv, prob.edges,
                                                DEMO_PARAMS, windows=w, row=k)
                      for k in robots]
        t4 = min(_time(k4, 2), _time(k4, 2)) / len(robots)
        t1 = min(_time(k1, 2), _time(k1, 2)) / len(robots)
        s4 = [s.double().cpu().numpy() for _, s in k4()]
        s1 = [s.double().cpu().numpy() for _, s in k1()]
        tcg4, tcg1 = [int(s[5]) for s in s4], [int(s[5]) for s in s1]
        name = f"sphere{n}/{R}"
        out[name] = (t4, t1)
        print(f"gate {name}: window poses {w.max_poses} of {n}, K4 {t4:.3f} ms, K1 "
              f"{t1:.3f} ms per solve (K1/K4 {t1 / t4:.3f}); tCG "
              f"{tcg4} / {tcg1}", flush=True)
        assert tcg4 == tcg1, name
    _set_launches(k4=before[0], k1=before[1])  # timing launches
    return out


# ---------------------------------------------------------------- K5, K6

# name: (kernel wrapper, plain version, measure_peaks input, flops per
# element and step)
CHAINS = {
    "peak_chain": (peak_chains.chain_fused, peak_chains.chain_ref,
                   measure_peaks.K5_INPUT, peak_chains.CHAIN_FLOPS),
    "peak_chain_cml": (peak_chains.chain_cml_fused, peak_chains.chain_cml_ref,
                       measure_peaks.K6_INPUT, peak_chains.CML_FLOPS),
}
CHAIN_STEPS, CHAIN_TIMING_STEPS = (1, 7, 500, 2000), 2000
# the roofline phase's chains: (shorter, longer) chained solves per timing
# and slope estimates per budget (the full run: roofline.REPS, N_EST)
ROOF_REPS, ROOF_N_EST = (1, 3), 3


def phase_compare_chains():
    """K5 and K6 against their plain versions on measure_peaks' inputs at
    every CHAIN_STEPS trip count: bit-identical, since both take the same
    operations in the same order without FMA contraction. Returns {name:
    max abs error}."""
    before = _launches("k5"), _launches("k6")
    out = {}
    for name, (fused, ref, inp, _) in CHAINS.items():
        x = measure_peaks.slabs(*inp)
        out[name] = 0.0
        for n in CHAIN_STEPS:
            k, p = fused(x, n), ref(x, n)
            err = float((k - p).abs().max())
            print(f"{name} {n} steps: bit-identical {torch.equal(k, p)}, max abs error "
                  f"{err:.3g}, mean {float(k.double().mean()):.9g}", flush=True)
            assert torch.isfinite(k).all() and torch.equal(k, p), (name, n)
            out[name] = max(out[name], err)
    n = len(CHAIN_STEPS)
    assert (_launches("k5"), _launches("k6")) == (before[0] + n, before[1] + n)
    _set_launches(k5=before[0], k6=before[1])  # comparison launches
    return out


def phase_roofline():
    """The roofline path on the sphere2500 stand-in with every counter
    zeroed just before and read just after. Gates: both calibrations valid
    and agreeing within (0.5, 2); the K1 and K4 forced sweeps ran 3·K tCG
    iterations in every solve and their slopes are valid; K1, K4, K5 and K6
    launched, K2 and K3 not. Returns (counts, K5 calibration, K6
    calibration, row)."""
    _zero_counts()
    cal, cal2 = measure_peaks.measure_attainable(), measure_peaks.measure_cml()
    ratio, agree = measure_peaks.agreement(cal, cal2)
    row = roofline.problem_row("sphere2500", cal["fp32_attainable_flops"],
                               ROOF_REPS, ROOF_N_EST, device=DEV)
    counts = _counts()
    for name, c in (("K5", cal), ("K6", cal2)):
        print(f"roofline calibration {name}: valid {c['valid']}, "
              f"{(c['fp32_attainable_flops'] or 0) / 1e12:.4f} TFLOP/s, slopes "
              f"{c['slope_us_per_iter']} us per step, times {c['times_ms']} ms")
    print(f"roofline: witness agreement {ratio}; launches {counts}")
    for k in ("k1", "k4"):
        print(f"roofline sphere2500 {k}: " + json.dumps(row[k]), flush=True)
    assert cal["valid"] and cal2["valid"] and agree, (cal, cal2)
    for k in ("k1", "k4"):
        assert row[k]["tcg_exact"] and row[k]["slope_valid"], (k, row[k])
    assert all(counts[k] > 0 for k in ("k1", "k4", "k5", "k6")), counts
    _only(counts, **{k: counts[k] for k in ("k1", "k4", "k5", "k6")})
    return counts, cal, cal2, row


def phase_timing_chains():
    """ms per launch of K5 and K6 and of their plain versions at
    CHAIN_TIMING_STEPS steps on the same inputs; returns {name: (kernel ms,
    plain ms, bound (ms, by), fp32 flop/s of the kernel, the unfused bound
    ms)}. The chains' arithmetic is a fixed sequence of separately rounded
    multiplies, adds and subtracts (no FMA), one flop per instruction, so
    the least time the card can take for them is their flops over half the
    FMA peak; ``bound`` stays at the published fp32 peak."""
    before = _launches("k5"), _launches("k6")
    n, out = CHAIN_TIMING_STEPS, {}
    for name, (fused, ref, inp, per_elem) in CHAINS.items():
        x = measure_peaks.slabs(*inp)
        k_ms = _time(lambda: fused(x, n), 10)
        p_ms = _time(lambda: ref(x, n), 1)
        k2_ms = _time(lambda: fused(x, n), 10)
        km = min(k_ms, k2_ms)
        elems = peak_chains.ROWS * peak_chains.LANES
        flops = per_elem * peak_chains.NCHAIN * elems * n
        nbytes = 4 * (peak_chains.NCHAIN + 1) * elems  # slabs read, sum written
        bnd = bound(nbytes, flops)
        unfused_ms = flops / (FP32_FLOPS_PER_S / 2) * 1e3
        out[name] = (km, p_ms, bnd, flops / (km * 1e-3), unfused_ms)
        print(f"timing {name} at {n} steps: kernel {k_ms:.4f} ms, {k2_ms:.4f} ms (second "
              f"pass), {flops / (km * 1e-3) / 1e12:.4f} TFLOP/s; plain {p_ms:.3f} ms; "
              f"bound {bnd[0] * 1e3:.4f} us by {bnd[1]} ({nbytes} B, {flops:.4g} flop); "
              f"unfused bound {unfused_ms * 1e3:.4f} us ({100 * unfused_ms / km:.1f} %)")
    _set_launches(k5=before[0], k6=before[1])  # timing launches
    return out


# ---------------------------------------------------------------- acceleration

# dpgo_demo with --acceleration true through the JAX CLI on a CPU host (fp32,
# XLA), per form (updates, final cost); PERF.md has the summaries:
#   python -m dpgo_ros_tpu.cli --demo dpgo_demo --synthetic sphere \
#       --synthetic_n 2500 --acceleration true --platform cpu \
#       [--mode fused | --update_rule Parallel]
JAX_ACCEL_DEMO = {"engine": (57, 12436.7255859375), "fused": (57, 12437.333984375),
                  "parallel": (23, 12434.6494140625)}
# the card's update counts may differ from JAX's by this many (fp32 sum orders
# at the rel-change tolerance or the safeguard's threshold; PERF.md, PR 8)
ACCEL_UPDATES_SLACK = 2
TOL_ACCEL_COST = 1e-4
# the fixed-iteration comparison: accelerated steps, and a periodic restart
# every ACCEL_RESTART_INTERVAL of them
ACCEL_STEPS, ACCEL_RESTART_INTERVAL = 30, 10


def phase_accel_main_path(tmp: str):
    """dpgo_demo with ``--acceleration true`` in engine mode, fused mode and
    under the Parallel rule, each with the counters zeroed just before: K4
    (K1 for Parallel) launched once per update and once more per restart,
    K7 once per update (a restart adds none), no other kernel (the fused
    runner leaves K2, as JAX's does), cost
    decrease, the final cost within TOL_ACCEL_COST of the JAX CLI's and the
    update count within ACCEL_UPDATES_SLACK of its. Returns {form:
    (launches, updates, restarts, solve seconds, K7 launches)}."""
    forms = {"engine": [], "fused": ["--mode", "fused"],
             "parallel": ["--update_rule", "Parallel"]}
    out = {}
    for form, flags in forms.items():
        prefix = os.path.join(tmp, f"accel-{form}")
        summary, extras, counts = _counted_run(
            DPGO_DEMO + ["--acceleration", "true", "--output", prefix] + flags)
        updates, restarts = extras["block_updates"], extras["restarts"]
        jax_updates, jax_cost = JAX_ACCEL_DEMO[form]
        kernel = "k1" if form == "parallel" else "k4"
        solve = extras["timing_sec"]["solve"]
        print(f"accelerated main path {form}: " + json.dumps(summary), flush=True)
        print(f"accelerated main path {form}: launches {counts}, updates {updates}, "
              f"restarts {restarts} ({100 * restarts / max(updates, 1):.1f} % of steps), "
              f"initial cost {extras['initial_cost']:.7g}, solve {solve:.4f} s; JAX CLI "
              f"{jax_updates} updates, {jax_cost}", flush=True)
        _only(counts, **{kernel: updates + restarts, "k7": updates})
        assert summary["final_cost"] < extras["initial_cost"]
        assert abs(summary["final_cost"] - jax_cost) <= TOL_ACCEL_COST * jax_cost, form
        assert abs(updates - jax_updates) <= ACCEL_UPDATES_SLACK, (form, updates)
        assert math.isfinite(summary["ate_vs_ground_truth"])
        assert os.path.getsize(prefix + "_global.g2o") > 0
        out[form] = (counts[kernel], updates, restarts, solve, counts["k7"])
    return out


def phase_accel_fixed_iterations() -> None:
    """ACCEL_STEPS accelerated RoundRobin steps (tol 0, a periodic restart
    every ACCEL_RESTART_INTERVAL) from one chordal state: card fp32 (K4 on
    V's robot windows) vs CPU fp64 plain path, cost histories within
    TOL_HIST; one K4 launch per step and restart. (K1 on V's colour
    windows is held by the accelerated Parallel main path's cost and
    update count against the JAX CLI's.)"""
    data, _, _ = generate_world("sphere", n=2500, num_robots=5, seed=42)
    base = dict(num_robots=5, update_rule=UpdateRule.ROUND_ROBIN, acceleration=True,
                restart_interval=ACCEL_RESTART_INTERVAL,
                local_initialization_method=InitMethod.CHORDAL,
                relative_change_tolerance=0.0, max_iteration_number=ACCEL_STEPS,
                RTR_gradnorm_tol=0.5)
    p64 = LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu")
    e64 = RBCDEngine(p64, AgentConfig(dtype="float64", **base))
    s64 = e64.initialize()
    p32 = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device=DEV)
    e32 = RBCDEngine(p32, AgentConfig(dtype="float32", **base))
    s32 = state_from_numpy(state_to_numpy(s64), dtype=torch.float32, device=DEV)
    _, i64 = e64.run(s64)
    before = _launches("k4")
    _, i32 = e32.run(s32)
    launched = _launches("k4") - before
    _set_launches(k4=before)  # not the main path
    h64, h32 = np.array(i64["history"]["cost"]), np.array(i32["history"]["cost"])
    rel = float(np.max(np.abs(h32 - h64) / np.abs(h64)))
    print(f"accelerated fixed {ACCEL_STEPS} iterations: cost {h64[0]:.7g} -> "
          f"{h64[-1]:.7g} (CPU fp64), {h32[-1]:.7g} (card fp32), max rel history "
          f"deviation {rel:.2e}; safeguard restarts {i32['restarts']} (card) / "
          f"{i64['restarts']} (CPU), periodic restarts at every "
          f"{ACCEL_RESTART_INTERVAL}th step; K4 launches {launched}", flush=True)
    assert len(h64) == len(h32) == ACCEL_STEPS and rel <= TOL_HIST
    assert launched == ACCEL_STEPS + i32["restarts"], launched


# ---------------------------------------------------------------- K7

# K7 against its plain version on the same CUDA tensors: X_acc, a select,
# bit-equal; V_new within TOL_K7 abs (the same fp32 sums in another order,
# with FMA; tests/test_torch_nesterov_extrapolate.py)
TOL_K7 = 1e-5
K7_UPDATES = 12  # accelerated dpgo_demo updates whose operands K7 is held on
K7_REPS = 500


def k7_flops(r: int, d: int) -> int:
    """fp32 operations K7 takes for one pose inside the mask (a
    multiply-add counted as 2): W = m·(X_acc − X_prev), YᵀW_Y, its sym,
    W_Y − Y·sym, A and ‖A‖², the scaling, 20 Newton–Schulz steps (ZᵀZ,
    3I − ZᵀZ, the product, the ½), p + β·W_p."""
    proj = 2 * r * (d + 1) + 2 * r * d * d + 2 * d * d + 2 * r * d * d + r * d
    start = 4 * r * d + r * d + 2 * r
    ns = nesterov.NS_STEPS * (4 * r * d * d + d * d + r * d)
    return proj + start + ns


def _k7_calls(**config):
    """The operands (Z, X, X_prev, V, mask, β) of each K7 call over
    K7_UPDATES accelerated updates of the dpgo_demo engine on the card
    (tolerance 0; ``config`` e.g. the θ-sequence), cloned, and the run's
    restarts: K7 launched once per update, restarts adding none; the run's
    launches are then taken off the counters."""
    eng, st0 = _demo_engine(DPGO_DEMO, acceleration=True, relative_change_tolerance=0.0,
                            **config)
    calls, real = [], nesterov.extrapolate

    def spy(*ops):
        calls.append(tuple(t.clone() for t in ops))
        return real(*ops)

    before = _launches("k4"), _launches("k7")
    with mock.patch.object(nesterov, "extrapolate", spy):
        _, info = eng.run(st0, max_iters=K7_UPDATES)
    assert len(calls) == info["iterations"] == K7_UPDATES, (len(calls), info["iterations"])
    assert _launches("k7") - before[1] == K7_UPDATES
    _set_launches(k4=before[0], k7=before[1])
    return calls, info["restarts"]


def phase_compare_extrapolate():
    """K7 against its plain version on the same CUDA tensors, the operands
    of the accelerated dpgo_demo engine's first K7_UPDATES updates, with
    the fixed β (0.3) and with the θ-sequence: X_acc bit-equal, V_new
    within TOL_K7, V's poses outside the mask untouched, a second launch
    bit-identical. Returns (V_new's max abs error, the operands' shape)."""
    before = _launches("k7")
    err = 0.0
    for name, config in (("beta 0.3", {}), ("theta-sequence", dict(acceleration_beta=None))):
        calls, restarts = _k7_calls(**config)
        errs = []
        for ops in calls:
            (xa, vn), (xa2, vn2) = nesterov.extrapolate(*ops), nesterov.extrapolate(*ops)
            xr, vr = nesterov.extrapolate_ref(*ops)
            inside = ops[4] > 0
            assert torch.equal(xa, xr) and torch.equal(xa2, xa) and torch.equal(vn2, vn)
            assert torch.equal(vn[~inside], ops[3][~inside])
            errs.append(float((vn - vr).abs().max()))
        print(f"K7 vs plain, {name}: {len(calls)} updates ({restarts} restarts), "
              f"block {int((calls[0][4] > 0).sum())} of {calls[0][1].shape[0]} poses, "
              f"X_acc bit-equal; V_new max abs error {max(errs):.3g} "
              f"(per update {[f'{e:.2g}' for e in errs]}), beta "
              f"{[round(float(c[5]), 6) for c in calls[:4]]}...", flush=True)
        assert all(math.isfinite(e) and e <= TOL_K7 for e in errs), (name, errs)
        err = max(err, max(errs))
    _set_launches(k7=before)  # comparison launches
    return err, list(calls[0][1].shape)


def phase_timing_extrapolate():
    """K7 on the last of the accelerated dpgo_demo operands: its device ms
    per launch (torch.profiler), ms per wrapper call (CUDA events over
    K7_REPS calls) and the host µs of a call (enqueue only), beside its
    plain version's ms and host µs per call on the same CUDA tensors, and
    the bound. Returns (kernel device ms, plain ms, bound (ms, by), ms per
    call, host µs per call, the plain version's host µs per call)."""
    calls, _ = _k7_calls()
    ops = calls[-1]
    before = _launches("k7")
    kernel = lambda: nesterov.extrapolate(*ops)
    plain = lambda: nesterov.extrapolate_ref(*ops)

    def host_us(fn, reps):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        dt = time.perf_counter() - t
        torch.cuda.synchronize()
        return dt / reps * 1e6

    k_ms = _time(kernel, K7_REPS)
    p_ms = _time(plain, 50)
    k2_ms = _time(kernel, K7_REPS)
    dev_ms = _kernel_ms(kernel, "nesterov_extrapolate_kernel", K7_REPS)
    k_host, p_host = host_us(kernel, K7_REPS), host_us(plain, 50)
    n, r, dp1 = ops[1].shape
    nb = int((ops[4] > 0).sum())
    nbytes = 4 * (6 * n * r * dp1 + n + 1)  # Z, X, X_prev, V read, X_acc, V_new written; mask, β
    flops = nb * k7_flops(r, dp1 - 1)
    bnd = bound(nbytes, flops)
    print(f"timing K7 at n {n}, r {r}, d {dp1 - 1}, block {nb}: device {dev_ms * 1e3:.3f} us "
          f"per launch; {k_ms * 1e3:.3f}, {k2_ms * 1e3:.3f} us per wrapper call (CUDA "
          f"events), host {k_host:.2f} us per call; plain {p_ms * 1e3:.3f} us per call, "
          f"host {p_host:.2f} us; bound {bnd[0] * 1e3:.4f} us by {bnd[1]} ({nbytes} B, "
          f"{flops:.4g} flop; all {n} poses {n * k7_flops(r, dp1 - 1):.4g} flop)", flush=True)
    _set_launches(k7=before)  # timing launches
    return dev_ms, p_ms, bnd, min(k_ms, k2_ms), k_host, p_host


# ---------------------------------------------------------------- certificate

# the JAX package's fp64 staircase on a CPU host, on generate_world("grid3d",
# grid_shape=(10, 10, 10), num_robots=5, seed=2) (1,000 poses):
# certified_solve(data) -> certified at rank 5 (ranks tried (5,))
JAX_GRID_RANK, JAX_GRID_COST = 5, 5518.300320983406
TOL_STAIRCASE_COST = 1e-8
# the JAX CLI's fp32 certificate tolerances (dpgo_ros_tpu/cli.py, --certify)
FP32_CERT = dict(eig_tol=1e-3, crit_tol=3e-2, lanczos_tol=1e-4)
# card vs CPU certify of one fp32 X: crit residual within rel TOL_CERT_CRIT,
# min eig within TOL_CERT_EIG · scale (the fp32 Lanczos tolerance)
TOL_CERT_CRIT, TOL_CERT_EIG = 1e-3, 1e-4
# the tighter accelerated run whose X passes fp32 criticality
CERT_RUN = dict(relative_change_tolerance=0.02, RTR_gradnorm_tol=0.05)


def phase_certify():
    """``--certify`` on the accelerated dpgo_demo run on the card (the
    summary's certificate fields); one fp32 X (an accelerated run to
    CERT_RUN's tolerances) certified on the card and on the CPU (the same
    verdict, crit residual and min eig within tolerance), with the time of
    Λ on the device, of S's assembly and of ARPACK; the fp64 staircase on
    the card on the 1,000-pose grid (certified at JAX's rank and cost).
    Returns a dict of the readings."""
    summary, _, _ = _counted_run(DPGO_DEMO + ["--acceleration", "true", "--certify"])
    c = summary["certificate"]
    print("certify main path: " + json.dumps(c), flush=True)
    assert set(c) == {"certified_global", "min_eig", "crit_residual", "scale"}, c
    assert math.isfinite(c["crit_residual"]) and c["scale"] > 0

    data, _, _ = generate_world("sphere", n=2500, num_robots=5, seed=42)
    prob = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device=DEV)
    eng = RBCDEngine(prob, AgentConfig(
        num_robots=5, update_rule=UpdateRule.ROUND_ROBIN, acceleration=True,
        local_initialization_method=InitMethod.CHORDAL, max_iteration_number=1000,
        dtype="float32", **CERT_RUN))
    before = _launches("k4")
    st, info = eng.run()
    _set_launches(k4=before)  # not the main path
    X, e = st.X, prob.edges
    lam_ms = _time(lambda: certificate.lambda_blocks(X, e), 5)
    Lam = certificate.lambda_blocks(X, e)
    t = time.time()
    certificate.s_sparse(X, Lam, e)
    s_sec = time.time() - t
    t = time.time()
    certificate.min_eig_lanczos(X, Lam, e, tol=FP32_CERT["lanczos_tol"])
    arpack_sec = time.time() - t - s_sec
    t = time.time()
    card = certificate.certify(X, e, **FP32_CERT)
    card_sec = time.time() - t
    cpu_prob = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device="cpu")
    t = time.time()
    host = certificate.certify(X.cpu(), cpu_prob.edges, **FP32_CERT)
    host_sec = time.time() - t
    crel = abs(card.crit_residual - host.crit_residual) / host.crit_residual
    eabs = abs(card.min_eig - host.min_eig)
    print(f"certify fp32 X ({info['iterations']} accelerated updates to {CERT_RUN}, cost "
          f"{info['final_cost']:.7g}): card {card.is_global} min eig {card.min_eig:.6g} crit "
          f"{card.crit_residual:.6g} in {card_sec:.3f} s; CPU {host.is_global} min eig "
          f"{host.min_eig:.6g} crit {host.crit_residual:.6g} in {host_sec:.3f} s; crit rel "
          f"{crel:.2e}, min eig diff {eabs:.4g} (scale {card.scale:.6g}); Lambda on the card "
          f"{lam_ms:.4f} ms, S assembly {s_sec:.3f} s, ARPACK {arpack_sec:.3f} s", flush=True)
    assert card.is_global == host.is_global and card.eigvec is not None
    assert crel <= TOL_CERT_CRIT and eabs <= TOL_CERT_EIG * card.scale

    grid, _, _ = generate_world("grid3d", grid_shape=(10, 10, 10), num_robots=5, seed=2)
    t = time.time()
    res = certified.certified_solve(grid, device=DEV)
    grid_sec = time.time() - t
    print(f"certified_solve fp64 on the card (grid3d, 1,000 poses): certified "
          f"{res.certified} rank {res.rank} (ranks {res.ranks_tried}) cost {res.cost!r} "
          f"(JAX {JAX_GRID_COST!r}, rel {abs(res.cost - JAX_GRID_COST) / JAX_GRID_COST:.2e}) "
          f"min eig {res.min_eig:.4g} in {grid_sec:.2f} s", flush=True)
    assert res.certified and res.rank == JAX_GRID_RANK
    assert abs(res.cost - JAX_GRID_COST) <= TOL_STAIRCASE_COST * JAX_GRID_COST
    return {"lambda_ms": lam_ms, "s_assembly_sec": s_sec, "arpack_sec": arpack_sec,
            "certify_sec": card_sec, "grid_certified_solve_sec": grid_sec}


# the JAX package's fp64 staircase on a CPU host on the dpgo_demo world
# (generate_world("sphere", n=2500, num_robots=5, seed=42)): certified at
# rank 5 (ranks tried (5,))
JAX_DEMO_FSTAR = 12428.175793305161


def phase_fstar():
    """The certified f* of the dpgo_demo world: the fp64 staircase on the
    card, certified at JAX's cost (rel TOL_STAIRCASE_COST). Not run by
    :func:`main` (~23 s, past its time budget): a probe calls it. Returns
    (f*, seconds)."""
    data, _, _ = generate_world("sphere", n=2500, num_robots=5, seed=42)
    t = time.time()
    star = certified.certified_solve(data, device=DEV)
    sec = time.time() - t
    print(f"certified f* of the dpgo_demo world (sphere, 2,500 poses, seed 42): "
          f"{star.cost!r}, certified {star.certified} at rank {star.rank} in "
          f"{sec:.2f} s (fp64 on the card; JAX {JAX_DEMO_FSTAR!r})", flush=True)
    assert star.certified
    assert abs(star.cost - JAX_DEMO_FSTAR) <= TOL_STAIRCASE_COST * JAX_DEMO_FSTAR
    return star.cost, sec


# ---------------------------------------------------------------- fleet

# the JAX CLI's fleets on the synthetic sphere, fp32 on a CPU host:
#   python -m dpgo_ros_tpu.cli --demo DEMO --mode fleet --synthetic sphere \
#       --synthetic_n 2500 [--synthetic_outlier_ratio 0.1] --platform cpu --output P
# ticks, iterations per robot, messages sent, the exported trajectory's cost
# (exported_cost of P) and its accepted / rejected loop closures; the GNC
# fleet's recall is that of DistributedController.global_weights (= the
# exported weights), 245 of 245 planted outliers rejected
JAX_FLEETS = {
    "dpgo_demo": dict(ticks=77, iterations=[14, 13, 13, 13, 13], messages=580,
                      cost=12448.788411034297, accepted=2454, rejected=0),
    "dpgo_gnc_demo": dict(ticks=1434, iterations=[178] * 5 + [177] * 3, messages=16901,
                          cost=10257.490106323829, accepted=2051, rejected=406),
    "asapp_demo": dict(ticks=17, iterations=[11, 10, 9, 8, 7], messages=145,
                       cost=16072.299231985015, accepted=2454, rejected=0),
}
JAX_FLEET_GNC_RECALL = 1.0
FLEET_N = 2500
# the card's fleets against the JAX CLI's: ticks, each robot's iterations
# and the messages within FLEET_SLACK, the exported trajectory's cost
# within rel TOL_FLEET_COST (PERF.md, PR 9). The GNC fleet's final accept /
# reject split moves with fp32 sum orders and YLift where a loop closure's
# residual sits at the threshold: the card (and the port on the CPU) keep 5
# inliers JAX rejects, the cost (weighted by the split) moves by rel
# 1.9e-3 (CPU 2.8e-3), and the last weight round's inner phase takes one
# more sweep (8 ticks, 1 iteration per robot, 96 messages). So its counts
# may differ by two sweeps, and its cost is held to TOL_FLEET_COST only
# where the split equals JAX's, else to TOL_GNC_FLEET_COST with the split
# within GNC_FLEET_FLIPS closures. The other fleets equal JAX's counts
FLEET_SLACK = {"dpgo_demo": (0, 0, 0), "dpgo_gnc_demo": (16, 2, 200),
               "asapp_demo": (0, 0, 0)}  # (ticks, iterations per robot, messages)
TOL_FLEET_COST, TOL_GNC_FLEET_COST, GNC_FLEET_FLIPS = 1e-4, 1e-2, 10


def fleet_argv(demo: str, prefix=None, n: int = FLEET_N):
    """The CLI's command line of a fleet (its ``--output`` if ``prefix``)."""
    gnc = ["--synthetic_outlier_ratio", "0.1"] if demo == "dpgo_gnc_demo" else []
    out = ["--output", prefix] if prefix else []
    return ["--demo", demo, "--mode", "fleet", "--synthetic", "sphere", "--synthetic_n",
            str(n), "--device", DEV.type] + gnc + out


def fleet_world(demo: str, n: int = FLEET_N):
    """(data, ground truth, planted outliers) of a fleet's synthetic world."""
    robots = 8 if demo == "dpgo_gnc_demo" else 5
    ratio = 0.1 if demo == "dpgo_gnc_demo" else 0.0
    return generate_world("sphere", n=n, num_robots=robots, seed=42, outlier_ratio=ratio)


def exported_cost(prefix: str, data) -> tuple:
    """(cost, weights): Σ w r² of the exported trajectory (its per-robot TUM
    files) over the world's measurements, w the exported weights
    (``_loops.json``; odometry 1). The same function of the JAX CLI's
    ``--output`` gave JAX_FLEETS' costs."""
    parts = []
    for k in range(data.num_robots):
        rows = np.loadtxt(f"{prefix}_robot{k}.tum", ndmin=2)
        R = np.stack([_quat_to_rot(*q) for q in rows[:, 4:8]])
        parts.append(np.concatenate([R, rows[:, 1:4, None]], -1))
    T = np.concatenate(parts)
    m = data.measurements
    w = np.ones(len(m))
    w[m.edge_type != EdgeType.ODOMETRY] = [
        e["weight"] for e in json.load(open(prefix + "_loops.json"))["edges"]]
    off = np.concatenate([[0], np.cumsum(data.num_poses)[:-1]])
    r = hostmath.measurement_residuals_np(
        T, off[m.src_robot] + m.src_frame, off[m.dst_robot] + m.dst_frame,
        m.R, m.t, m.kappa, m.tau)
    return float(np.sum(w * r * r)), w


def phase_fleet_main_path(tmp: str) -> dict:
    """The three fleets through the CLI on the card, each with the counters
    zeroed just before: K4 launched once per synchronous iteration (the
    ASAPP fleet's RGD agents launch nothing), the JAX CLI's ticks,
    iterations and messages within FLEET_SLACK, the exported
    trajectory's cost as TOL_FLEET_COST says, a finite ATE; the GNC fleet
    every loop closure decided and recall ≥ JAX's − 0.02. Returns {demo:
    readings}."""
    out = {}
    for demo, jax in JAX_FLEETS.items():
        prefix = os.path.join(tmp, f"fleet-{demo}")
        summary, extras, counts = _counted_run(fleet_argv(demo, prefix))
        iters = [summary["iterations"][k] for k in sorted(summary["iterations"])]
        t = extras["timing_sec"]
        data, _, planted = fleet_world(demo)
        cost, w = exported_cost(prefix, data)
        gs = summary["gnc_stats"]
        flips = abs(gs["accepted"] - jax["accepted"])
        crel = abs(cost - jax["cost"]) / jax["cost"]
        print(f"fleet {demo}: " + json.dumps(summary), flush=True)
        print(f"fleet {demo}: launches {counts}; JAX CLI ticks {jax['ticks']} iterations "
              f"{jax['iterations']} messages {jax['messages']}; exported cost {cost!r} "
              f"(JAX {jax['cost']!r}, rel {crel:.2e}), accepted {gs['accepted']} "
              f"(JAX {jax['accepted']}); ATE {extras['ate_vs_ground_truth']:.6g}; "
              f"init {t['init']:.3f} s, solve {t['solve']:.3f} s = "
              f"{1e3 * t['solve'] / t['ticks']:.3f} ms per tick", flush=True)
        _only(counts, k4=0 if demo == "asapp_demo" else sum(iters))
        assert all(extras["terminated"]), extras["terminated"]
        ticks, its, msgs = FLEET_SLACK[demo]
        assert abs(summary["ticks"] - jax["ticks"]) <= ticks, demo
        assert len(iters) == len(jax["iterations"]) and max(
            abs(a - b) for a, b in zip(iters, jax["iterations"])) <= its, demo
        assert abs(summary["messages_sent"] - jax["messages"]) <= msgs, demo
        if flips == 0:
            assert crel <= TOL_FLEET_COST, (demo, cost)
        else:
            assert demo == "dpgo_gnc_demo" and flips <= GNC_FLEET_FLIPS, (demo, gs)
            assert crel <= TOL_GNC_FLEET_COST, (demo, cost)
        assert math.isfinite(extras["ate_vs_ground_truth"])
        if demo == "dpgo_gnc_demo":
            og = extras["outlier_ground_truth"]
            assert gs["convergence_ratio"] == 1.0 and og["planted"] == GNC_PLANTED, gs
            assert og["rejected_true"] / og["planted"] >= JAX_FLEET_GNC_RECALL - 0.02, og
        out[demo] = dict(k4=counts["k4"], ticks=summary["ticks"], iterations=iters,
                         messages=summary["messages_sent"], cost=cost, cost_rel=crel,
                         accepted=gs["accepted"], wall=summary["wall_time_sec"],
                         init=t["init"], solve=t["solve"],
                         ms_per_tick=1e3 * t["solve"] / t["ticks"])
    return out


def _mid_round_fleet(demo="dpgo_demo", robot: int = 2, rounds: int = 0, **config):
    """A fleet of ``demo`` on the card (its config updated with ``config``)
    ticked until ``robot`` has had ``rounds`` GNC weight rounds and solved
    twice since the last of them (mid-round), and that robot's agent."""
    parser = cli.build_parser()
    a = parser.parse_args(fleet_argv(demo))
    cli.apply_demo(a, parser)
    data, _, _ = cli.load_data(a)
    cfg = dataclasses.replace(cli.args_to_config(a), num_robots=data.num_robots, **config)
    ctl = DistributedController(data, cfg, device=DEV)
    agent = ctl.agents[robot]
    while agent.weight_update_count < rounds:
        ctl.run(max_ticks=1)
    solved = agent.solved_iterations
    while agent.solved_iterations < solved + 2:
        ctl.run(max_ticks=1)
    return ctl, agent


# the agents whose windows phase_fleet_window holds K4 to: (demo, robot,
# weight rounds before, config changes). The GNC agent's window (312 block
# poses, 100 separator slots, a 2-CTA cluster) comes after its first weight
# round, so its loop closures carry fractional TLS weights and zeros; the
# demo freezes no edge (its threshold is off, as the reference launch
# file's), so that fleet turns freezing on to put frozen edges in the window
FLEET_WINDOWS = (("dpgo_demo", 2, 0, {}),
                 ("dpgo_gnc_demo", 3, 1, dict(weight_convergence_threshold=0.05)))


def phase_fleet_window() -> float:
    """K4 against its plain version on the local windows of FLEET_WINDOWS'
    agents mid-round, every third separator slot made unknown so that its
    edges are masked: once with the slots' last poses, once with the
    identity placeholders of unknown slots. Gates: the same TR and tCG
    counts, f0 and gn0 within rel TOL_F0, f − f0 within rel TOL_K4_DF, X
    within TOL_K4_X of max |X|, the separators bit-identical to the input,
    a repeated launch bit-identical; the GNC window holds fractional, zero
    and frozen loop-closure weights among its unmasked edges. Returns the
    max abs X error."""
    before = _launches("k4")
    worst = 0.0
    for demo, robot, rounds, config in FLEET_WINDOWS:
        _, a = _mid_round_fleet(demo, robot, rounds, **config)
        a._slot_known[::3] = False
        a._edge_mask_cache = None
        emask = a._edge_mask()
        e, P = a._local_problem(a.weights, emask)
        w, own = a.windows, a._own_mask[:, 0, 0] > 0
        X = torch.as_tensor(a.X, device=DEV)
        holes = a.n_local + np.flatnonzero(~a._slot_known)
        Xh = X.clone()
        Xh[holes] = 0.0
        Xh[holes, :3, :3] = torch.eye(3, device=DEV)
        live = (emask > 0) & (a.host_edges.is_loop > 0)
        frac = int((live & (a.weights > 0) & (a.weights < 1)).sum())
        zero = int((live & (a.weights == 0)).sum())
        frozen = int((live & a._fixed_np).sum())
        print(f"fleet window ({demo} robot {robot}, iteration {a.iteration}, weight round "
              f"{a.weight_update_count}): {a.n_local} block poses, {X.shape[0] - a.n_local} "
              f"separators ({holes.size} unknown), {e.num_edges} edges "
              f"({int(emask.size - emask.sum())} masked; unmasked loop closures: {frac} "
              f"fractional, {zero} zero, {frozen} frozen weights); "
              + json.dumps(launch_shape(w, 3, X.shape[1])), flush=True)
        if rounds:
            assert frac > 0 and zero > 0 and frozen > 0, (demo, frac, zero, frozen)
        launched = _launches("k4")
        for name, X0 in (("masked", X), ("placeholders", Xh)):
            Xk, sk = hbm_rtr.rtr_solve_hbm(X0, 0, P, e, DEMO_PARAMS, w)
            Xk2, sk2 = hbm_rtr.rtr_solve_hbm(X0, 0, P, e, DEMO_PARAMS, w)
            Xp, sp = hbm_rtr.rtr_solve_hbm_ref(X0, 0, P, e, DEMO_PARAMS, w)
            same = torch.equal(Xk, Xk2) and torch.equal(sk, sk2)
            sk, sp = sk.double().cpu().numpy(), sp.double().cpu().numpy()
            scale = float(Xp.abs().max())
            err = float((Xk - Xp).abs().max())
            worst = max(worst, err)
            f0r, gn0r = abs(sk[0] - sp[0]) / sp[0], abs(sk[2] - sp[2]) / sp[2]
            name = f"{demo} {name}"
            print(f"fleet window {name}: TR {int(sk[4])}/{int(sp[4])} tCG {int(sk[5])}/"
                  f"{int(sp[5])} (K4/plain) f0 {sk[0]:.7g} rel {f0r:.2e} gn0 {sk[2]:.5g} rel "
                  f"{gn0r:.2e} f-f0 {sk[1] - sk[0]:.7g} rel {_df_rel(sk, sp):.2e}; X rel "
                  f"{err / scale:.2e}; repeat bit-identical {same}", flush=True)
            assert np.isfinite(sk).all() and torch.isfinite(Xk).all(), name
            assert (int(sk[4]), int(sk[5])) == (int(sp[4]), int(sp[5])), name
            assert f0r <= TOL_F0 and gn0r <= TOL_F0 and _df_rel(sk, sp) <= TOL_K4_DF, name
            assert err <= TOL_K4_X * scale and torch.equal(Xk[~own], X0[~own]), name
            assert same, f"fleet window {name}: a second launch differs"
        assert _launches("k4") == launched + 4, demo
    _set_launches(k4=before)  # the fleets' and the comparison's launches
    return worst


FAULT_N = 1000


def phase_fleet_faults() -> None:
    """On 1,000-pose spheres (RoundRobin, Odometry init, tol 0.3, fp32 on
    the card), as the JAX package's fault tests do: 2 robots over a perfect
    transport and over ``LossyTransport(drop_prob=0.2, delay_ticks=1,
    seed=3)`` (timeout 10 ticks); 3 robots with robot 2 killed after its
    first solve (``enable_recovery``, timeout 8 ticks); and, on the 2-robot
    world, the accelerated fleet (restart every 3 iterations). The lossy
    and accelerated fleets terminate with finite trajectories whose costs
    are within 1.10 of the perfect one's; the survivors of the kill
    terminate, robot 2 leaves the active set, and robots 0 and 1 have
    trajectories. Each fleet launches K4 once per iteration, the
    accelerated one once more per restart. (With 3 robots this drop stream
    loses the round at the initialization barrier in both packages:
    PERF.md, PR 9.)"""
    worlds = {R: generate_world("sphere", n=FAULT_N, num_robots=R, seed=7)[0]
              for R in (2, 3)}
    cfg = AgentConfig(update_rule=UpdateRule.ROUND_ROBIN,
                      local_initialization_method=InitMethod.ODOMETRY,
                      relative_change_tolerance=0.3, max_iteration_number=100,
                      RTR_gradnorm_tol=0.5, dtype="float32")
    prob = LiftedProblem.from_data(worlds[2], r=3, dtype=torch.float64, device="cpu")

    def cost(ctl, res):
        T = torch.as_tensor(ctl.global_trajectory(res), dtype=torch.float64)
        return float(quadratic.cost(stiefel.lift_trajectory(
            T, torch.eye(3, dtype=torch.float64)), prob.edges))

    before = _launches("k4")
    runs = {}
    for name, R, tr, extra in (
            ("perfect", 2, None, {}),
            ("lossy", 2, LossyTransport(2, drop_prob=0.2, delay_ticks=1, seed=3),
             dict(timeout_threshold=10.0)),
            ("killed", 3, LossyTransport(3),
             dict(enable_recovery=True, timeout_threshold=8.0)),
            ("accelerated", 2, None, dict(acceleration=True, restart_interval=3))):
        ctl = DistributedController(
            worlds[R], dataclasses.replace(cfg, num_robots=R, **extra), transport=tr,
            device=DEV)
        if name == "killed":
            agent, run = ctl.agents[2], ctl.agents[2].runOnce

            def run_or_die(agent=agent, run=run, tr=tr):
                if 2 not in tr.dead and agent.solved_iterations >= 1:
                    tr.kill_robot(2)
                    return
                run()

            agent.runOnce = run_or_die
        k4 = _launches("k4")
        t = time.time()
        res = ctl.run(max_ticks=4000)
        sec = time.time() - t
        k4 = _launches("k4") - k4
        its = sum(res["iterations"].values())
        runs[name] = res
        live = [k for k, done in enumerate(res["terminated"]) if done]
        c = cost(ctl, res) if name != "killed" else float("nan")
        print(f"fleet faults {name}: ticks {res['ticks']}, iterations {res['iterations']}, "
              f"messages {res['messages_sent']}, K4 launches {k4}, terminated {live}, "
              f"active {res['active_robots']}, cost {c:.7g}, {sec:.2f} s", flush=True)
        assert k4 >= its if name == "accelerated" else k4 == its, (name, k4, its)
        if name == "killed":
            assert res["terminated"][0] and res["terminated"][1], res["terminated"]
            assert 2 not in res["active_robots"]
            assert all(res["trajectories"].get(k) is not None for k in (0, 1))
            assert all(np.isfinite(res["trajectories"][k]).all() for k in (0, 1))
        else:
            assert all(res["terminated"]) and math.isfinite(c), name
            runs[name + "_cost"] = c
    for name in ("lossy", "accelerated"):
        assert runs[name + "_cost"] <= 1.10 * runs["perfect_cost"], (name, runs)
    _set_launches(k4=before)  # not the main path


def phase_fleet_timing() -> dict:
    """Each fleet once more under torch.profiler (after the main-path runs,
    so warm): the card's busy time (the union of its kernel, memcpy and
    memset intervals), K4's device time and share of it (the trace holds
    each K4 launch of the run), the profiled wall. Returns {demo:
    readings}."""
    out = {}
    before = _launches("k4")
    with tempfile.TemporaryDirectory() as tmp:
        for demo in JAX_FLEETS:
            launched = _launches("k4")
            with roofline.padded_profile() as prof:
                t = time.time()
                summary, extras = cli.run(fleet_argv(demo, os.path.join(tmp, demo)))
                torch.cuda.synchronize()
                wall = time.time() - t
            path = os.path.join(tmp, f"{demo}.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
            dev = [e for e in events
                   if e.get("ph") == "X" and e.get("cat") in roofline.DEVICE_CATS]
            busy = roofline.session_busy_ms(events, _launches("k4") - launched)
            k4 = [e for e in dev if "rtr_window_kernel" in e.get("name", "")]
            k4_ms = sum(e["dur"] for e in k4) / 1e3
            kernels = sum(e.get("cat") == "kernel" for e in dev)
            assert len(k4) == _launches("k4") - launched, (demo, len(k4))
            out[demo] = dict(profiled_wall_s=wall, busy_ms=busy, k4_ms=k4_ms,
                             k4_launches=len(k4), k4_share_of_busy=k4_ms / max(busy, 1e-9),
                             kernel_launches=kernels, idle_share=1 - busy / (1e3 * wall),
                             ticks=summary["ticks"])
            print(f"fleet timing {demo}: profiled wall {wall:.3f} s, device busy "
                  f"{busy:.3f} ms (idle share {out[demo]['idle_share']:.4f}), K4 "
                  f"{k4_ms:.3f} ms in {len(k4)} launches ({100 * k4_ms / max(busy, 1e-9):.1f} % "
                  f"of busy), {kernels} kernel launches", flush=True)
    _set_launches(k4=before)  # timing launches
    return out


# ---------------------------------------------------------------- spmd

# the JAX CLI on the same world (run on a CPU host; --cpu_devices 1 and 5):
#   python -m dpgo_ros_tpu.cli --demo dpgo_demo --synthetic sphere \
#       --synthetic_n 2500 --mode spmd --platform cpu --cpu_devices M
# {slots: (launches = iterations, final cost)}
JAX_SPMD = {1: (20, 12428.17578125), 5: (20, 12501.2421875)}
SPMD_ITER_SLACK = 20  # one rel-change check window of launches
TOL_SPMD_COST = 1e-4
# the GNC demo in spmd mode at 8 slots (--cpu_devices 8): 1,000 launches,
# final cost 11242.2734375, 245 of 245 planted outliers rejected (one
# inlier too), convergence ratio 1.0
JAX_SPMD_GNC_RECALL = 1.0
JAX_SPMD_GNC_COST = 11242.2734375
# the card ended 2.3e-3 below JAX (one more inlier rejected: a discrete
# decision of the TLS rounds, PERF.md §6); about twice that reading
TOL_SPMD_GNC_COST = 5e-3
GNC_SLOT = 3  # the GNC slot whose window phase_spmd_compare checks
# JAX's own pin of an M = 1 stretch against per-step launches
# (tests/test_spmd.py::test_spmd_stretch_single_device_matches_per_step)
TOL_STRETCH_COST, TOL_STRETCH_X = 2e-3, 5e-3
SPMD_FSTAR = 12428.175793305161  # the dpgo_demo world's certified f*
STRETCH_RGD_STEPSIZE, STRETCH_MAX_LAUNCHES = 0.2, 400
MULTI_N, MULTI_STEPS = 2500, 24


def _spmd_world(slots: int, group: int = None):
    """The dpgo_demo world (sphere 2,500, seed 42, 5 robots; ``group``:
    regrouped into that many robots as the CLI does) as the spmd CLI sets
    it up: (data, prob, engine, initial state, ShardedProblem, config)."""
    from dpgo_ros_tpu_torch.parallel import spmd

    data, gt, _ = generate_world("sphere", n=2500, num_robots=5, seed=42)
    if group is not None:
        data = spmd.group_robots(data, group)
    cfg = AgentConfig(num_robots=data.num_robots, update_rule=UpdateRule.ROUND_ROBIN,
                      local_initialization_method=InitMethod.CHORDAL,
                      relative_change_tolerance=0.2, RTR_gradnorm_tol=0.5,
                      dtype="float32")
    prob = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device=DEV)
    eng = RBCDEngine(prob, cfg)
    st0 = eng.initialize()
    sp = spmd.ShardedProblem.build(prob, st0.X.cpu().numpy(), eng.robot_colors,
                                   num_devices=max(slots, data.num_robots))
    return data, gt, prob, eng, st0, sp, cfg


def _active_solves(colors, launches: int) -> int:
    """Σ over steps of the slots whose colour is the step's: the block
    solves a run of ``launches`` per-step launches makes."""
    colors = np.asarray(colors)
    k = int(colors.max()) + 1
    return int(sum((colors == it % k).sum() for it in range(launches)))


def _spmd_run(argv, slots: int):
    """cli.run of ``DPGO_DEMO``-style argv in spmd mode on ``slots`` local
    slots of this process (multihost.initialize), the counters zeroed just
    before; returns (summary, extras, counts, solve seconds)."""
    from dpgo_ros_tpu_torch.parallel import multihost

    if slots > 1:
        multihost.initialize("localhost:1", 1, 0, local_slot_count=slots,
                             device=DEV.type)
    try:
        summary, extras, counts = _counted_run(argv + ["--mode", "spmd"])
    finally:
        multihost.shutdown()
    return summary, extras, counts, extras["timing_sec"]["solve"]


def phase_spmd_main_path() -> dict:
    """The spmd main path through the CLI at M = 1 (the JAX CLI's one-device
    case) and at 5 local slots, and accelerated at 5: K1 launched once per
    active slot per step (+ restarts), no other kernel; the JAX CLI's
    launches (within one 20-launch check window) and final cost (rel 1e-4);
    a finite ATE. Returns {case: readings}."""
    colors5 = RBCDEngine(LiftedProblem.from_data(
        generate_world("sphere", n=2500, num_robots=5, seed=42)[0], r=5,
        dtype=torch.float32, device=DEV), AgentConfig(num_robots=5, dtype="float32")).robot_colors
    out = {}
    for name, slots, extra in (("m1", 1, []), ("m5", 5, []),
                               ("m5-accelerated", 5, ["--acceleration", "true"])):
        summary, extras, counts, sec = _spmd_run(DPGO_DEMO + extra, slots)
        launches = summary["launches"]
        want = (launches if slots == 1 else _active_solves(colors5, launches))
        print(f"spmd {name}: " + json.dumps(summary) + f"; launches {counts}, block "
              f"solves {extras['block_updates']} (active slot-steps {want}, restarts "
              f"{extras['restarts']}), exchange {extras['exchange_bytes']} B per step, "
              f"solve {sec:.3f} s, ATE {extras['ate_vs_ground_truth']:.6g}", flush=True)
        assert summary["devices"] == slots and summary["iterations"] == launches
        assert extras["block_updates"] == want + extras["restarts"], name
        _only(counts, k1=extras["block_updates"])
        assert math.isfinite(extras["ate_vs_ground_truth"])
        assert summary["final_cost"] < extras["initial_cost"]
        if not extra:
            jax_launches, jax_cost = JAX_SPMD[slots]
            assert abs(launches - jax_launches) <= SPMD_ITER_SLACK, (launches, jax_launches)
            assert abs(summary["final_cost"] - jax_cost) <= TOL_SPMD_COST * jax_cost, (
                summary["final_cost"], jax_cost)
        out[name] = dict(launches=launches, k1=counts["k1"], solve_s=sec,
                         final_cost=summary["final_cost"], restarts=extras["restarts"],
                         exchange_bytes=extras["exchange_bytes"],
                         ms_per_step=1e3 * sec / launches)
    return out


def phase_spmd_gnc() -> dict:
    """The GNC demo in spmd mode at 8 slots: recall ≥ JAX's − 0.02,
    convergence ratio 1.0, the final cost within rel TOL_SPMD_GNC_COST of
    the JAX CLI's, K1 once per active slot per step."""
    t = time.time()
    summary, extras, counts, sec = _spmd_run(GNC_DEMO, 8)
    og = extras["outlier_ground_truth"]
    colors8 = RBCDEngine(LiftedProblem.from_data(
        generate_world("sphere", n=2500, num_robots=8, seed=42, outlier_ratio=0.1)[0],
        r=5, dtype=torch.float32, device=DEV), AgentConfig(num_robots=8, dtype="float32")).robot_colors
    want = _active_solves(colors8, summary["launches"])
    print(f"spmd gnc (8 slots): " + json.dumps(summary) + f"; {json.dumps(og)}, "
          f"launches {counts}, active slot-steps {want}, weight rounds "
          f"{extras['weight_rounds']}, solve {sec:.3f} s, {time.time() - t:.1f} s",
          flush=True)
    _only(counts, k1=want)
    assert extras["block_updates"] == want
    assert og["planted"] == GNC_PLANTED
    assert og["rejected_true"] / og["planted"] >= JAX_SPMD_GNC_RECALL - 0.02, og
    assert summary["gnc_stats"]["convergence_ratio"] == 1.0, summary["gnc_stats"]
    cost_rel = abs(summary["final_cost"] - JAX_SPMD_GNC_COST) / JAX_SPMD_GNC_COST
    assert cost_rel <= TOL_SPMD_GNC_COST, (summary["final_cost"], JAX_SPMD_GNC_COST)
    return dict(launches=summary["launches"], k1=counts["k1"], solve_s=sec,
                recall=og["rejected_true"] / og["planted"],
                final_cost=summary["final_cost"])


def phase_spmd_stretch() -> dict:
    """Stretches: M = 1, S = 8 RTR through the CLI (one K2 launch per
    launch, no K1) and through the spmd API against 16 per-step launches
    (JAX's pin: cost rel 2e-3, X within 5e-3); M = 5, S = 16 RGD
    (stepsize 0.2) run until the cost is ≤ 1.02 × f*: the launches and
    seconds it takes, K2 once per slot per launch."""
    from dpgo_ros_tpu_torch.parallel import multihost, spmd

    summary, extras, counts, sec = _spmd_run(
        DPGO_DEMO + ["--spmd_steps_per_launch", "8"], 1)
    print(f"spmd stretch m1 (CLI): " + json.dumps(summary) + f"; launches {counts}, "
          f"solve {sec:.3f} s", flush=True)
    _only(counts, k2=summary["launches"])
    assert summary["iterations"] == 8 * summary["launches"]
    out = {"cli_m1": dict(launches=summary["launches"], k2=counts["k2"], solve_s=sec,
                          final_cost=summary["final_cost"])}

    data, _, prob, eng, st0, sp, cfg = _spmd_world(1, group=1)
    mesh = multihost.local_mesh(1, DEV)
    st_a, step_a = spmd.build_spmd_step(sp, cfg, mesh)
    st_b, step_b = spmd.build_spmd_step(
        sp, dataclasses.replace(cfg, spmd_steps_per_launch=8), mesh)
    _zero_counts()
    for it in range(16):
        st_a = step_a(it, 0, st_a)
    k1 = _launches("k1")
    for lt in range(2):
        st_b = step_b(lt, 0, st_b)
    counts = _counts()
    e = prob.edges
    Xa = torch.as_tensor(spmd.gather_trajectory(sp, st_a, prob.num_poses), device=DEV)
    Xb = torch.as_tensor(spmd.gather_trajectory(sp, st_b, prob.num_poses), device=DEV)
    fa, fb = float(quadratic.cost(Xa, e)), float(quadratic.cost(Xb, e))
    xerr = float(((Xb - Xa).abs() - TOL_STRETCH_X * Xa.abs()).max())
    print(f"spmd stretch m1: 16 per-step launches (K1 {k1}) cost {fa:.7g}, 2 S=8 "
          f"launches (K2 {counts['k2']}) cost {fb:.7g}, rel {abs(fb - fa) / fa:.2e}; "
          f"X max |Δ| − 5e-3·|X| {xerr:.2e}", flush=True)
    assert k1 == 16 and counts["k2"] == 2 and counts["k1"] == k1
    assert st_a.iteration == st_b.iteration == 16
    assert abs(fb - fa) <= TOL_STRETCH_COST * fa
    assert xerr <= TOL_STRETCH_X

    data, _, prob, eng, st0, sp, cfg = _spmd_world(5)
    st, step = spmd.build_spmd_step(sp, dataclasses.replace(
        cfg, spmd_steps_per_launch=16, spmd_stretch_rgd_stepsize=STRETCH_RGD_STEPSIZE),
        multihost.local_mesh(5, DEV))
    assert step.S == 16 and step.stretch_rgd == STRETCH_RGD_STEPSIZE
    e = prob.edges
    cost = lambda s: float(quadratic.cost(torch.as_tensor(
        spmd.gather_trajectory(sp, s, prob.num_poses), device=DEV), e))
    f0 = cost(st)
    _zero_counts()
    torch.cuda.synchronize()
    t, lt, f, solve = time.time(), 0, f0, 0.0
    while lt < STRETCH_MAX_LAUNCHES:
        t1 = time.time()
        st = step(lt, 0, st)
        torch.cuda.synchronize()
        solve += time.time() - t1
        lt += 1
        f = cost(st)
        if f <= 1.02 * SPMD_FSTAR:
            break
    wall = time.time() - t
    counts = _counts()
    print(f"spmd stretch m5 RGD S=16: cost {f0:.7g} -> {f:.7g} (≤ 1.02 f* = "
          f"{1.02 * SPMD_FSTAR:.7g}) in {lt} launches = {16 * lt} steps, {solve:.3f} s "
          f"in the steps ({wall:.3f} s with the cost checks); launches {counts}",
          flush=True)
    assert f <= 1.02 * SPMD_FSTAR, (f, lt)
    _only(counts, k2=5 * lt)
    out["m5_rgd"] = dict(launches=lt, steps=16 * lt, k2=counts["k2"], solve_s=solve,
                         wall_s=wall, final_cost=f)
    return out


def _slot_cases():
    """(name, Xg, slot, step, state) for the kernel checks on slot windows:
    the dpgo_demo world regrouped to 3 slots (500, 500 and 1,500 poses, so
    slots 0 and 1 carry 1,000 padded rows each) from a noisy state, with the
    full exchange's gathered state and the separator-only one (template
    poses outside the slot's block and separators); then a slot of the GNC
    demo on 8 slots after its first weight round (:func:`_gnc_slot_case`)."""
    from dpgo_ros_tpu_torch.parallel import multihost, spmd

    data, gt, prob, eng, st0, sp0, cfg = _spmd_world(3, group=3)
    X = noisy_state(prob, gt, seed=7).cpu().numpy()
    sp = spmd.ShardedProblem.build(prob, X, eng.robot_colors, num_devices=3)
    for sep_only in (False, True):
        st, step = spmd.build_spmd_step(
            sp, dataclasses.replace(cfg, spmd_separator_only=sep_only),
            multihost.local_mesh(3, DEV))
        views = step._exchange(st)
        for m in (0, 2):
            yield f"slot{m}/{'separators' if sep_only else 'full'}", views[m][0], m, step, st
    yield _gnc_slot_case()


def _gnc_slot_case():
    """The GNC demo's mesh program on 8 slots (blocks of 312–313 poses in
    slots of 316, separator-only exchange), stepped as the spmd CLI
    steps it through its first weight round: slot GNC_SLOT's edges then
    carry fractional and zero TLS weights (asserted)."""
    from dpgo_ros_tpu_torch.parallel import multihost, spmd

    parser = cli.build_parser()
    a = parser.parse_args(GNC_DEMO + ["--mode", "spmd"])
    cli.apply_demo(a, parser)
    data, _, _ = cli.load_data(a)
    cfg = dataclasses.replace(cli.args_to_config(a), num_robots=data.num_robots,
                              dtype="float32")
    prob = LiftedProblem.from_data(data, r=cfg.relaxation_rank, dtype=torch.float32,
                                   device=DEV)
    eng = RBCDEngine(prob, dataclasses.replace(cfg, use_fused_kernel=None))
    st0 = eng.initialize()
    sp = spmd.ShardedProblem.build(prob, st0.X.cpu().numpy(), eng.robot_colors,
                                   num_devices=8)
    st, step = spmd.build_spmd_step(sp, cfg, multihost.local_mesh(8, DEV))
    inner = cfg.robust_opt_inner_iters_per_robot * cfg.num_robots
    for it in range(inner + 1):  # the CLI's cadence: the first round at `inner`
        st = step(it, int(it == inner), st)
    m = GNC_SLOT
    w = st.weights[m].cpu().numpy()
    live = (sp.mask[m] > 0) & (sp.is_loop[m] > 0)
    frac, zero = int((live & (w > 0) & (w < 1)).sum()), int((live & (w == 0)).sum())
    print(f"spmd gnc slot {m} after weight round {st.wuc} (step {inner}): "
          f"{int(sp.pose_valid[m].sum())} poses of {sp.n_max}, {int(live.sum())} loop "
          f"closures: {frac} fractional, {zero} zero weights", flush=True)
    assert st.wuc == 1 and step.sep_only and frac > 0 and zero > 0, (st.wuc, frac, zero)
    return f"gnc slot{m}/round1", step._exchange(st)[m][0], m, step, st


def phase_spmd_compare() -> dict:
    """K1 and K2 against their plain versions on slot windows (a padded
    slot, the full and the separator-only exchange): the same TR and tCG
    counts (K2: steps, and tCG where no step revisits the block), X within
    TOL_X (K2: TOL_RUN_X), every pose outside the block bit-identical to
    the input, a repeated launch bit-identical. Returns {case: readings}."""
    out = {}
    before = (_launches("k1"), _launches("k2"))
    for name, Xg, m, step, st in _slot_cases():
        w = step._windows[m]
        own = step._own[m]
        e = dataclasses.replace(step._edges[m], weight=st.weights[m])
        Pinv = step._pinv(m, st.weights)
        out_mask = own[:, 0, 0] == 0
        # K1
        Xk, sk = fused_rtr.rtr_solve_fused(Xg, own, Pinv, e, DEMO_PARAMS, windows=w, row=0)
        Xk2, sk2 = fused_rtr.rtr_solve_fused(Xg, own, Pinv, e, DEMO_PARAMS, windows=w, row=0)
        Xp, sp_ = fused_rtr.rtr_solve_fused_ref(Xg, own, Pinv, e, DEMO_PARAMS, w.offsets)
        Xp = torch.where(own > 0, Xp, Xg)
        sk, sp_ = sk.double().cpu().numpy(), sp_.double().cpu().numpy()
        xrel = float((Xk - Xp).abs().max() / Xp.abs().max())
        same = torch.equal(Xk, Xk2) and torch.equal(sk2.double().cpu(), torch.as_tensor(sk))
        untouched = torch.equal(Xk[out_mask], Xg[out_mask])
        # K2 on the slot's one-row window: one RTR step (a first solve: the
        # tCG counts must agree), 8 RTR steps (each after the first
        # revisits the block near its optimum, where fp32 sum order decides
        # tCG exits: held by X and steps), 8 RGD steps
        runs = {}
        for rule, rgd, steps in (("rtr1", 0.0, 1), ("rtr", 0.0, 8),
                                 ("rgd", STRETCH_RGD_STEPSIZE, 8)):
            R = w.num_robots
            kw = dict(adj=Xg.new_zeros((R, R)), rel0=Xg.new_ones((R,)), it0=0,
                      last_wu=0, gnc_pending=False, it_cap=steps, tol=0.0,
                      gnc=False, inner=steps, inner_tol=None, rgd_stepsize=rgd,
                      offsets=w.offsets)
            bank = own.reshape(1, -1).contiguous()
            sched = torch.zeros(steps, dtype=torch.int32, device=DEV)
            rk = fused_rtr.rtr_run_fused(Xg, bank, sched, Pinv, e, DEMO_PARAMS,
                                         cost0=0.0, windows=w, **kw)
            rk2 = fused_rtr.rtr_run_fused(Xg, bank, sched, Pinv, e, DEMO_PARAMS,
                                          cost0=0.0, windows=w, **kw)
            rp = fused_rtr.rtr_run_fused_ref(
                Xg, bank, sched, Pinv, e, DEMO_PARAMS, cost0=torch.zeros(1, device=DEV),
                record=False, **kw)
            ks, ps = rk[2].tolist(), rp[2].tolist()
            runs[rule] = dict(
                steps=(int(ks[fused_rtr.RUN_STEPS]), int(ps[fused_rtr.RUN_STEPS])),
                tcg=(int(ks[fused_rtr.RUN_TCG]), int(ps[fused_rtr.RUN_TCG])),
                x_rel=float((rk[0] - rp[0]).abs().max() / rp[0].abs().max()),
                repeat=torch.equal(rk[0], rk2[0]) and torch.equal(rk[2], rk2[2]),
                untouched=torch.equal(rk[0][out_mask], Xg[out_mask]))
        out[name] = dict(block=int(w.num_poses[0]),
                         separators=int(w.pose_off[1] - w.num_poses[0]),
                         edges=int(w.edge_off[1]), cluster=w.cluster,
                         k1_tr=(int(sk[4]), int(sp_[4])), k1_tcg=(int(sk[5]), int(sp_[5])),
                         k1_x_rel=xrel, k2=runs)
        print(f"spmd compare {name}: " + json.dumps(out[name]) + f"; K1 repeat "
              f"bit-identical {same}, outside the block untouched {untouched}", flush=True)
        assert int(sk[4]) == int(sp_[4]) and int(sk[5]) == int(sp_[5]), name
        assert xrel <= TOL_X and same and untouched, name
        for rule, r in runs.items():
            n_steps = 1 if rule == "rtr1" else 8
            assert r["steps"] == (n_steps, n_steps), (name, rule, r)
            assert rule == "rtr" or r["tcg"][0] == r["tcg"][1], (name, rule, r)
            assert r["x_rel"] <= TOL_RUN_X and r["repeat"] and r["untouched"], (name, rule)
    _set_launches(k1=before[0], k2=before[1])  # comparison launches
    return out


def _demo_procs(tmp, tag, num_processes, local, steps, *extra):
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", "dpgo_ros_tpu_torch.scripts.multihost_demo",
         "--num_processes", str(num_processes), "--process_id", str(pid),
         "--coordinator", f"localhost:{port}", "--local_devices", str(local),
         "--synthetic", "sphere", "--synthetic_n", str(MULTI_N), "--steps", str(steps),
         "--device", DEV.type,
         "--x_out", os.path.join(tmp, f"{tag}.npy"), *extra],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(num_processes)]


def _demo_results(procs):
    out = []
    for pid, p in enumerate(procs):
        so, se = p.communicate(timeout=300)
        assert p.returncode == 0, f"demo process {pid} failed:\n{se[-3000:]}"
        line = [l for l in so.splitlines() if l.startswith("MULTIHOST_RESULT")]
        assert line, so[-2000:]
        out.append(json.loads(line[0].split(" ", 1)[1]))
    return out


def phase_spmd_multiprocess(tmp: str) -> dict:
    """Two processes × 2 slots on the one card (gloo, the exchange staged
    through host buffers) against one process × 4 slots, 24 steps each:
    the gathered X and the cost bit-identical; a 2 × 2 run stopped at 12
    steps with its state checkpointed, resumed by a fresh pair of
    processes to 24, bit-identical too. Returns the step seconds."""
    ck = os.path.join(tmp, "mh_ck")
    single = _demo_procs(tmp, "one", 1, 4, MULTI_STEPS)
    pair = _demo_procs(tmp, "two", 2, 2, MULTI_STEPS)
    part = _demo_procs(tmp, "part", 2, 2, MULTI_STEPS // 2, "--checkpoint_dir", ck)
    r1, r2, r3 = _demo_results(single), _demo_results(pair), _demo_results(part)
    r4 = _demo_results(_demo_procs(tmp, "resumed", 2, 2, MULTI_STEPS, "--resume", ck))
    X1, X2, X4 = (np.load(os.path.join(tmp, f"{t}.npy")) for t in ("one", "two", "resumed"))
    print(f"spmd 2 processes x 2 slots vs 1 x 4 ({MULTI_STEPS} steps, sphere "
          f"{MULTI_N}): cost {r2[0]['final_cost']!r} / {r1[0]['final_cost']!r}, X "
          f"bit-identical {np.array_equal(X1, X2)}; resumed at {MULTI_STEPS // 2}: cost "
          f"{r4[0]['final_cost']!r}, bit-identical {np.array_equal(X1, X4)}; step "
          f"seconds 1x4 {r1[0]['elapsed_s']}, 2x2 {r2[0]['elapsed_s']} / "
          f"{r2[1]['elapsed_s']}", flush=True)
    assert r2[0]["num_processes"] == 2 and r2[0]["global_devices"] == 4
    assert r1[0]["final_cost"] == r2[0]["final_cost"] == r2[1]["final_cost"]
    assert np.array_equal(X1, X2)
    assert r4[0]["final_cost"] == r4[1]["final_cost"] == r1[0]["final_cost"]
    assert np.array_equal(X1, X4)
    assert r1[0]["final_cost"] < r1[0]["init_cost"]
    return {"one_by_four_s": r1[0]["elapsed_s"], "two_by_two_s": r2[0]["elapsed_s"],
            "steps": MULTI_STEPS}


def phase_spmd_timing() -> dict:
    """On the slot windows of the 3-slot case: K1 device ms per launch (a
    profiler trace) and per wrapper call (CUDA events: the mask check's
    read-back included), its plain version's ms, the bound; K2 device ms per
    step (8 RGD steps per launch, the stretch's work) and the plain
    version's; then one M = 5 spmd CLI run under torch.profiler: busy,
    K1's share, the idle share."""
    from types import SimpleNamespace

    from dpgo_ros_tpu_torch.parallel import multihost
    from dpgo_ros_tpu_torch.utils.work import rgd_flops

    name, Xg, m, step, st = next(iter(_slot_cases()))
    w, own = step._windows[m], step._own[m]
    e = dataclasses.replace(step._edges[m], weight=st.weights[m])
    Pinv = step._pinv(m, st.weights)
    before = (_launches("k1"), _launches("k2"))
    k1 = lambda: fused_rtr.rtr_solve_fused(Xg, own, Pinv, e, DEMO_PARAMS, windows=w, row=0)
    plain = lambda: fused_rtr.rtr_solve_fused_ref(Xg, own, Pinv, e, DEMO_PARAMS, w.offsets)
    k1_dev = _kernel_ms(k1, "rtr_block_kernel")
    k1_call = _time(k1, 5)
    k1_plain = _time(plain, 1)
    stats = k1()[1].tolist()
    R = w.num_robots
    kw = dict(adj=Xg.new_zeros((R, R)), rel0=Xg.new_ones((R,)), it0=0, last_wu=0,
              gnc_pending=False, it_cap=8, tol=0.0, gnc=False, inner=8,
              inner_tol=None, rgd_stepsize=STRETCH_RGD_STEPSIZE, offsets=w.offsets)
    bank = own.reshape(1, -1).contiguous()
    sched = torch.zeros(8, dtype=torch.int32, device=DEV)
    k2 = lambda: fused_rtr.rtr_run_fused(Xg, bank, sched, Pinv, e, DEMO_PARAMS,
                                         cost0=0.0, windows=w, **kw)
    k2_dev = _kernel_ms(k2, "rtr_run_kernel") / 8
    k2_plain = _time(lambda: fused_rtr.rtr_run_fused_ref(
        Xg, bank, sched, Pinv, e, DEMO_PARAMS, cost0=torch.zeros(1, device=DEV),
        record=False, **kw), 1) / 8
    _set_launches(k1=before[0], k2=before[1])  # timing launches
    # bounds over the block's poses, its live edges and its separators
    # (utils/work.py; the slot's padding copies carry no term)
    nk, Ek = int(w.num_poses[0]), int(w.edge_off[1])
    sep = int(w.pose_off[1]) - nk
    counts = SimpleNamespace(r=5, d=3, num_robots=R)
    k1_bnd = bound(solve_bytes(counts, nk, Ek, sep),
                   rtr_flops(nk, Ek, 5, 3, int(stats[4]), int(stats[5])))
    # a K2 step: the same operands over the launch's 8 steps, X written once
    k2_bnd = bound(solve_bytes(counts, nk, Ek, sep, stats=4) / 8, rgd_flops(nk, Ek, 5, 3))
    print(f"spmd timing ({name}, {nk} block poses, {sep} separators, {Ek} edges): K1 "
          f"{k1_dev:.4f} ms on the device ({int(stats[5])} tCG), {k1_call:.4f} ms per "
          f"wrapper call (the mask check's read-back included), plain {k1_plain:.3f} ms, "
          f"bound {k1_bnd[0] * 1e3:.4f} us by {k1_bnd[1]}; K2 RGD {k2_dev:.4f} ms per step "
          f"on the device, plain {k2_plain:.3f} ms, bound {k2_bnd[0] * 1e3:.4f} us by "
          f"{k2_bnd[1]}", flush=True)
    # one M = 5 CLI run under the profiler: busy, K1 share, idle share
    multihost.initialize("localhost:1", 1, 0, local_slot_count=5, device=DEV.type)
    try:
        launched = roofline.launches()
        with roofline.padded_profile() as prof:
            t = time.time()
            summary, extras = cli.run(DPGO_DEMO + ["--mode", "spmd"])
            torch.cuda.synchronize()
            wall = time.time() - t
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "spmd.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        busy = roofline.session_busy_ms(events, roofline.launches() - launched)
        k1_ev = [ev for ev in events if ev.get("ph") == "X"
                 and ev.get("cat") in roofline.DEVICE_CATS
                 and "rtr_block_kernel" in ev.get("name", "")]
        k1_ms = sum(ev["dur"] for ev in k1_ev) / 1e3
    finally:
        multihost.shutdown()
    _set_launches(k1=before[0])
    prof_out = dict(profiled_wall_s=wall, busy_ms=busy, k1_ms=k1_ms,
                    k1_launches=len(k1_ev), k1_share_of_busy=k1_ms / max(busy, 1e-9),
                    idle_share=1 - busy / (1e3 * wall), launches=summary["launches"])
    print(f"spmd profile (M = 5): profiled wall {wall:.3f} s, device busy {busy:.3f} ms "
          f"(idle share {prof_out['idle_share']:.4f}), K1 {k1_ms:.3f} ms in {len(k1_ev)} "
          f"launches", flush=True)
    return dict(k1=(k1_dev, k1_plain, k1_bnd), k1_call_ms=k1_call,
                k2=(k2_dev, k2_plain, k2_bnd), profile=prof_out,
                shape=dict(block=nk, separators=sep, edges=Ek, cluster=w.cluster))


# ---------------------------------------------------------------- RGD, observability

# the asapp_demo's preconditioned step (launch/asapp_demo.launch), the RGD
# solver's stepsize on the dpgo_demo and GNC worlds
RGD_STEPSIZE = 0.2
ENGINE_RGD_UPDATES = 30  # fixed updates (tolerance 0) of the engine RGD runs
# --csv: the world read back from per-robot CSVs (its edges in another
# order, so fp32 sums in another order) against the same world generated
# (rel 1.5e-6 on the CPU, fp32)
TOL_CSV_COST = 1e-4
# the fused and engine RGD routes' GNC runs (their rounds fire on fp32
# rel-change thresholds; TOL_SPMD_GNC_COST's reason)
TOL_RGD_GNC_COST = 5e-3
VIZ_EVERY = 10


def _demo_engine(argv, **config):
    """(engine, initial state) of the CLI's world and config for ``argv``
    on the card (fp32), the config updated with ``config``."""
    parser = cli.build_parser()
    a = parser.parse_args(argv)
    cli.apply_demo(a, parser)
    data, _, _ = cli.load_data(a)
    cfg = dataclasses.replace(cli.args_to_config(a), num_robots=data.num_robots,
                              **config)
    prob = LiftedProblem.from_data(data, r=cfg.relaxation_rank, dtype=torch.float32,
                                   device=DEV)
    eng = RBCDEngine(prob, cfg)
    return eng, eng.initialize()


def _rgd(eng, rule=None, **config) -> RBCDEngine:
    """An RGD engine on ``eng``'s problem (its rule unless ``rule``)."""
    cfg = dataclasses.replace(eng.config, solver=SolverMethod.RGD,
                              RGD_stepsize=RGD_STEPSIZE, **config)
    if rule is not None:
        cfg = dataclasses.replace(cfg, update_rule=UpdateRule(rule))
    return RBCDEngine(eng.problem, cfg)


def _k2_plain(X, bank, sched, Pinv, edges, params, *, windows, cost0, record=False, **kw):
    """K2's plain version in its wrapper's place: the same operands, on the
    card (``windows`` is the kernel's alone)."""
    cost0 = torch.as_tensor(cost0, dtype=X.dtype, device=X.device).reshape(1)
    return fused_rtr.rtr_run_fused_ref(X, bank, sched, Pinv, edges, params,
                                       cost0=cost0, record=record, **kw)


def _rgd_states():
    """(name, RTR engine, state) to hold K2's RGD step on: the dpgo_demo
    world after 5 RTR updates (K4), and the GNC demo's after one sweep of 8
    updates and its first weight round, whose loop closures then carry
    fractional and zero TLS weights (asserted)."""
    eng, st0 = _demo_engine(DPGO_DEMO)
    st, _ = eng.run(st0, max_iters=5)
    yield "dpgo_demo", eng, st
    eng, st0 = _demo_engine(GNC_DEMO)
    st, _ = eng.run(st0, max_iters=8)
    st = eng._weight_update_impl(st)
    w = st.weights.cpu().numpy()
    live = eng.problem.host_edges.is_loop > 0
    frac, zero = int((live & (w > 0) & (w < 1)).sum()), int((live & (w == 0)).sum())
    print(f"rgd: GNC state after weight round {st.weight_update_count}: "
          f"{int(live.sum())} loop closures, {frac} fractional, {zero} zero weights",
          flush=True)
    assert st.weight_update_count == 1 and frac > 0 and zero > 0, (frac, zero)
    yield "gnc/round1", eng, st


def phase_compare_rgd() -> tuple:
    """K2's RGD variant as the engine launches it (one step, the cost
    carried by the window's f − f0) against its plain version, on every
    robot window (RoundRobin) and colour window (Parallel) of the
    dpgo_demo world and of the GNC world after its first weight round.
    Gates: X within TOL_RUN_X of max |X|, the cost within rel
    TOL_RUN_COST, every pose outside the block bit-unchanged, a second
    launch bit-identical. Returns (max abs X error, {case: launch shape})."""
    worst, shapes = 0.0, {}
    before = _launches("k2")
    for name, rtr_eng, st in _rgd_states():
        for rule in ("RoundRobin", "Parallel"):
            eng = _rgd(rtr_eng, rule)
            e = eng._edges(st.weights)
            Pinv = eng._solver_cache(e)
            par = rule == "Parallel"
            for row in range(eng._bank.shape[0]):
                route = dict(color=row) if par else dict(robot=row)
                mask = (eng._color_masks if par else eng._masks)[row]
                go = lambda: eng._local_solve(st.X, e, mask, Pinv, cost=st.cost, **route)
                Xk, sk = go()
                Xk2, sk2 = go()
                with mock.patch.object(fused_rtr, "rtr_run_fused", _k2_plain):
                    Xp, sp = go()
                out = mask.reshape(-1) == 0
                err = float((Xk - Xp).abs().max())
                xrel = err / float(Xp.abs().max())
                ck, cp = float(sk[fused_rtr.RUN_COST]), float(sp[fused_rtr.RUN_COST])
                crel = abs(ck - cp) / abs(cp)
                same = torch.equal(Xk, Xk2) and torch.equal(sk, sk2)
                untouched = torch.equal(Xk[out], st.X[out])
                case = f"{name}/{'color' if par else 'robot'}{row}"
                w = eng._row_windows
                shapes[case] = dict(launch_shape(w, eng.problem.d, eng.problem.r),
                                    block=int(w.num_poses[row]))
                worst = max(worst, err)
                print(f"rgd {case}: cost {float(st.cost):.7g} -> {ck:.7g} (plain {cp:.7g}, "
                      f"rel {crel:.2e}), X rel {xrel:.2e} (max abs {err:.2e}), outside "
                      f"untouched {untouched}, repeat bit-identical {same}; "
                      f"{json.dumps(shapes[case])}", flush=True)
                # the last robot solved sits at its block's optimum: its step
                # may move the cost by rounding only
                assert math.isfinite(ck) and ck <= float(st.cost) * (1 + TOL_RUN_COST), case
                assert xrel <= TOL_RUN_X and crel <= TOL_RUN_COST, case
                assert untouched and same, case
    _set_launches(k2=before)  # comparison launches
    return worst, shapes


ENGINE_RGD_CASES = (("roundrobin", "RoundRobin", {}), ("parallel", "Parallel", {}),
                    ("accelerated", "RoundRobin", dict(acceleration=True)))


def phase_engine_rgd() -> dict:
    """``solver = RGD`` through the engine on the dpgo_demo world for
    ENGINE_RGD_UPDATES updates (tolerance 0) under RoundRobin, Parallel and
    acceleration, the counters zeroed just before each run: K2 launches ==
    updates + restarts and no other kernel. The same runs on the plain
    route (K2's plain version on the card in its wrapper's place): the
    same restarts, the cost history within rel TOL_RUN_COST. Then the
    device-to-host copies per RoundRobin RGD update, from two traced runs
    (30 and 60 updates): one (the engine's read). Returns {case: {k2 launches, updates,
    restarts, final cost, solve s}}."""
    base, st0 = _demo_engine(DPGO_DEMO)
    out = {}
    for name, rule, config in ENGINE_RGD_CASES:
        eng = _rgd(base, rule, relative_change_tolerance=0.0, **config)
        eng.run(st0, max_iters=2)  # the windows, built on first use
        _zero_counts()
        t = time.time()
        st, info = eng.run(st0, max_iters=ENGINE_RGD_UPDATES)
        torch.cuda.synchronize()
        secs = time.time() - t
        counts = _counts()
        with mock.patch.object(fused_rtr, "rtr_run_fused", _k2_plain):
            _, pinfo = eng.run(st0, max_iters=ENGINE_RGD_UPDATES)
        hk, hp = np.array(info["history"]["cost"]), np.array(pinfo["history"]["cost"])
        rel = float(np.max(np.abs(hk - hp) / np.abs(hp)))
        print(f"engine rgd {name}: {info['iterations']} updates, {info['restarts']} "
              f"restarts (plain {pinfo['restarts']}), launches {counts}, cost "
              f"{float(st0.cost):.7g} -> {info['final_cost']:.7g} (plain "
              f"{pinfo['final_cost']:.7g}), max rel history deviation {rel:.2e}, "
              f"{secs:.3f} s", flush=True)
        assert info["iterations"] == ENGINE_RGD_UPDATES and info["tcg_iterations"] == 0
        _only(counts, k2=info["iterations"] + info["restarts"],
              k7=info["iterations"] if config.get("acceleration") else 0)
        assert info["restarts"] == pinfo["restarts"] and rel <= TOL_RUN_COST, name
        assert info["final_cost"] < float(st0.cost)
        out[name] = dict(k2=counts["k2"], updates=info["iterations"],
                         restarts=info["restarts"], final_cost=info["final_cost"],
                         solve_s=secs)
    # host reads per RGD update: the device-to-host copies of two traced
    # runs, of N and 2N updates, differ by N updates' reads alone
    eng = _rgd(base, relative_change_tolerance=0.0)
    eng.run(st0, max_iters=eng.problem.num_robots)  # windows built, checks read
    n = ENGINE_RGD_UPDATES
    copies = [_dtoh(_traced(lambda k=k: eng.run(st0, max_iters=k)))[0] for k in (n, 2 * n)]
    per_update = (copies[1] - copies[0]) / n
    print(f"engine rgd: device-to-host copies {copies[0]} in {n} updates, {copies[1]} "
          f"in {2 * n}: {per_update:.3f} per update", flush=True)
    assert per_update == 1.0  # the engine's one read (rbcd.RBCDEngine._read)
    out["roundrobin"]["dtoh_per_update"] = per_update
    return out


def _traced(fn) -> list:
    """The events of a padded torch.profiler trace of ``fn()``."""
    with roofline.padded_profile() as prof:
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def phase_fused_rgd(engine_rgd: dict) -> dict:
    """The fused runner with ``solver = RGD``, the counters zeroed just
    before each run: the dpgo_demo world's ENGINE_RGD_UPDATES steps in one
    K2 launch, its final cost within rel TOL_RUN_COST of the engine RGD
    route's; the GNC demo (RGD) one K2 launch per stretch (weight rounds +
    1), its rounds, updates and final cost those of the engine RGD route
    on the same config (K2 per update). Returns {case: {k2, updates,
    final cost, solve s}}. The GNC runs' rounds fire on rel-change
    thresholds that the two routes compute in another fp32 sum order, so
    a round may fire a step apart: their costs are held to
    TOL_RGD_GNC_COST and their accept sets to MIN_MODE_AGREEMENT."""
    out = {}
    base, st0 = _demo_engine(DPGO_DEMO)
    eng = _rgd(base, relative_change_tolerance=0.0)
    eng.make_fused_run(2)(st0)  # the windows, built on first use
    _zero_counts()
    t = time.time()
    st, tcg = eng.make_fused_run(ENGINE_RGD_UPDATES, return_stats=True)(st0)
    torch.cuda.synchronize()
    secs = time.time() - t
    counts = _counts()
    ref = engine_rgd["roundrobin"]["final_cost"]
    rel = abs(float(st.cost) - ref) / abs(ref)
    print(f"fused rgd: {st.iteration} steps, launches {counts}, cost {float(st.cost):.7g} "
          f"(engine route {ref:.7g}, rel {rel:.2e}), {secs:.3f} s", flush=True)
    _only(counts, k2=1)
    assert st.iteration == ENGINE_RGD_UPDATES == tcg and rel <= TOL_RUN_COST
    out["l2"] = dict(k2=counts["k2"], updates=st.iteration, final_cost=float(st.cost),
                     solve_s=secs)
    gbase, g0 = _demo_engine(GNC_DEMO)
    geng = _rgd(gbase)
    cap = geng.config.max_iteration_number
    _zero_counts()
    t = time.time()
    gst = geng.make_fused_run(cap)(g0)
    torch.cuda.synchronize()
    secs = time.time() - t
    counts = _counts()
    est, ginfo = geng.run(g0)
    gref = ginfo["final_cost"]
    rel = abs(float(gst.cost) - gref) / abs(gref)
    stats = geng.gnc_info(gst.weights)["gnc_stats"]
    loops = geng.problem.host_edges.is_loop > 0
    agree = float(np.mean((gst.weights.cpu().numpy()[loops] > 0.5)
                          == (est.weights.cpu().numpy()[loops] > 0.5)))
    print(f"fused rgd gnc: {gst.iteration} steps (engine route {ginfo['iterations']}), "
          f"weight rounds {gst.weight_update_count} ({est.weight_update_count}), "
          f"launches {counts}, cost {float(gst.cost):.7g} (engine route {gref:.7g}, rel "
          f"{rel:.2e}), accept sets agree on {100 * agree:.2f} %, {json.dumps(stats)}, "
          f"{secs:.3f} s", flush=True)
    _only(counts, k2=gst.weight_update_count + 1)
    assert gst.weight_update_count == est.weight_update_count == (
        geng.config.robust_opt_num_weight_updates)
    assert rel <= TOL_RGD_GNC_COST and agree >= MIN_MODE_AGREEMENT
    out["gnc"] = dict(k2=counts["k2"], updates=gst.iteration, final_cost=float(gst.cost),
                      weight_rounds=gst.weight_update_count, solve_s=secs)
    return out


def phase_timing_rgd() -> tuple:
    """K2's one-step RGD launch on robot 0's window of the dpgo_demo world
    (the engine's RGD update): device ms from a profiler trace, ms per
    wrapper call (CUDA events), the plain version's ms and the bound: the
    window's operands read once, the block and stats written once; the
    step's operations and the two cost passes over the window's edges.
    Returns (device ms, plain ms, bound (ms, by), call ms)."""
    from types import SimpleNamespace

    from dpgo_ros_tpu_torch.utils.work import cost_flops, rgd_flops

    base, st0 = _demo_engine(DPGO_DEMO)
    eng = _rgd(base)
    e = eng._edges(st0.weights)
    Pinv = eng._solver_cache(e)
    go = lambda: eng._local_solve(st0.X, e, eng._masks[0], Pinv, robot=0, cost=st0.cost)
    before = _launches("k2")
    dev = _kernel_ms(go, "rtr_run_kernel", reps=20)
    call = _time(go, 20)
    with mock.patch.object(fused_rtr, "rtr_run_fused", _k2_plain):
        plain = _time(go, 2)
    _set_launches(k2=before)  # timing launches
    prob = eng.problem
    nk, Ek, ns = block_work(prob, prob.robot_of_pose == 0)
    counts = SimpleNamespace(r=prob.r, d=prob.d, num_robots=prob.num_robots)
    bnd = bound(solve_bytes(counts, nk, Ek, ns, stats=4),
                rgd_flops(nk, Ek, prob.r, prob.d) + 2 * cost_flops(Ek, prob.r, prob.d))
    print(f"rgd timing (robot 0: {nk} block poses, {ns} separators, {Ek} edges, "
          f"{eng._row_windows.cluster} CTAs): K2 one RGD step {dev:.4f} ms on the device, "
          f"{call:.4f} ms per wrapper call, plain {plain:.3f} ms, bound "
          f"{bnd[0] * 1e3:.4f} us by {bnd[1]}", flush=True)
    return dev, plain, bnd, call


def _trace_events(directory: str) -> list:
    """The events of the one Chrome trace (``trace_*.json``) that
    ``--profile_dir`` wrote into ``directory``, beside its span table."""
    files = [f for f in os.listdir(directory)
             if f.startswith("trace_") and f.endswith(".json")]
    assert len(files) == 1, files
    with open(os.path.join(directory, files[0])) as f:
        return json.load(f)["traceEvents"]


def _dtoh(events) -> tuple:
    """(device-to-host copies in a trace, those launched inside the CLI's
    "snapshot" span): a copy's runtime call on the host, matched by its
    correlation id, lies inside the span's interval. The span is matched by
    name on the host, whatever its category (``cpu_op`` for the profiler's
    fast range event, ``user_annotation`` for ``record_function``)."""
    spans = [(ev["ts"], ev["ts"] + ev["dur"]) for ev in events
             if ev.get("ph") == "X" and ev.get("name") == "snapshot"
             and ev.get("cat") not in roofline.DEVICE_CATS]
    host = {ev["args"]["correlation"]: ev["ts"] for ev in events
            if ev.get("cat") == "cuda_runtime" and "correlation" in ev.get("args", {})}
    copies = [ev for ev in events
              if ev.get("cat") == "gpu_memcpy" and "DtoH" in ev.get("name", "")]
    inside = sum(any(a <= host.get(ev["args"].get("correlation"), -1) <= b
                     for a, b in spans) for ev in copies)
    return len(copies), inside


def _write_csvs(directory: str, data) -> list:
    """Per-robot ``measurements.csv`` files of ``data``: each robot's file
    holds the measurements whose source pose it owns."""
    from dpgo_ros_tpu_torch.io.g2o import rot_to_quat

    m = data.measurements
    paths = []
    for k in range(data.num_robots):
        rows = ["robot_src,pose_src,robot_dst,pose_dst,qx,qy,qz,qw,tx,ty,tz,"
                "kappa,tau,is_known_inlier,weight"]
        for i in np.flatnonzero(m.src_robot == k):
            vals = [*rot_to_quat(m.R[i]), *m.t[i], m.kappa[i], m.tau[i]]
            rows.append(f"{m.src_robot[i]},{m.src_frame[i]},{m.dst_robot[i]},"
                        f"{m.dst_frame[i]}," + ",".join(repr(float(v)) for v in vals)
                        + f",{int(m.fixed_weight[i])},{float(m.weight[i])!r}")
        path = os.path.join(directory, f"robot{k}", "measurements.csv")
        os.makedirs(os.path.dirname(path))
        with open(path, "w") as f:
            f.write("\n".join(rows) + "\n")
        paths.append(path)
    return paths


def phase_observability(tmp: str, engine_summary) -> dict:
    """The CLI's new flags on the card. The dpgo_demo engine run with
    ``--viz_interval_iters VIZ_EVERY --viz_dir --profile_dir --verbose
    true`` and the same run with ``--profile_dir`` alone: the snapshot files
    and manifest rows at iterations 1, 1 + VIZ_EVERY, ...; the trace holds
    the run's K4 launches by kernel name; the device-to-host copies outside
    the snapshots equal the other run's, so an update that writes no
    snapshot reads nothing more; stderr holds the resolved config and one
    line per update. Then ``--csv`` on per-robot CSVs of the world written
    here: K4 per update, the final cost within rel TOL_CSV_COST of the
    generated world's run. Returns the readings."""
    argv = DPGO_DEMO + ["--update_rule", "RoundRobin"]
    viz, prof_a, prof_b = (os.path.join(tmp, d) for d in ("viz", "prof_a", "prof_b"))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        summary, extras, counts = _counted_run(argv + [
            "--viz_interval_iters", str(VIZ_EVERY), "--viz_dir", viz,
            "--profile_dir", prof_a, "--verbose", "true"])
    updates = extras["block_updates"]
    _only(counts, k4=updates)
    lines = err.getvalue().splitlines()
    config = [ln for ln in lines if ln.startswith("resolved config: ")]
    iters = [ln for ln in lines if re.match(r"iter \d+: max_rel_change ", ln)]
    assert len(config) == 1 and json.loads(config[0][17:])["verbose"] is True
    assert len(iters) == updates, (len(iters), updates)
    with open(os.path.join(viz, "snapshots.csv")) as f:
        rows = f.read().splitlines()[1:]
    snaps = [int(r.split(",")[0]) for r in rows]
    assert snaps == list(range(1, updates + 1, VIZ_EVERY)), snaps
    for r in rows:
        assert os.path.getsize(os.path.join(viz, r.split(",")[3])) > 0
    assert os.path.getsize(os.path.join(viz, "latest.html")) > 0
    events = _trace_events(prof_a)
    k4_ev = [ev for ev in events if ev.get("cat") in roofline.DEVICE_CATS
             and "rtr_window_kernel" in ev.get("name", "")]
    total_a, in_snap = _dtoh(events)
    _, extras_b, counts_b = _counted_run(argv + ["--profile_dir", prof_b])
    total_b, _ = _dtoh(_trace_events(prof_b))
    assert extras_b["block_updates"] == updates
    per_a = (total_a - in_snap) / updates
    per_b = total_b / updates
    print(f"observability: {updates} updates, {len(snaps)} snapshots, K4 {len(k4_ev)} "
          f"launches in the trace (counter {counts['k4']}), device-to-host copies "
          f"{total_a} with snapshots ({in_snap} inside them, {per_a:.3f} per update "
          f"outside) vs {total_b} without ({per_b:.3f} per update); cost "
          f"{summary['final_cost']:.7g}", flush=True)
    assert len(k4_ev) == counts["k4"] == updates
    assert total_a - in_snap == total_b and in_snap > 0
    assert abs(summary["final_cost"] - engine_summary["final_cost"]) <= (
        TOL_MODES_COST * engine_summary["final_cost"])
    # --csv: the same world read back from per-robot CSVs
    data, _, _ = generate_world("sphere", n=2500, num_robots=5, seed=42)
    paths = _write_csvs(os.path.join(tmp, "csv"), data)
    csv_argv = (["--csv", *paths] + DPGO_DEMO[DPGO_DEMO.index("--device"):]
                + ["--num_robots", "5", "--update_rule", "RoundRobin",
                   "--local_initialization_method", "Chordal",
                   "--relative_change_tolerance", "0.2", "--RTR_gradnorm_tol", "0.5"])
    csum, cext, ccounts = _counted_run(csv_argv)
    rel = abs(csum["final_cost"] - engine_summary["final_cost"]) / engine_summary["final_cost"]
    print(f"observability --csv: {json.dumps(csum)}, launches {ccounts}, rel to the "
          f"generated world's run {rel:.2e}", flush=True)
    _only(ccounts, k4=cext["block_updates"])
    assert rel <= TOL_CSV_COST and csum["final_cost"] < cext["initial_cost"]
    return dict(updates=updates, snapshots=len(snaps), trace_k4_launches=len(k4_ev),
                dtoh_with_viz=total_a, dtoh_in_snapshots=in_snap, dtoh_without_viz=total_b,
                dtoh_per_update_outside_snapshots=per_a, dtoh_per_update_without_viz=per_b,
                csv_final_cost=csum["final_cost"], csv_updates=cext["block_updates"])


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def phase_checkpoint_dcp(tmp: str, card: str) -> dict:
    """The dpgo_demo engine (fp32, K4, rel-change stop off) runs 7 updates;
    its CUDA state is saved through dcp and through npz, each loaded by the
    CLI's resume (``load_state(device="cuda")``) into a fresh engine, and
    run 5 more: the final cost and X bit-identical to the uninterrupted
    12-update run, K4 once per resumed update (each save timed twice: the
    first pays the backend's imports). Then two processes on the
    card (gloo) save and load one fp32 state collectively
    (``scripts/dcp_check.py``), bit for bit. Returns the readings."""
    full_eng, st0 = _demo_engine(DPGO_DEMO, relative_change_tolerance=0.0)
    full, _ = full_eng.run(st0, max_iters=12)
    eng, st0 = _demo_engine(DPGO_DEMO, relative_change_tolerance=0.0)
    part, _ = eng.run(st0, max_iters=7)
    out = {"card": card}
    for backend in ("dcp", "npz"):
        path = os.path.join(tmp, backend)
        # the first save pays the backend's imports; the second replaces it
        first_ms, save_ms = (dcp_check.synced_ms(lambda: ckpt.save_state(
            path, part, eng.Ylift, backend=backend), DEV)[1] for _ in range(2))
        fresh, _ = _demo_engine(DPGO_DEMO, relative_change_tolerance=0.0)
        st, load_ms = dcp_check.synced_ms(lambda: cli._resume_rbcd(fresh, path), DEV)
        for f, v in st._asdict().items():
            floating = isinstance(v, torch.Tensor) and v.is_floating_point()
            assert not floating or v.device.type == DEV.type, f
        _zero_counts()
        done, _ = fresh.run(st, max_iters=5)
        _only(_counts(), k4=5)
        assert done.iteration == 12, done.iteration
        assert torch.equal(done.X, full.X) and torch.equal(done.cost, full.cost), backend
        out[backend] = {"first_save_ms": first_ms, "save_ms": save_ms, "load_ms": load_ms,
                        "bytes": _dir_bytes(path), "final_cost": float(done.cost)}
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dpgo_ros_tpu_torch.scripts.dcp_check",
         "--num_processes", "2", "--process_id", str(pid),
         "--coordinator", f"localhost:{port}", "--path", os.path.join(tmp, "pair", "ck"),
         "--device", DEV.type, "--n", "2500"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for pid in range(2)]
    pair = []
    for pid, p in enumerate(procs):
        so, se = p.communicate(timeout=300)
        assert p.returncode == 0, f"dcp_check process {pid} failed:\n{se[-3000:]}"
        line = [l for l in so.splitlines() if l.startswith("DCP_RESULT")]
        assert line, so[-2000:]
        pair.append(json.loads(line[0].split(" ", 1)[1]))
    assert all(r["device"].startswith(DEV.type) and r["backend"] == "gloo"
               and r["files"] == ["ck"] for r in pair), pair
    out["two_processes"] = {k: [r[k] for r in pair]
                            for k in ("first_save_ms", "save_ms", "load_ms")}
    out["two_processes"]["dcp_files"] = pair[0]["dcp_files"]
    print(f"checkpoint_dcp: {json.dumps(out)}", flush=True)
    return out


BENCH_ARGS = ["--k_chain", "4", "--regions", "1"]


def phase_bench(tmp: str, roof_row: dict) -> dict:
    """The port's headline harness (``scripts/bench.py``) on the dpgo_demo
    world, short (BENCH_ARGS: one region of 4 chained solves), with the
    counters zeroed just before and read just after; its floor from this
    run's roofline phase (the sphere2500 row, handed over as the JSON that
    ``roofline.py --out`` writes). Gates (bench.py raises on the first two):
    every solve ran 100 updates; the final costs lie within bench.py's band;
    the fused routes (Parallel, RoundRobin) launched K2 once per solve and
    nothing else, the engine route K4 once per update (100 per solve) and
    nothing else; every route's per-solve wall ≥ 0.9 × its tCG per solve ×
    the roofline's least valid per-tCG slope. Prints the bench's JSON line;
    returns it."""
    from dpgo_ros_tpu_torch.scripts import bench

    path = os.path.join(tmp, "roofline.json")
    with open(path, "w") as f:
        json.dump({"rows": {"sphere2500": roof_row}}, f)
    _zero_counts()
    res = bench.main(BENCH_ARGS + ["--roofline", path, "--device", DEV.type])
    counts = _counts()
    total = {k: 0 for k in counts}
    for label, r in res["routes"].items():
        want = ({"k2": r["solves"]} if r["runner"] == "fused"
                else {"k4": bench.NUM_ITERS * r["solves"]})
        got = {k: v for k, v in r["launches"].items() if v}
        print(f"bench {label}: {r['updates_per_sec']:.1f} updates/s, {r['per_solve_s'] * 1e3:.3f}"
              f" ms per solve, tCG per solve {r['tcg_per_solve']} [{r['tcg_per_solve_min']}, "
              f"{r['tcg_per_solve_max']}], {r['host_reads_per_solve']} host reads per solve; "
              f"floor {r['device_floor_s']} s ({r['device_floor_from']}); launches {got} for "
              f"{r['solves']} solves", flush=True)
        assert got == want, (label, got, want)
        assert r["device_floor_s"] is not None and r["device_floor_ok"], (label, r)
        for k, v in r["launches"].items():
            total[k] += v
    assert counts == total, (counts, total)
    return res


# fresh processes per arm of phase_roofline_first_trace
FIRST_TRACE_PROCS = 3


def phase_roofline_first_trace() -> dict:
    """The roofline's first traces in fresh processes
    (``scripts/first_trace.py``): FIRST_TRACE_PROCS processes whose first
    session is a padded trace of one reference-budget K4 solve on
    sphere2500's robot 0 window, and as many whose first session is empty,
    each with a second trace (a chain of two forced K = 1 solves), through
    ``utils.profiling.padded_profile`` (its warm-up before the first
    session). Gate: every trace holds every K4 launch of its call. Returns
    the per-arm counts."""
    from dpgo_ros_tpu_torch.scripts import first_trace

    with contextlib.redirect_stdout(io.StringIO()):
        out = first_trace.main(["--procs", str(FIRST_TRACE_PROCS), "--arms",
                                "first,after_empty", "--traces", "2",
                                "--jobs", str(2 * FIRST_TRACE_PROCS)])
    arms = {a["arm"]: {k: a[k] for k in ("processes", "first_lost", "later_lost",
                                         "traces_lost", "traces")} for a in out["arms"]}
    print(f"roofline first trace: {arms} ({out['seconds']:.1f} s)", flush=True)
    assert sum(a["processes"] for a in arms.values()) >= 5, arms
    assert all(a["traces_lost"] == 0 and a["traces"] == 2 * a["processes"]
               for a in arms.values()), arms
    return arms


# the ten entry points of phase_entry_points: (script, arguments); the
# smallGrid3D stand-in where the JAX script's world is smallGrid3D, the
# sweep's baseline and final configurations only
ENTRY_POINTS = (
    ("exp_tunnels_schedule", ["baseline", "final"]),
    ("record_ate_r03", []),  # --schedule: the sweep's output
    ("scaling_bench", []),
    ("record_scaling", []),
    ("record_scaling_r03", []),
    ("record_scaling_r05", []),
    ("exp_spmd", []),
    ("exp_e2e", ["tiny", "small", "sphere", "sphere_accel"]),
    ("micro_bench", []),
    ("proto_chain_precond", ["--world", "smallGrid3D"]),
)
ENTRY_POINTS_S = 90.0
MICRO_K1_CALLS = 12  # per RTR budget: one read of its tCG, one warm, 10 timed


def _entry_point(name: str, argv) -> tuple:
    """``scripts/<name>.main(argv)`` on the card in this process with
    every counter zeroed just before and read just after: (its JSON
    object, the launches, seconds). Asserts one JSON line on stdout, equal
    to the object, that names this card and its power limit."""
    mod = importlib.import_module(f"dpgo_ros_tpu_torch.scripts.{name}")
    buf = io.StringIO()
    _zero_counts()
    t = time.time()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv + ["--device", DEV.type])
    dt = time.time() - t
    counts = _counts()
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == json.loads(json.dumps(out)), (
        name, lines[:2])
    assert f"{out['card']['name']}, {out['card']['power_limit']}" == \
        measure_peaks.card_line(), (name, out["card"])
    return out, counts, dt


def _slot_rows(rows) -> int:
    """K1 launches of scaling_bench rows, each equal to its timed steps'
    active slot-steps; returns their sum with the warm steps'."""
    for r in rows:
        assert r["launches"]["k1"] == r["active_slot_steps"] > 0, r
    return sum(r["active_slot_steps"] + r.get("warm_slot_steps", 0) for r in rows)


def phase_entry_points(tmp: str) -> dict:
    """The ten remaining entry points of ``dpgo_ros_tpu_torch/scripts/`` in
    this process on the card (ENTRY_POINTS), each with the counters zeroed
    just before. Gates: one JSON line naming the card; K4 launches equal to
    the engine's updates in ``exp_tunnels_schedule`` (every run and refit),
    ``record_ate_r03`` and ``exp_e2e``'s RoundRobin presets (+ restarts),
    K1 launches to its Parallel updates and to the active slot-steps in
    ``scaling_bench``, ``record_scaling``'s slot rows and anchors and
    ``exp_spmd``, K1 36 in ``micro_bench``, no kernel in
    ``proto_chain_precond``; the dpgo_demo solves (``record_ate_r03``'s
    distributed solve, ``exp_e2e``'s sphere presets) at the JAX CLI's
    updates and costs, the GNC recall ≥ JAX's − 0.02; the multi-process
    meshes bit-identical; the ten in at most ENTRY_POINTS_S seconds.
    Returns {"k1": {script: launches}, "k4": {...}, "seconds": {...}}."""
    sweep_path = os.path.join(tmp, "sweep.json")
    res, counts, secs = {}, {}, {}
    for name, argv in ENTRY_POINTS:
        if name == "exp_tunnels_schedule":
            argv = argv + ["--out", sweep_path]
        if name == "record_ate_r03":
            argv = argv + ["--schedule", sweep_path]
        res[name], counts[name], secs[name] = _entry_point(name, argv)
        print(f"entry {name}: {secs[name]:.1f} s, launches "
              f"{ {k: v for k, v in counts[name].items() if v} }", flush=True)
    k1, k4 = {}, {}
    # the sweep: one K4 launch per update of every run and refit
    sweep = res["exp_tunnels_schedule"]["configs"]
    total = 0
    for cname, entry in sweep.items():
        for run in entry["runs"].values():
            for r in (run, run.get("refit")):
                if r is not None:
                    assert r["launches"]["k4"] == r["iters"] > 0, (cname, r)
                    total += r["iters"]
            og = run["outliers"]
            assert og["rejected_true"] / og["planted"] >= JAX_GNC_RECALL - 0.02, og
        print(f"entry exp_tunnels_schedule {cname}: agreement {entry['agreement']:.4f}, "
              f"{entry['num_flipped']} flips, ATE over span {entry['ate_over_span']:.5f}"
              + (f", refit ATE {entry['common_set_refit_ate']:.4f}"
                 if "common_set_refit_ate" in entry else ""), flush=True)
    _only(counts["exp_tunnels_schedule"], k4=total)
    k4["exp_tunnels_schedule"] = total
    # ATE r03: the dpgo_demo solve and the centralized one, K4 per update
    ate = res["record_ate_r03"]["sphere2500_5robot_vs_centralized"]
    assert ate["distributed_iters"] == DEMO_UPDATES, ate
    assert abs(ate["distributed_cost"] - ONE_BLOCK_DEMO_COST) <= (
        TOL_MODES_COST * ONE_BLOCK_DEMO_COST), ate["distributed_cost"]
    assert ate["distributed_launches"]["k4"] == ate["distributed_iters"]
    assert ate["centralized_launches"]["k4"] == ate["centralized_iters"]
    k4["record_ate_r03"] = ate["distributed_iters"] + ate["centralized_iters"]
    _only(counts["record_ate_r03"], k4=k4["record_ate_r03"])
    tun = res["record_ate_r03"]["tunnels_8robot_gnc_schedule_independence"]
    assert tun["accept_reject_agreement"] == sweep["final"]["agreement"]
    # the mesh rows: K1 once per active slot-step
    k1["scaling_bench"] = _slot_rows(res["scaling_bench"]["rows"])
    _only(counts["scaling_bench"], k1=k1["scaling_bench"])
    rs = res["record_scaling"]
    k1["record_scaling"] = _slot_rows(rs["slots"] + [rs["single_card"]])
    _only(counts["record_scaling"], k1=k1["record_scaling"])
    assert rs["multi_process"]["bit_identical_across_layouts"], rs["multi_process"]
    for name in ("record_scaling_r03", "record_scaling_r05"):
        k1[name] = _slot_rows([res[name]["anchor"]])
        _only(counts[name], k1=k1[name])
    sp = res["exp_spmd"]
    assert sp["launches"]["k1"] == sp["active_slot_steps"] > 0, sp
    k1["exp_spmd"] = sp["active_slot_steps"]
    _only(counts["exp_spmd"], k1=k1["exp_spmd"])
    # exp_e2e: K4 per RoundRobin update, K1 per Parallel one (+ restarts)
    want = {"k1": 0, "k4": 0, "k7": 0}
    for preset, rows in res["exp_e2e"]["presets"].items():
        for r in rows:
            kernel = "k1" if r["rule"] == "Parallel" else "k4"
            assert r["launches"][kernel] == r["iterations"] + r["restarts"] > 0, r
            want[kernel] += r["iterations"] + r["restarts"]
            k7 = r["iterations"] if r["acceleration"] else 0
            assert r["launches"]["k7"] == k7, r
            want["k7"] += k7
            if preset == "sphere":
                assert r["iterations"] == DEMO_UPDATES, r
                assert abs(r["final_cost"] - ONE_BLOCK_DEMO_COST) <= (
                    TOL_MODES_COST * ONE_BLOCK_DEMO_COST), r
            if preset == "sphere_accel":
                its, cost = JAX_ACCEL_DEMO["engine"]
                assert abs(r["iterations"] - its) <= ACCEL_UPDATES_SLACK, r
                assert abs(r["final_cost"] - cost) <= TOL_ACCEL_COST * cost, r
    _only(counts["exp_e2e"], **want)
    k1["exp_e2e"], k4["exp_e2e"] = want["k1"], want["k4"]
    # micro_bench: K1 on robot 0's mask at the three budgets; the prototype
    # has no kernel on its path
    k1["micro_bench"] = MICRO_K1_CALLS * len(res["micro_bench"]["rtr"])
    _only(counts["micro_bench"], k1=k1["micro_bench"])
    _only(counts["proto_chain_precond"])
    assert all(r["graph"] for r in res["micro_bench"]["looped_ms_per_op"].values())
    total_s = sum(secs.values())
    print(f"entry points: {total_s:.1f} s in all; K1 {k1}; K4 {k4}; K7 exp_e2e "
          f"{want['k7']}", flush=True)
    assert total_s <= ENTRY_POINTS_S, secs
    return {"k1": k1, "k4": k4, "k7": {"exp_e2e": want["k7"]}, "seconds": secs}


def _phase(name, fn, *args):
    t = time.time()
    out = fn(*args)
    print(f"phase {name}: {time.time() - t:.1f} s", flush=True)
    return out


def _kernel(name, source, replaces, launches, err, ms, plain_ms, bnd, **more):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_us": bnd[0] * 1e3, "bound_by": bnd[1],
            "library_ms": None, **more}


def main() -> int:
    measure_peaks.require_cuda("chip_smoke")
    card = measure_peaks.card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    ptxas = _phase("build", phase_build)
    max_err, k1_shapes = _phase("K1 vs plain", phase_compare)
    run_err, run_shapes = _phase("K2 vs plain", phase_compare_run)
    tick_err, tick_shapes = _phase("K3 vs plain", phase_compare_tick)
    window_err, window_shapes = _phase("K4 vs plain and K1", phase_compare_window)
    with tempfile.TemporaryDirectory() as tmp:
        _, engine_summary = _phase("engine main path", phase_main_path, tmp, "RoundRobin")
        launches, _ = _phase("Parallel main path", phase_main_path, tmp, "Parallel")
        window_launches, _, _ = _phase("large main path", phase_large_main_path, tmp)
        accel = _phase("accelerated main path", phase_accel_main_path, tmp)
        fleets = _phase("fleet main path", phase_fleet_main_path, tmp)
    fleet_err = _phase("fleet window", phase_fleet_window)
    _phase("fleet faults", phase_fleet_faults)
    _phase("fixed iterations", phase_fixed_iterations)
    _phase("accelerated fixed iterations", phase_accel_fixed_iterations)
    k7_err, k7_shape = _phase("K7 vs plain", phase_compare_extrapolate)
    k7 = _phase("K7 timing", phase_timing_extrapolate)
    cert = _phase("certificate", phase_certify)
    run_launches = _phase("fused main path", phase_fused_main_path, engine_summary)
    tick_launches, _, _ = _phase("async main path", phase_async_main_path)
    _phase("async fixed ticks", phase_async_fixed_ticks)
    _phase("async stop mid-chunk", phase_async_stop)
    _phase("gnc", phase_gnc)
    spmd_err = _phase("spmd K1/K2 vs plain on slot windows", phase_spmd_compare)
    spmd_main = _phase("spmd main path", phase_spmd_main_path)
    spmd_gnc = _phase("spmd gnc", phase_spmd_gnc)
    spmd_stretch = _phase("spmd stretches", phase_spmd_stretch)
    with tempfile.TemporaryDirectory() as tmp:
        spmd_multi = _phase("spmd two processes", phase_spmd_multiprocess, tmp)
    spmd_timing = _phase("spmd timing", phase_spmd_timing)
    _phase("large sweep", phase_large_sweep)
    k1, k1_robot = _phase("K1 timing", phase_timing)
    *k2, k2_call = _phase("K2 timing", phase_timing_run)
    *k3, tick_ms, k3_call = _phase("K3 timing", phase_timing_tick)
    _phase("mode timing", phase_timing_modes)
    _phase("async timing", phase_timing_async)
    *k4, k4_call, k1_window_ms, k1_window_call = _phase("K4 timing", phase_timing_window)
    gate = _phase("K4 vs K1 below the large world", phase_gate_sweep)
    chain_err = _phase("K5/K6 vs plain", phase_compare_chains)
    roof_counts, *cals, roof_row = _phase("roofline", phase_roofline)
    chains = _phase("K5/K6 timing", phase_timing_chains)
    # its traces of ~80k launches each are the largest of the run
    fleet_timing = _phase("fleet timing", phase_fleet_timing)
    rgd_err, rgd_shapes = _phase("K2 RGD vs plain on engine windows", phase_compare_rgd)
    engine_rgd = _phase("engine RGD main path", phase_engine_rgd)
    fused_rgd = _phase("fused RGD main path", phase_fused_rgd, engine_rgd)
    with tempfile.TemporaryDirectory() as tmp:
        obs = _phase("observability", phase_observability, tmp, engine_summary)
    k2_rgd = _phase("K2 RGD timing", phase_timing_rgd)
    with tempfile.TemporaryDirectory() as tmp:
        _phase("checkpoint dcp", phase_checkpoint_dcp, tmp, card)
    with tempfile.TemporaryDirectory() as tmp:
        bench_res = _phase("bench", phase_bench, tmp, roof_row)
    bench_launches = {k: r["launches"] for k, r in bench_res["routes"].items()}
    first_trace = _phase("roofline first trace", phase_roofline_first_trace)
    with tempfile.TemporaryDirectory() as tmp:
        entry = _phase("entry points", phase_entry_points, tmp)
    print(f"longest padded trace session: {profiling.longest_session_s:.2f} s", flush=True)
    print(json.dumps({"certificate": cert}))
    print(card)
    print(json.dumps({"kernels": [
        _kernel("rtr_block_solve", "dpgo_ros_tpu_torch/csrc/rtr_block.cu",
                "dpgo_ros_tpu/ops/fused_rtr.py:1092", launches, max_err, *k1[:3],
                ms_per_tcg=k1[3], call_ms=k1[4], robot_ms=k1_robot[0],
                robot_plain_ms=k1_robot[1], robot_bound_ms=k1_robot[2][0],
                robot_ms_per_tcg=k1_robot[3], robot_call_ms=k1_robot[4],
                accel_launches=accel["parallel"][0],
                spmd_launches=dict({k: v["k1"] for k, v in spmd_main.items()},
                                   gnc8=spmd_gnc["k1"]),
                spmd_slot_ms=spmd_timing["k1"][0], spmd_slot_plain_ms=spmd_timing["k1"][1],
                spmd_slot_bound_ms=spmd_timing["k1"][2][0],
                spmd_slot_call_ms=spmd_timing["k1_call_ms"],
                spmd_slot_shape=spmd_timing["shape"], spmd=spmd_main, spmd_gnc=spmd_gnc,
                spmd_two_processes=spmd_multi, spmd_profile=spmd_timing["profile"],
                spmd_slot_checks=spmd_err, entry_point_launches=entry["k1"],
                launch_shapes=k1_shapes, ptxas=ptxas[fused_rtr.SOURCE.stem]),
        _kernel("rtr_run_fused", "dpgo_ros_tpu_torch/csrc/rtr_run.cu",
                "dpgo_ros_tpu/ops/fused_rtr.py:1458", run_launches, run_err, *k2,
                call_ms=k2_call,
                spmd_launches={k: v["k2"] for k, v in spmd_stretch.items()},
                spmd_stretch=spmd_stretch, spmd_slot_ms=spmd_timing["k2"][0],
                spmd_slot_plain_ms=spmd_timing["k2"][1],
                spmd_slot_bound_ms=spmd_timing["k2"][2][0],
                engine_rgd_launches={k: v["k2"] for k, v in engine_rgd.items()},
                fused_rgd_launches={k: v["k2"] for k, v in fused_rgd.items()},
                engine_rgd=engine_rgd, fused_rgd=fused_rgd,
                rgd_robot_ms=k2_rgd[0], rgd_robot_plain_ms=k2_rgd[1],
                rgd_robot_bound_ms=k2_rgd[2][0], rgd_robot_bound_by=k2_rgd[2][1],
                rgd_robot_call_ms=k2_rgd[3], rgd_max_abs_err=rgd_err,
                rgd_launch_shapes=rgd_shapes,
                bench_launches={k: v["k2"] for k, v in bench_launches.items() if v["k2"]},
                launch_shapes=run_shapes,
                ptxas=ptxas[fused_rtr.RUN_SOURCE.stem]),
        _kernel("asapp_tick_fused", "dpgo_ros_tpu_torch/csrc/asapp_tick.cu",
                "dpgo_ros_tpu/ops/fused_asapp.py:200", tick_launches, tick_err, *k3,
                tick_ms=tick_ms, call_ms=k3_call, launch_shapes=tick_shapes,
                ptxas=ptxas[fused_rtr.TICK_SOURCE.stem]),
        _kernel("rtr_window_solve", "dpgo_ros_tpu_torch/csrc/rtr_window.cu",
                "dpgo_ros_tpu/ops/hbm_rtr.py:257", window_launches, window_err, *k4,
                launch_shapes=window_shapes, ptxas=ptxas[fused_rtr.WINDOW_SOURCE.stem],
                call_ms=k4_call, k1_window_ms=k1_window_ms,
                accel_launches={f: accel[f][0] for f in ("engine", "fused")},
                fleet_launches={d: f["k4"] for d, f in fleets.items()},
                fleet_window_max_abs_err=fleet_err, fleets=fleets,
                fleet_timing=fleet_timing,
                k1_window_call_ms=k1_window_call, observability=obs,
                bench_launches={k: v["k4"] for k, v in bench_launches.items() if v["k4"]},
                entry_point_launches=entry["k4"], first_trace=first_trace,
                k4_k1_ms_by_world={w: list(t) for w, t in gate.items()}),
        *(_kernel(name, "dpgo_ros_tpu_torch/csrc/peak_chains.cu", replaces,
                  roof_counts[k], chain_err[name], *chains[name][:3],
                  steps=CHAIN_TIMING_STEPS, tflops=chains[name][3] / 1e12,
                  unfused_bound_ms=chains[name][4],
                  calibrated_tflops=cal["fp32_attainable_flops"] / 1e12)
          for name, k, replaces, cal in (
              ("peak_chain", "k5", "scripts/measure_peaks.py:60", cals[0]),
              ("peak_chain_cml", "k6", "scripts/measure_peaks.py:139", cals[1]))),
        _kernel("nesterov_extrapolate", "dpgo_ros_tpu_torch/csrc/nesterov_extrapolate.cu",
                "none (XLA: dpgo_ros_tpu/parallel/rbcd.py:494-509)", accel["engine"][4],
                k7_err, *k7[:3], call_ms=k7[3], host_us=k7[4], plain_host_us=k7[5],
                accel_launches={f: accel[f][4] for f in accel},
                entry_point_launches=entry["k7"], launch_shapes=k7_shape),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
