#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (dpgo_ros_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the three kernels, K1 (csrc/rtr_block.cu), K2 (csrc/rtr_run.cu)
     and K3 (csrc/asapp_tick.cu), one nvcc per source started together;
     print ptxas's report;
  3. hold K1 against its plain PyTorch version on the card, on the
     2,500-pose 5-robot synthetic sphere (every robot mask and every
     Parallel colour union), on a 1,000-pose grid3d world (irregular loop
     closures) and on an SE(2) ring, from noisy states;
  4. hold K2 against its plain version on the sphere (10 RoundRobin steps,
     6 Parallel steps, a GNC exit on the cadence, 10 RGD steps) and on the
     SE(2) ring;
  5. hold K3 against its plain version on the sphere from a noisy state:
     K = 3, 20 chained ticks with one fixed delay table, 1 or 2 steps per
     tick, with and without the preconditioner (X, movement, ring buffer);
  6. drive the CLI main path (``--demo dpgo_demo --synthetic sphere
     --synthetic_n 2500 --device cuda``) in engine mode to its rel-change
     tolerance with the launch counters zeroed just before, and check cost
     decrease, K1 launches == block updates, export files and a finite ATE;
     then run 20 fixed iterations on the card (K1, fp32) and on the CPU
     (plain path, fp64) from one initial state and compare the histories;
  7. drive the same main path with ``--mode fused``: one K2 launch, no K1
     launch, the engine run's iterations and cost;
  8. drive the async main path (``--demo asapp_demo --synthetic sphere
     --synthetic_n 2500 --device cuda``) with the counters zeroed just
     before: one K3 launch per tick, cost decrease, final cost within 1 %
     of the JAX CLI's, finite ATE; then 50 ticks on the card (K3, fp32)
     and on the CPU (plain, fp64) from one state and one delay table;
  9. drive the GNC demo at full width (``--demo dpgo_gnc_demo --synthetic
     sphere --synthetic_n 2500 --synthetic_outlier_ratio 0.1``: 8 robots,
     245 planted outliers) in both modes: 3 weight rounds, K2 launches ==
     rounds + 1 (fused), K1 launches == block updates (engine), the modes'
     accept/reject sets agree, outlier recall no worse than the JAX CLI's;
 10. time K1 per solve, K2 per step and K3 per launch against their plain
     versions at these shapes (K3 also per whole tick, the ring write
     included), and the dpgo_demo solve phase of both modes and the
     asapp_demo solve phase.

The last stdout line is ``{"ok": true, "device": {...}}``; the line before
it is the kernels JSON (name, route, source, replaced TPU kernel, launches
in the main-path run, max abs error, ms per solve, step or tick of kernel
and plain version, the bound — the larger of the bytes the call must move
over the card's memory rate and its operations over the fp32 rate, counted
over the poses and edges each block solve or robot step needs, with which
of the two bounds it — and the library call's time, null: no single
PyTorch call computes these functions; K3 also its whole tick's ms), and
the line before that the card's name and power limit.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from dpgo_ros_tpu_torch.io.synthetic import generate_world
from dpgo_ros_tpu_torch.types import EdgeType, MeasurementBatch, PoseGraphData
from dpgo_ros_tpu_torch.utils.config import AgentConfig, InitMethod, UpdateRule
from dpgo_ros_tpu_torch import cli
from dpgo_ros_tpu_torch.models.local_solvers import RTRParams
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import fused_asapp, fused_rtr, quadratic, stiefel
from dpgo_ros_tpu_torch.parallel.asapp import ASAPPEngine
from dpgo_ros_tpu_torch.parallel.rbcd import (
    RBCDEngine,
    state_from_numpy,
    state_to_numpy,
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
# K3 vs plain over 20 chained fp32 ticks: X and the ring buffer within
# TOL_TICK_X of max |X|, the per-tick movement history within rel
# TOL_TICK_MOVED (sum orders differ; the ticks are contractive RGD steps)
TOL_TICK_X, TOL_TICK_MOVED = 1e-4, 1e-3
# the card's peaks for the bound (H100 SXM: HBM3 rate, fp32 outside the
# tensor cores)
HBM_BYTES_PER_S, FP32_FLOPS_PER_S = 3.35e12, 67e12


def require_cuda() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def phase_build() -> None:
    """Both kernels' libraries, one nvcc per source started together; the
    ptxas register, stack and spill report of each."""
    t = time.time()
    built = fused_rtr.build_all()
    print(f"build: {', '.join(p.name for p, _ in built)} in "
          f"{time.time() - t:.1f} s", flush=True)
    for path, log in built:
        for line in log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "stack")):
                print(f"  ptxas {path.stem}: " + line.strip())


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


def solve_cases():
    """(name, prob, X, mask, Pinv, offsets) for every comparison case."""
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
        masks = [(f"robot{k}", eng._masks[k]) for k in range(prob.num_robots)]
        masks += [(f"color{c}", eng._color_masks[c]) for c in range(eng.num_colors)]
        for mi, (mname, mask) in enumerate(masks):
            X = noisy_state(prob, gt, seed=100 * wi + mi)
            yield f"{name}/{mname}", prob, X, mask, Pinv, eng._offsets


def phase_compare() -> float:
    """Kernel vs plain on every case; returns the max abs X error."""
    worst = 0.0
    for name, prob, X, mask, Pinv, offs in solve_cases():
        Xk, sk = fused_rtr.rtr_solve_fused(X, mask, Pinv, prob.edges, DEMO_PARAMS, offs)
        Xp, sp = fused_rtr.rtr_solve_fused_ref(X, mask, Pinv, prob.edges, DEMO_PARAMS, offs)
        Xk = torch.where(mask > 0, Xk, X)
        Xp = torch.where(mask > 0, Xp, X)
        sk, sp = sk.double().cpu().numpy(), sp.double().cpu().numpy()
        err = float((Xk - Xp).abs().max())
        xrel = err / float(Xp.abs().max())
        f0rel = abs(sk[0] - sp[0]) / abs(sp[0])
        frel = abs(sk[1] - sp[1]) / abs(sp[1])
        worst = max(worst, err)
        print(
            f"compare {name}: TR {int(sk[4])}/{int(sp[4])} tCG {int(sk[5])}/"
            f"{int(sp[5])} f0 {sk[0]:.7g} rel {f0rel:.2e} f {sk[1]:.7g} rel "
            f"{frel:.2e} X rel {xrel:.2e} (max abs {err:.2e})", flush=True,
        )
        assert np.isfinite(sk).all(), f"{name}: non-finite stats {sk}"
        assert int(sk[4]) == int(sp[4]), f"{name}: TR iterations differ"
        assert f0rel <= TOL_F0 and frel <= TOL_F and xrel <= TOL_X, name
        n_r = prob.num_robots
        upd_k = sk[6 + n_r:6 + 2 * n_r]
        assert np.array_equal(upd_k, sp[6 + n_r:6 + 2 * n_r]), f"{name}: updated flags"
        assert np.allclose(sk[6:6 + n_r], sp[6:6 + n_r], rtol=1e-3, atol=1e-6), name
    return worst


def run_cases():
    """(name, prob, X, bank, sched, Pinv, adj, offsets, run) for every K2
    comparison case: the 2,500-pose 5-robot sphere from a noisy state
    (RoundRobin, Parallel, a GNC exit on the cadence, RGD steps) and the
    SE(2) ring."""
    worlds = [("sphere2500", *generate_world("sphere", n=2500, num_robots=5, seed=1)[:2]),
              ("se2-ring", *se2_world(1200, 4, seed=3))]
    base = dict(last_wu=0, gnc_pending=False, tol=0.0, gnc=False, inner=1,
                inner_tol=None, record=True, rgd_stepsize=0.0)
    for wi, (name, data, gt) in enumerate(worlds):
        prob = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device=DEV)
        X = noisy_state(prob, gt, seed=200 + wi)
        cases = [("roundrobin", UpdateRule.ROUND_ROBIN, 10, {}),
                 ("parallel", UpdateRule.PARALLEL, 6, {}),
                 ("gnc-exit", UpdateRule.ROUND_ROBIN, 10,
                  dict(gnc=True, gnc_pending=True, inner=3)),
                 ("rgd", UpdateRule.ROUND_ROBIN, 10, dict(rgd_stepsize=0.2))]
        if name == "se2-ring":
            cases = [("roundrobin", UpdateRule.ROUND_ROBIN, 4, {})]
        for cname, rule, steps, kw in cases:
            eng = RBCDEngine(prob, AgentConfig(update_rule=rule, dtype="float32"))
            bank, sched = eng.mask_bank_and_schedule(steps)
            run = dict(base, it0=0, it_cap=steps, **kw)
            yield (f"{name}/{cname}", prob, X, bank, sched,
                   eng._solver_cache(prob.edges), eng._adjf, eng._offsets, run)


def _run_pair(prob, X, bank, sched, Pinv, adj, offs, run, fn):
    rel0 = torch.full((prob.num_robots,), float("inf"), device=DEV)
    cost0 = quadratic.cost(X, prob.edges).reshape(1)
    kw = dict(adj=adj, rel0=rel0, cost0=cost0, offsets=offs, **run)
    return fn(X, bank, sched, Pinv, prob.edges, DEMO_PARAMS, **kw)


def phase_compare_run() -> float:
    """K2 vs its plain version on every run case; returns the max abs X
    error. Gates: the same exit iteration and steps, X within TOL_RUN_X of
    max |X|, rel change and history rows within rel TOL_RUN_REL, cost
    within rel TOL_RUN_COST."""
    worst = 0.0
    for name, prob, X, bank, sched, Pinv, adj, offs, run in run_cases():
        args = (prob, X, bank, sched, Pinv, adj, offs, run)
        Xk, relk, sk, hk = _run_pair(*args, fused_rtr.rtr_run_fused)
        Xp, relp, sp, hp = _run_pair(*args, fused_rtr.rtr_run_fused_ref)
        sk, sp = sk.double().cpu().numpy(), sp.double().cpu().numpy()
        err = float((Xk - Xp).abs().max())
        xrel = err / float(Xp.abs().max())
        rrel = _rel(relk, relp)
        hrel = _rel(hk, hp)
        crel = abs(sk[0] - sp[0]) / abs(sp[0])
        worst = max(worst, err)
        print(f"run {name}: it {int(sk[1])}/{int(sp[1])} steps {int(sk[2])}/"
              f"{int(sp[2])} tCG {int(sk[3])}/{int(sp[3])} cost {sk[0]:.7g} rel "
              f"{crel:.2e} X rel {xrel:.2e} (max abs {err:.2e}) rel-change rel "
              f"{rrel:.2e} history rel {hrel:.2e}", flush=True)
        assert np.isfinite(sk).all() and torch.isfinite(Xk).all(), name
        assert int(sk[1]) == int(sp[1]) and int(sk[2]) == int(sp[2]), name
        assert xrel <= TOL_RUN_X and rrel <= TOL_RUN_REL and hrel <= TOL_RUN_REL, name
        assert crel <= TOL_RUN_COST, name
        if run["gnc"]:
            assert int(sk[1]) == run["inner"], f"{name}: GNC exit at {int(sk[1])}"
    return worst


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


def phase_main_path(tmp: str):
    """The CLI main path on the card, counting kernel launches."""
    prefix = os.path.join(tmp, "demo")
    summary, extras, launches, run_launches = _counted_run(
        DPGO_DEMO + ["--output", prefix]
    )
    print("main path: " + json.dumps(summary), flush=True)
    print("main path timing_sec " + json.dumps(extras["timing_sec"]))
    print(f"main path: launches {launches} block updates "
          f"{extras['block_updates']} initial cost {extras['initial_cost']:.7g}")
    assert launches == extras["block_updates"] > 0 and run_launches == 0
    assert summary["final_cost"] < extras["initial_cost"]
    assert math.isfinite(summary["ate_vs_ground_truth"])
    for suffix in ["_global.g2o", ".html"] + [f"_robot{k}.tum" for k in range(5)]:
        assert os.path.getsize(prefix + suffix) > 0, suffix
    return launches, summary


def phase_fixed_iterations() -> None:
    """20 RoundRobin iterations (tol 0) from one initial state: card fp32
    kernel vs CPU fp64 plain path."""
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


def bound(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` at its memory rate or do ``flops`` at its fp32 rate,
    whichever is larger."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def edge_bytes(E: int, d: int) -> int:
    """Bytes of ``E`` edges' operands read once: src/dst (int32), R, t,
    κ_eff, τ_eff (fp32)."""
    return E * (8 + 4 * d * d + 4 * d + 8)


def block_work(prob: LiftedProblem, mask: np.ndarray):
    """(poses in the block, edges that touch it, separator poses: the poses
    outside it that those edges reach) for a boolean (n,) pose mask."""
    he = prob.host_edges
    src, dst = np.asarray(he.src), np.asarray(he.dst)
    touch = mask[src] | mask[dst]
    ends = np.concatenate([src[touch], dst[touch]])
    return int(mask.sum()), int(touch.sum()), np.unique(ends[~mask[ends]]).size


def solve_bytes(prob: LiftedProblem, nk: int, Ek: int, ns: int) -> int:
    """One block solve's operands read once and outputs written once: the
    block's poses and their P⁻¹, the separator poses, the block's edges;
    the block's poses and the stats row."""
    C, D = prob.r * (prob.d + 1), prob.d + 1
    return 4 * (2 * nk * C + ns * C + nk * D * D + 6 + 2 * prob.num_robots) + \
        edge_bytes(Ek, prob.d)


# Operation counts from the kernels' algebra (a multiply-add is 2): one
# pass of the linear edge map with its pull-index gather, per edge and row
# of r: residuals and both contribution rows, 4d² + 4d + 6, then 2 rows of
# d + 1 adds; per pose: tangent projection 4rd², preconditioned projection
# 2r(d+1)² + 4rd² + r(d+1), Newton–Schulz retraction 3rd + 20 (2rd² +
# rd(2d+1)).
def _edge_flops(E: int, r: int, d: int) -> float:
    return E * r * (4 * d * d + 4 * d + 6 + 2 * (d + 1))


def _pose_flops(r: int, d: int):
    C = r * (d + 1)
    proj = 4 * r * d * d
    prec = 2 * r * (d + 1) ** 2 + proj + C
    retract = 3 * r * d + 20 * (2 * r * d * d + r * d * (2 * d + 1))
    return proj, prec, retract, C


def rtr_flops(n: int, E: int, r: int, d: int, tr: int, tcg: int) -> float:
    """One RTR block solve with ``tr`` TR and ``tcg`` tCG iterations: the
    initial gradient and norm; per TR iteration the tCG set-up, the model
    decrease, the retraction of every pose, the trial gradient and the new
    norm; per tCG iteration the Hessian edge pass and the pose passes."""
    proj, prec, retract, C = _pose_flops(r, d)
    ep = _edge_flops(E, r, d)
    return (ep + n * (proj + 2 * C)
            + tr * (ep + n * (3 * proj + prec + 13 * C + retract))
            + tcg * (ep + n * (1.5 * proj + prec + 23 * C)))


def tick_flops(prob: LiftedProblem, steps: int, precond: bool) -> float:
    """One ASAPP tick: per robot and step, the edge pass over the edges
    that touch its block and the step on its own poses; the movement."""
    proj, prec, retract, C = _pose_flops(prob.r, prob.d)
    he, rof = prob.host_edges, np.asarray(prob.robot_of_pose)
    total = 0.0
    for k in range(prob.num_robots):
        Ek = int(np.sum((rof[he.src] == k) | (rof[he.dst] == k)))
        nk = int(np.sum(rof == k))
        per_pose = proj + C + retract + (prec + C if precond else 0)
        total += steps * (_edge_flops(Ek, prob.r, prob.d) + nk * per_pose) + nk * 3 * C
    return total


def tick_bytes(prob: LiftedProblem, precond: bool) -> int:
    """One tick's operands read once and outputs written once: every
    robot's own poses from X and its separator poses from the ring slot
    its delay selects, P⁻¹ (with the preconditioner), the delays, every
    edge once; X_new and the movement."""
    n, R, C = prob.n, prob.num_robots, prob.r * (prob.d + 1)
    rof = np.asarray(prob.robot_of_pose)
    stale = sum(block_work(prob, rof == k)[2] for k in range(R))
    pinv = n * (prob.d + 1) ** 2 if precond else 0
    return 4 * (2 * n * C + stale * C + pinv + 2 * R) + \
        edge_bytes(prob.edges.num_edges, prob.d)


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


def phase_timing():
    """Per-solve time of kernel and plain version on the sphere2500 robot
    masks, same inputs; returns (kernel ms, plain ms, bound (ms, by))."""
    cases = [c for c in solve_cases() if c[0].startswith("sphere2500/robot")]
    launches_before = fused_rtr.LAUNCHES

    def run_all(fn):
        def go():
            for _, prob, X, mask, Pinv, offs in cases:
                fn(X, mask, Pinv, prob.edges, DEMO_PARAMS, offs)
        return go

    k_ms = _time(run_all(fused_rtr.rtr_solve_fused), 4) / len(cases)
    p_ms = _time(run_all(fused_rtr.rtr_solve_fused_ref), 1) / len(cases)
    k2_ms = _time(run_all(fused_rtr.rtr_solve_fused), 4) / len(cases)
    stats = [fused_rtr.rtr_solve_fused(X, m, P, pr.edges, DEMO_PARAMS, o)[1]
             for _, pr, X, m, P, o in cases]
    fused_rtr.LAUNCHES = launches_before  # timing launches are not main path
    tcg = [int(st[5]) for st in stats]
    prob = cases[0][1]
    work = [block_work(prob, m.reshape(-1).cpu().numpy() > 0) for _, _, _, m, _, _ in cases]
    flops = np.mean([rtr_flops(nk, Ek, prob.r, prob.d, int(st[4]), int(st[5]))
                     for (nk, Ek, _), st in zip(work, stats)])
    nbytes = np.mean([solve_bytes(prob, *w) for w in work])
    bnd = bound(nbytes, flops)
    print(f"timing per solve (sphere2500 robot blocks, tCG/solve {tcg}): "
          f"kernel {k_ms:.3f} ms, {k2_ms:.3f} ms (second pass), plain {p_ms:.3f} ms; "
          f"bound {bnd[0] * 1e3:.4f} us by {bnd[1]} ({nbytes:.0f} B, {flops:.4g} flop; "
          f"per block: poses, edges, separator poses {work})")
    return min(k_ms, k2_ms), p_ms, bnd


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


def _counted_run(argv):
    """cli.run with every launch counter zeroed just before; returns
    (summary, extras, K1 launches, K2 launches); K3's count stays in
    ``fused_asapp.TICK_LAUNCHES``."""
    fused_rtr.LAUNCHES = fused_rtr.RUN_LAUNCHES = fused_asapp.TICK_LAUNCHES = 0
    summary, extras = cli.run(argv)
    return summary, extras, fused_rtr.LAUNCHES, fused_rtr.RUN_LAUNCHES


def phase_fused_main_path(engine_summary):
    """--mode fused on the dpgo_demo main path: one K2 launch, no K1."""
    summary, extras, k1, k2 = _counted_run(DPGO_DEMO + ["--mode", "fused"])
    print("fused main path: " + json.dumps(summary), flush=True)
    print("fused main path timing_sec " + json.dumps(extras["timing_sec"]))
    print(f"fused main path: K2 launches {k2}, K1 launches {k1}")
    assert k2 == 1 and k1 == 0, (k2, k1)
    assert abs(summary["iterations"] - engine_summary["iterations"]) <= 1
    assert abs(summary["final_cost"] - engine_summary["final_cost"]) <= (
        TOL_MODES_COST * abs(engine_summary["final_cost"]))
    assert math.isfinite(summary["ate_vs_ground_truth"])
    return k2


def phase_gnc():
    """The GNC demo at full width in both modes."""
    runs = {}
    for mode in ("engine", "fused"):
        t = time.time()
        summary, extras, k1, k2 = _counted_run(GNC_DEMO + ["--mode", mode])
        runs[mode] = (summary, extras)
        og = summary["outlier_ground_truth"]
        print(f"gnc {mode}: " + json.dumps(summary), flush=True)
        print(f"gnc {mode} timing_sec " + json.dumps(extras["timing_sec"]))
        print(f"gnc {mode}: weight rounds {extras['weight_rounds']}, K1 launches "
              f"{k1}, K2 launches {k2}, block updates {extras['block_updates']}, "
              f"{time.time() - t:.1f} s", flush=True)
        assert extras["weight_rounds"] == 3
        if mode == "fused":
            assert k2 == extras["weight_rounds"] + 1 and k1 == 0, (k2, k1)
        else:
            assert k1 == extras["block_updates"] and k2 == 0, (k1, k2)
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
    sphere case of phase 4 (same inputs); returns (kernel ms, plain ms)."""
    case = next(c for c in run_cases() if c[0] == "sphere2500/roundrobin")
    _, prob, X, bank, sched, Pinv, adj, offs, run = case
    steps = run["it_cap"]
    launches_before = fused_rtr.RUN_LAUNCHES
    go = lambda fn: (lambda: _run_pair(prob, X, bank, sched, Pinv, adj, offs, run, fn))
    k_ms = _time(go(fused_rtr.rtr_run_fused), 3) / steps
    p_ms = _time(go(fused_rtr.rtr_run_fused_ref), 1) / steps
    k2_ms = _time(go(fused_rtr.rtr_run_fused), 3) / steps
    tcg = int(go(fused_rtr.rtr_run_fused)()[2][3])
    fused_rtr.RUN_LAUNCHES = launches_before  # timing launches are not main path
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
          f"{k_ms:.3f} ms, {k2_ms:.3f} ms (second pass), plain {p_ms:.3f} ms; "
          f"bound {bnd[0] * 1e3:.4f} us by {bnd[1]} ({nbytes:.0f} B, {flops:.4g} flop)")
    return min(k_ms, k2_ms), p_ms, bnd


def phase_timing_modes():
    """Solve seconds of the dpgo_demo path, engine then fused then engine
    then fused, all warm."""
    out = {"engine": [], "fused": []}
    for mode in ("engine", "fused", "engine", "fused"):
        _, extras, _, _ = _counted_run(DPGO_DEMO + ["--mode", mode])
        out[mode].append(extras["timing_sec"]["solve"])
    print("dpgo_demo solve seconds (warm, engine / fused): "
          + json.dumps(out))
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
        Xn, m = fn(X, hist, eng._masks, eng._Pinv, eng.problem.edges, table[t],
                   eng.rgd.stepsize, eng.steps_per_tick, eng.rgd.use_preconditioner,
                   eng._offsets)
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
    (stepsize 5e-6: unpreconditioned steps need one below 1/‖Q‖)."""
    data, gt, _ = generate_world("sphere", n=2500, num_robots=5, seed=1)
    prob = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device=DEV)
    X0 = noisy_state(prob, gt, seed=300)
    hist0 = torch.stack([noisy_state(prob, gt, seed=301 + j) for j in range(4)])
    table = torch.randint(0, 4, (TICKS, 5), generator=torch.Generator().manual_seed(5),
                          dtype=torch.int32).to(DEV)
    for steps in (1, 2):
        for precond, gamma in ((True, 0.2), (False, 5e-6)):
            cfg = AgentConfig(num_robots=5, asynchronous=True, dtype="float32",
                              asynchronous_rate=100.0 * steps, RGD_stepsize=gamma,
                              RGD_use_preconditioner=precond, max_delayed_iterations=3)
            name = f"sphere2500/steps{steps}/{'precond' if precond else 'plain-rgd'}"
            yield name, ASAPPEngine(prob, cfg), X0, hist0, table


def phase_compare_tick() -> float:
    """K3 vs its plain version over TICKS chained ticks per case; returns
    the max abs X error. Gates: X and the ring buffer within TOL_TICK_X of
    max |X|, the movement history within rel TOL_TICK_MOVED."""
    worst = 0.0
    launches_before = fused_asapp.TICK_LAUNCHES
    for name, eng, X0, hist0, table in tick_cases():
        Xk, Hk, mk = _tick_chain(fused_asapp.asapp_tick_fused, eng, X0, hist0, table)
        Xp, Hp, mp = _tick_chain(fused_asapp.asapp_tick_fused_ref, eng, X0, hist0, table)
        scale = float(Xp.abs().max())
        err = float((Xk - Xp).abs().max())
        herr = float((Hk - Hp).abs().max())
        mrel = _rel(mk, mp)
        worst = max(worst, err)
        print(f"tick {name}: X rel {err / scale:.2e} (max abs {err:.2e}) ring rel "
              f"{herr / scale:.2e} movement rel {mrel:.2e} (last tick "
              f"{float(mp[-1].max()):.4g})", flush=True)
        assert torch.isfinite(Xk).all() and torch.isfinite(mk).all(), name
        assert err <= TOL_TICK_X * scale and herr <= TOL_TICK_X * scale, name
        assert mrel <= TOL_TICK_MOVED, name
    assert fused_asapp.TICK_LAUNCHES == launches_before + 4 * TICKS
    fused_asapp.TICK_LAUNCHES = launches_before  # comparison launches
    return worst


def phase_async_main_path():
    """The async main path on the card, counting K3 launches."""
    summary, extras, k1, k2 = _counted_run(ASAPP_DEMO)
    launches = fused_asapp.TICK_LAUNCHES
    print("async main path: " + json.dumps(summary), flush=True)
    print("async main path timing_sec " + json.dumps(extras["timing_sec"]))
    print(f"async main path: K3 launches {launches}, ticks {summary['ticks']}, "
          f"K1/K2 launches {k1}/{k2}, initial cost {extras['initial_cost']:.7g}, "
          f"ATE {extras['ate_vs_ground_truth']:.6g}, JAX CLI cost {JAX_ASAPP_COST}")
    assert launches == summary["ticks"] > 0 and k1 == k2 == 0
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
    launches_before = fused_asapp.TICK_LAUNCHES
    _, i64 = ASAPPEngine(p64, AgentConfig(dtype="float64", **base)).run(
        X0, num_ticks=50, chunk=1, delays=table)
    _, i32 = ASAPPEngine(p32, AgentConfig(dtype="float32", **base)).run(
        X0.to(device=DEV, dtype=torch.float32), num_ticks=50, chunk=1, delays=table)
    assert fused_asapp.TICK_LAUNCHES == launches_before + 50
    fused_asapp.TICK_LAUNCHES = launches_before  # not the main path
    h64, h32 = np.array(i64["costs"]), np.array(i32["costs"])
    rel = float(np.max(np.abs(h32 - h64) / np.abs(h64)))
    print(f"fixed 50 ticks: cost {h64[0]:.7g} -> {h64[-1]:.7g} (CPU fp64), "
          f"{h32[-1]:.7g} (card fp32), max rel history deviation {rel:.2e}")
    assert len(h64) == len(h32) == 51 and rel <= TOL_HIST


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
    """K3 ms per launch and its plain version's per call, over the
    TICKS-tick chain of the asapp_demo case (1 step, preconditioned), and
    the whole tick's (ring write and glue included); returns (kernel ms,
    plain ms, bound (ms, by), tick ms)."""
    name, eng, X0, hist0, table = next(iter(tick_cases()))
    launches_before = fused_asapp.TICK_LAUNCHES
    k3, ref = fused_asapp.asapp_tick_fused, fused_asapp.asapp_tick_fused_ref
    k_ms = _time_calls(k3, eng, X0, hist0, table, 5)
    p_ms = _time_calls(ref, eng, X0, hist0, table, 1)
    k2_ms = _time_calls(k3, eng, X0, hist0, table, 5)
    tick_ms = _time(lambda: _tick_chain(k3, eng, X0, hist0, table), 5) / TICKS
    fused_asapp.TICK_LAUNCHES = launches_before  # timing launches are not main path
    prob, precond = eng.problem, eng.rgd.use_preconditioner
    nbytes = tick_bytes(prob, precond)
    flops = tick_flops(prob, eng.steps_per_tick, precond)
    bnd = bound(nbytes, flops)
    print(f"timing per tick ({name}, {TICKS} ticks): K3 {k_ms:.4f} ms per launch, "
          f"{k2_ms:.4f} ms (second pass), plain {p_ms:.3f} ms per call; whole tick "
          f"with the ring write {tick_ms:.4f} ms; bound {bnd[0] * 1e3:.4f} us by "
          f"{bnd[1]} ({nbytes:.0f} B, {flops:.4g} flop)")
    return min(k_ms, k2_ms), p_ms, bnd, tick_ms


def phase_timing_async():
    """Solve seconds of the asapp_demo path, twice, warm."""
    out = []
    for _ in range(2):
        _, extras, _, _ = _counted_run(ASAPP_DEMO)
        t = extras["timing_sec"]
        out.append(t["solve"])
        print(f"asapp_demo solve {t['solve']:.4f} s over {t['ticks']} ticks "
              f"({1e3 * t['solve'] / t['ticks']:.4f} ms per tick), init "
              f"{t['init']:.3f} s", flush=True)
    return out


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
    require_cuda()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    _phase("build", phase_build)
    max_err = _phase("K1 vs plain", phase_compare)
    run_err = _phase("K2 vs plain", phase_compare_run)
    tick_err = _phase("K3 vs plain", phase_compare_tick)
    with tempfile.TemporaryDirectory() as tmp:
        launches, engine_summary = _phase("engine main path", phase_main_path, tmp)
    _phase("fixed iterations", phase_fixed_iterations)
    run_launches = _phase("fused main path", phase_fused_main_path, engine_summary)
    tick_launches, _, _ = _phase("async main path", phase_async_main_path)
    _phase("async fixed ticks", phase_async_fixed_ticks)
    _phase("gnc", phase_gnc)
    k1 = _phase("K1 timing", phase_timing)
    k2 = _phase("K2 timing", phase_timing_run)
    *k3, tick_ms = _phase("K3 timing", phase_timing_tick)
    _phase("mode timing", phase_timing_modes)
    _phase("async timing", phase_timing_async)
    print(card)
    print(json.dumps({"kernels": [
        _kernel("rtr_block_solve", "dpgo_ros_tpu_torch/csrc/rtr_block.cu",
                "dpgo_ros_tpu/ops/fused_rtr.py:1092", launches, max_err, *k1),
        _kernel("rtr_run_fused", "dpgo_ros_tpu_torch/csrc/rtr_run.cu",
                "dpgo_ros_tpu/ops/fused_rtr.py:1458", run_launches, run_err, *k2),
        _kernel("asapp_tick_fused", "dpgo_ros_tpu_torch/csrc/asapp_tick.cu",
                "dpgo_ros_tpu/ops/fused_asapp.py:200", tick_launches, tick_err, *k3,
                tick_ms=tick_ms),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
