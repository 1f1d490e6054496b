"""Roofline of the port's block-solve kernels on the card.

Port of ``scripts/roofline.py``. Run from the repository root on a machine
with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.roofline [--problems a,b] [--out PATH]

1. Calibrates an attainable fp32 rate with the two witnesses of
   ``measure_peaks`` (K5, K6) and holds their agreement to (0.5, 2).
2. Builds, for each problem, the state the sweeps start from, as the JAX
   script's ``_init_state`` does: chordal initialization, anchored, lifted
   through a YLift drawn from a seeded ``torch.Generator``, P⁻¹ damped by
   1e-2; for parking-garage after 12 reference-budget solves (its chordal
   state meets negative curvature in the first tCG iteration).
3. Sweeps two block-solve kernels under forced budgets
   (:func:`forced_params`: κ = 0, radius 1e8, gradnorm tol 0, so a solve
   runs exactly 3·K tCG iterations) over K ∈ :data:`KS`: K1 under the
   all-ones mask (the JAX script's mask; its window is the whole world,
   every robot's block and no separators) and K4 on robot 0's window (the
   solve the RoundRobin main path launches). The time per solve is the
   slope over two counts of chained solves (X carried through; the card's
   busy time in a profiler trace of the chain), as the median and spread
   of several estimates; the tCG count
   of every forced solve is read back and must be 3·K. The sweep splits
   the time per solve into a per-tCG slope and an intercept (the fixed
   cost plus 3 × retraction and trial gradient). One reference-budget
   solve from the same state (3 × 50 tCG at most, gradnorm tol 0.5) shows
   how much of a real solve is tCG.
4. Sets the slope against floors: :func:`tcg_flops` over the solve's least
   work (its block's poses and the edges that touch them) at the card's
   67 TFLOP/s fp32 and at K5's measured rate; and the solve's bytes, each
   operand read once (:func:`solve_bytes`), at 3.35 TB/s.
5. Times one GNC weight round on the tunnels problem.

The problems are the JAX script's five, each read through ``io.datasets``
when its file exists and otherwise built by a named synthetic stand-in
(:data:`STAND_INS`; the row records it), and the port's large world
(50,000 poses, 16 robots, K4 only: a forced K1 sweep there would take
minutes). Prints progress on stderr and one JSON line on stdout; ``--out``
writes the same object to a file (never to the repository's
``ROOFLINE.json``, the TPU's record). Exits nonzero without a card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from dpgo_ros_tpu_torch.io import datasets
from dpgo_ros_tpu_torch.io.synthetic import generate_world
from dpgo_ros_tpu_torch.models.local_solvers import RTRParams
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import (chordal, fused_asapp, fused_rtr, hbm_rtr, peak_chains,
                                    quadratic, rounding, stiefel)
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu_torch.scripts import measure_peaks
from dpgo_ros_tpu_torch.utils.config import AgentConfig, RobustCostType, UpdateRule
# the padded trace lives in utils/profiling.py; scripts/trace_pad.py and
# chip_smoke.py reach it through this module
from dpgo_ros_tpu_torch.utils.profiling import chrome_events, padded_profile
from dpgo_ros_tpu_torch.utils.work import (
    FP32_FLOPS_PER_S,
    HBM_BYTES_PER_S,
    block_work,
    solve_bytes,
    tcg_flops,
)

KS = (1, 10, 50)  # forced tCG budgets per TR iteration
# chained solves per timing (two counts; the slope between them is the time
# per solve) and slope estimates per budget; device busy time has no
# dispatch floor to beat, so these are far below the JAX script's (8, 136)
# and 6
REPS, N_EST = (2, 6), 5
REF_PARAMS = RTRParams(max_iterations=3, max_tcg_iterations=50, gradnorm_tol=0.5)
# name: (robots, kernels swept, reference-budget solves before the sweep)
PROBLEMS = {
    "sphere2500": (5, ("k1", "k4"), 0),
    "cubicle": (2, ("k1", "k4"), 0),
    "torus3D": (2, ("k1", "k4"), 0),
    "parking-garage": (2, ("k1", "k4"), 12),
    "tunnels": (8, ("k1", "k4"), 12),
    "sphere50k": (16, ("k4",), 0),
}
# generate_world arguments of each problem's stand-in, used while its data
# file is not in the repository (the large world has none)
STAND_INS = {
    # the dpgo_demo world
    "sphere2500": dict(kind="sphere", n=2500, num_robots=5, seed=42),
    # 5,832 poses for cubicle's 5,750
    "cubicle": dict(kind="grid3d", grid_shape=(18, 18, 18), num_robots=2, seed=42),
    # 5,000 poses, as torus3D
    "torus3D": dict(kind="sphere", n=5000, num_robots=2, seed=42),
    # 1,728 poses for parking-garage's 1,661
    "parking-garage": dict(kind="grid3d", grid_shape=(12, 12, 12), num_robots=2, seed=42),
    # the GNC demo world: 245 planted outlier loop closures
    "tunnels": dict(kind="sphere", n=2500, num_robots=8, seed=42, outlier_ratio=0.1),
    # the port's large world (chip_smoke.py, profile_main_path.py)
    "sphere50k": dict(kind="sphere", n=50000, num_robots=16, seed=42),
    # the JAX package's two small grids (io/datasets.py: 9 poses / 11 edges,
    # 125 / 297; these have 10 and 244 edges), for the measurement scripts
    # of this directory only: they are no roofline problem
    "tinyGrid3D": dict(kind="grid3d", grid_shape=(3, 3, 1), num_robots=1, seed=42),
    "smallGrid3D": dict(kind="grid3d", grid_shape=(5, 5, 5), num_robots=2, seed=42),
}
ROOFLINE_JSON = Path(__file__).resolve().parents[2] / "ROOFLINE.json"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forced_params(K: int) -> RTRParams:
    """RTR params that execute 3·K tCG iterations: κ = 0 makes the residual
    target 0 (tCG never converges), radius 1e8 never hits the boundary,
    gradnorm tol 0 never stops the outer loop early. The JAX script's."""
    return RTRParams(
        max_iterations=3,
        max_tcg_iterations=K,
        gradnorm_tol=0.0,
        initial_radius=1e8,
        max_radius=1e8,
        tcg_kappa=0.0,
        tcg_theta=1.0,
    )


def load_world(name: str, num_robots: Optional[int] = None, balance: str = "poses"):
    """(data, ground truth (n, 3, 4), planted outlier mask, stand-in
    generator arguments) of a world of :data:`STAND_INS` split among
    ``num_robots`` robots (default its entry's): its file through
    ``io.datasets`` when it exists (then the last three are None), else its
    stand-in, whose arguments then carry ``num_robots``. ``balance``
    "work" cuts the contiguous blocks by work (``io/partition.py``) rather
    than by pose count; the tunnels file's per-robot split is its own."""
    robots = num_robots or STAND_INS[name]["num_robots"]
    if name == "tunnels":
        if all(os.path.exists(p) for p in datasets.tunnels_paths(num_robots=robots)):
            return datasets.load_tunnels(num_robots=robots), None, None, None
    elif name in datasets.G2O_DATASETS and os.path.exists(datasets.dataset_path(name)):
        return (datasets.load_g2o_dataset(name, num_robots=robots, balance=balance),
                None, None, None)
    args = dict(STAND_INS[name], num_robots=robots)
    if balance != "poses":
        args["balance"] = balance
    return (*generate_world(**args), args)


def load_data(name: str):
    """(data, stand-in generator arguments or None) of a problem: its file
    through ``io.datasets`` when it exists, else its stand-in."""
    data, _, _, stand_in = load_world(name, PROBLEMS[name][0])
    return data, stand_in


def init_state(prob: LiftedProblem, presteps: int = 0):
    """(X, P⁻¹) the sweeps start from: the chordal initialization,
    anchored and lifted, and the damped block-Jacobi inverse; with
    ``presteps`` > 0, X after that many reference-budget K1 solves under
    the all-ones mask (a mid-solve state)."""
    T0 = rounding.anchor_to_first_pose(chordal.chordal_initialization(prob.edges, prob.n))
    Y = stiefel.random_lifting_matrix(torch.Generator().manual_seed(0), prob.r, prob.d,
                                      dtype=prob.dtype, device=prob.device)
    X = stiefel.lift_trajectory(T0, Y).contiguous()
    Pinv = quadratic.precond_inverse(
        quadratic.precond_blocks(prob.edges, prob.n, 1e-2)).contiguous()
    ones = torch.ones(prob.n, dtype=prob.dtype, device=prob.device)
    if presteps:
        w = hbm_rtr.prepare_mask_window(prob, ones)
    for _ in range(presteps):
        X, _ = fused_rtr.rtr_solve_fused(X, ones, Pinv, prob.edges, REF_PARAMS,
                                         windows=w, row=0)
    return X, Pinv


def solvers(prob: LiftedProblem, Pinv: torch.Tensor, kernels):
    """{kernel: (solve(X, params) → (X_new, stats), boolean block mask)}:
    K1 under the all-ones mask (on the all-robots window), K4 on robot 0's
    window."""
    out = {}
    if "k1" in kernels:
        ones = torch.ones(prob.n, dtype=prob.dtype, device=prob.device)
        w1 = hbm_rtr.prepare_mask_window(prob, ones)
        out["k1"] = (lambda X, p: fused_rtr.rtr_solve_fused(X, ones, Pinv, prob.edges, p,
                                                            windows=w1, row=0),
                     np.ones(prob.n, bool))
    if "k4" in kernels:
        w = hbm_rtr.prepare_windows(prob)
        out["k4"] = (lambda X, p: hbm_rtr.rtr_solve_hbm(X, 0, Pinv, prob.edges, p, w),
                     np.asarray(prob.robot_of_pose) == 0)
    return out


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_us(intervals) -> float:
    """Length of the union of the [ts, ts + dur) ``intervals``, in µs."""
    total, end = 0.0, -float("inf")
    for ts, dur in sorted(intervals):
        if ts + dur > end:
            total += ts + dur - max(ts, end)
            end = ts + dur
    return total


def launches() -> int:
    """Every kernel wrapper's launches so far (K1–K6 counters)."""
    return (fused_rtr.LAUNCHES + fused_rtr.RUN_LAUNCHES + fused_asapp.TICK_LAUNCHES
            + hbm_rtr.LAUNCHES + peak_chains.LAUNCHES + peak_chains.CML_LAUNCHES)


def session_busy_ms(events, launched: int = 0) -> float:
    """The card's busy milliseconds in the events of a torch.profiler trace:
    the union of its kernel, memcpy and memset intervals. Raises on a trace
    that cannot be read so: one holding fewer kernel intervals than the
    ``launched`` wrapper launches of the traced call (an empty or cut
    trace), or a device interval that none of the session's CUDA runtime
    or driver calls launched (by correlation id: another session's record;
    a trace without correlation ids is taken whole)."""
    calls = {e["args"]["correlation"] for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    kernels = sum(e["cat"] == "kernel" for e in dev)
    if kernels < launched:
        raise RuntimeError(f"the trace holds {kernels} kernel intervals for {launched} "
                           "kernel launches")
    foreign = [e for e in dev if calls and e.get("args", {}).get("correlation") not in calls]
    if foreign:
        raise RuntimeError(f"{len(foreign)} of {len(dev)} device intervals in the trace "
                           "were not launched in the traced session")
    return busy_us([(e["ts"], e["dur"]) for e in dev]) / 1e3


def _device_ms(fn) -> float:
    """Device milliseconds of ``fn()``: the card's busy time in a padded
    torch.profiler trace of the call (:func:`session_busy_ms`, which holds
    the trace to the launches the call made). CUDA events around the call
    would also count the card's idle gaps while the host works — K1's
    wrapper reads its mask check back on every call — and the host's time
    moves from call to call."""
    before = launches()
    with padded_profile() as prof:
        fn()
    return session_busy_ms(chrome_events(prof), launches() - before)


def solve_time(solve, X0, params: RTRParams, reps=REPS, n_est=N_EST):
    """Seconds per solve as the median of ``n_est`` slopes between chains
    of reps[0] and reps[1] solves from X0 (X carried through), after one
    warm chain of each; returns (median, std, stats of every solve run)."""
    stats = []

    def chain(R: int) -> float:
        def go():
            X = X0
            for _ in range(R):
                X, s = solve(X, params)
                stats.append(s)
        return _device_ms(go)

    r1, r2 = reps
    chain(r1)
    chain(r2)
    est = []
    for _ in range(n_est):
        t1 = chain(r1)
        t2 = chain(r2)
        est.append((t2 - t1) / (r2 - r1) * 1e-3)
    return float(np.median(est)), float(np.std(est)), torch.stack(stats).double().cpu()


def fit(times, stds, ks=KS):
    """(slope s per tCG, its std, intercept s per solve, valid) from the
    forced times per K (3 TR iterations each). Valid, as the JAX script
    rules: times increase with K and are positive, and the slope is above
    5 % of the largest budget's time per tCG and above twice its std."""
    lo, hi = ks[0], ks[-1]
    slope = (times[hi] - times[lo]) / (3 * (hi - lo))
    slope_std = math.hypot(stds[hi], stds[lo]) / (3 * (hi - lo))
    intercept = times[lo] - 3 * lo * slope
    valid = (
        times[lo] > 0
        and all(times[b] > times[a] for a, b in zip(ks[:-1], ks[1:]))
        and slope > 0.05 * (times[hi] / (3 * hi))
        and slope > 2.0 * slope_std
    )
    return slope, slope_std, intercept, bool(valid)


def sweep(prob: LiftedProblem, solve, block: np.ndarray, X0, rate, reps=REPS,
          n_est=N_EST, ks=KS) -> dict:
    """One kernel's row: the forced sweep, its fit, the tCG counts, the
    reference-budget solve and the floors (``rate``: K5's measured fp32
    rate or None)."""
    times, stds, tcg = {}, {}, {}
    for K in ks:
        times[K], stds[K], st = solve_time(solve, X0, forced_params(K), reps, n_est)
        tcg[K] = st[:, fused_rtr.S_TCG].long().tolist()
        log(f"  forced 3x{K} tCG: {times[K] * 1e3:.4f} +- {stds[K] * 1e3:.4f} ms "
            f"per solve, tCG per solve {sorted(set(tcg[K]))}")
    slope, slope_std, intercept, valid = fit(times, stds, ks)
    off = {K: sorted(set(c)) for K, c in tcg.items() if any(v != 3 * K for v in c)}
    # one reference-budget solve from X0 (chained ones would find X solved)
    ref_s, ref_sd, ref = solve_time(solve, X0, REF_PARAMS, (0, 1), n_est)
    ref_tcg = int(ref[-1, fused_rtr.S_TCG])
    nk, Ek, ns = block_work(prob, block)
    flops = tcg_flops(nk, Ek, prob.r, prob.d)
    floor = flops / FP32_FLOPS_PER_S
    floor_att = flops / rate if rate else None
    ok = valid and not off
    reasons = []
    if off:
        reasons.append(f"forced solves ran other tCG counts than 3·K {off}: tCG met "
                       "negative curvature at this state")
    if not valid:
        reasons.append("forced-budget sweep unresolved: the times do not rise with K or "
                       "the slope did not clear 5 % of the K = "
                       f"{ks[-1]} time per tCG or its 2-sigma error bar")
    return {
        "block": {"poses": nk, "edges": Ek, "separators": ns},
        "ks": list(ks), "reps": list(reps), "n_est": n_est,
        "tcg_per_forced_solve": {str(K): sorted(set(c)) for K, c in tcg.items()},
        "tcg_exact": not off,
        "slope_valid": ok,
        "per_tcg_iter_measured_s": slope,
        "per_tcg_iter_std_s": slope_std,
        "per_solve_intercept_s": intercept,
        "forced_times_s": {str(K): times[K] for K in ks},
        "forced_times_std_s": {str(K): stds[K] for K in ks},
        "bench_budget_solve_s": ref_s,
        "bench_budget_solve_std_s": ref_sd,
        "bench_budget_tcg_per_solve": ref_tcg,
        # the share of a reference-budget solve that its tCG iterations take
        "bench_budget_tcg_share": ref_tcg * slope / ref_s if ok else None,
        "tcg_flops": flops,
        "per_tcg_floor_s": floor,
        "per_tcg_floor_attainable_s": floor_att,
        "hbm_oneshot_s": solve_bytes(prob, nk, Ek, ns, stats=int(ref.shape[1]))
        / HBM_BYTES_PER_S,
        "fraction_of_peak": floor / slope if ok else None,
        "fraction_of_attainable": floor_att / slope if ok and floor_att else None,
        **({"slope_invalid_reason": "; ".join(reasons)} if reasons else {}),
    }


def weight_round_s(prob: LiftedProblem) -> float:
    """Least host seconds (synchronized) of one GNC weight round
    (``RBCDEngine._weight_update_impl``) over 5, after a warm one."""
    cfg = AgentConfig(num_robots=prob.num_robots, robust_cost_type=RobustCostType.GNC_TLS,
                      GNC_use_probability=False, GNC_barc=3.0, dtype="float32",
                      update_rule=UpdateRule.ROUND_ROBIN)  # the round ignores the rule
    eng = RBCDEngine(prob, cfg)
    st = eng.initialize()
    eng._weight_update_impl(st)
    torch.cuda.synchronize()
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng._weight_update_impl(st)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def problem_row(name: str, rate, reps=REPS, n_est=N_EST, ks=KS, device="cuda") -> dict:
    """The row of one problem: its source, its sweep state and one sweep
    per kernel (and, for tunnels, the GNC weight round)."""
    robots, kernels, presteps = PROBLEMS[name]
    data, stand_in = load_data(name)
    prob = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device=device)
    log(f"{name}: {prob.n} poses, {prob.edges.num_edges} edges, {robots} robots, "
        + (f"stand-in generate_world({stand_in})" if stand_in else "dataset file"))
    X0, Pinv = init_state(prob, presteps)
    row = {
        "num_robots": robots, "poses": prob.n, "edges": prob.edges.num_edges,
        "stand_in": stand_in,
        "sweep_state": (f"mid-solve ({presteps} ref-budget presteps)" if presteps
                        else "chordal"),
    }
    for k, (solve, block) in solvers(prob, Pinv, kernels).items():
        log(f" {k} ({'all-ones mask' if k == 'k1' else 'robot 0 window'}):")
        r = row[k] = sweep(prob, solve, block, X0, rate, reps, n_est, ks)
        if r["slope_valid"]:
            log(f"  slope {r['per_tcg_iter_measured_s'] * 1e6:.3f} +- "
                f"{r['per_tcg_iter_std_s'] * 1e6:.3f} us per tCG, intercept "
                f"{r['per_solve_intercept_s'] * 1e3:.4f} ms; reference budget "
                f"{r['bench_budget_solve_s'] * 1e3:.4f} ms at "
                f"{r['bench_budget_tcg_per_solve']} tCG (tCG share "
                f"{r['bench_budget_tcg_share']:.3f}); floor {r['per_tcg_floor_s'] * 1e6:.4f}"
                f" us ({r['fraction_of_peak']:.3g} of the slope)")
        else:
            log(f"  slope INVALID: {r['slope_invalid_reason']}")
    if name == "tunnels":
        row["gnc_weight_round_s"] = weight_round_s(prob)
        log(f" GNC weight round {row['gnc_weight_round_s'] * 1e3:.3f} ms")
    return row


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--problems", default=",".join(PROBLEMS),
                   help=f"comma-separated subset of {','.join(PROBLEMS)}")
    p.add_argument("--out", help="also write the JSON object here")
    a = p.parse_args(argv)
    names = [s for s in a.problems.split(",") if s]
    unknown = [s for s in names if s not in PROBLEMS]
    if unknown or not names:
        p.error(f"unknown problems {unknown}; choose from {','.join(PROBLEMS)}")
    if a.out and Path(a.out).resolve() == ROOFLINE_JSON:
        p.error("--out must not be the repository's ROOFLINE.json (the TPU's record)")
    measure_peaks.require_cuda("roofline")
    card = measure_peaks.card()
    log(f"card: {card}")
    cal = measure_peaks.measure_attainable()
    cal2 = measure_peaks.measure_cml()
    ratio, agree = measure_peaks.agreement(cal, cal2)
    rate = cal["fp32_attainable_flops"]
    log(f"fp32 attainable: K5 {cal['fp32_attainable_flops']}, K6 "
        f"{cal2['fp32_attainable_flops']} flop/s, agreement {ratio}")
    out = {
        "card": card,
        "fp32_peak_flops": FP32_FLOPS_PER_S,
        "hbm_peak_bytes_per_s": HBM_BYTES_PER_S,
        "fp32_attainable_calibration": cal,
        "fp32_cml_calibration": cal2,
        "witness_agreement_ratio": ratio,
        "two_witness_valid": agree,
        "rows": {name: problem_row(name, rate) for name in names},
    }
    line = json.dumps(out)
    print(line)
    if a.out:
        Path(a.out).write_text(line + "\n")
    return out


if __name__ == "__main__":
    main()
