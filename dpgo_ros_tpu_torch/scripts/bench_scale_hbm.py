"""Large-world scale bench of the windowed block solve (K4), with K1 on the
same windows beside it.

Port of ``scripts/bench_scale_hbm.py``. Run from the repository root on a
machine with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.bench_scale_hbm [--out PATH]

Worlds: ``generate_world("sphere", n, robots, rot_noise 0.01, trans_noise
0.05, seed 0)`` at the JAX script's sizes and robot counts (n = 2,500 /
25,000 / 30,000 / 50,000 with 5 / 10 / 12 / 16 robots; ``--sizes`` cuts
them for tests), Odometry init, RTR 3 × 50, gradnorm tol 0.5, fp32. The
engine's initial state and block-Jacobi inverse feed ``--k_solves``
chained block solves (solve i+1 consumes solve i's X, robots in turn: a
real RoundRobin sweep, no identical re-execution), one synchronization at
the end: K4 (``hbm_rtr.rtr_solve_hbm`` on each robot's window) on every
size, and K1 (``fused_rtr.rtr_solve_fused`` on the same robot windows) on
the sizes where the JAX script compared its VMEM kernel (2,500 and
25,000). Per kernel: ms and tCG iterations per solve (the kernels' own
counters) and solves per second.

The JAX script caught a failed size and went on; here a failure exits
nonzero. Prints progress on stderr and one JSON line on stdout; never
writes the root ``HBM_SCALE_r05.json`` (the TPU's record).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from dpgo_ros_tpu_torch.io.synthetic import generate_world
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import fused_rtr, hbm_rtr
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu_torch.scripts import common
from dpgo_ros_tpu_torch.scripts.common import log
from dpgo_ros_tpu_torch.utils.config import AgentConfig, InitMethod, UpdateRule

K_SOLVES = 40
# (poses, robots, K1 beside K4): the JAX script's rows
SIZES = ((2500, 5, True), (25000, 10, True), (30000, 12, False), (50000, 16, False))


def setup(n: int, num_robots: int, device, dtype):
    """(problem, engine, initial X, P⁻¹) of the world of ``n`` poses."""
    data, _, _ = generate_world(
        "sphere", n=n, num_robots=num_robots, rot_noise=0.01,
        trans_noise=0.05, seed=0,
    )
    prob = LiftedProblem.from_data(data, r=5, dtype=dtype, device=device)
    cfg = AgentConfig(
        num_robots=num_robots,
        update_rule=UpdateRule.ROUND_ROBIN,
        local_initialization_method=InitMethod.ODOMETRY,
        RTR_iterations=3,
        RTR_tCG_iterations=50,
        RTR_gradnorm_tol=0.5,
        dtype="float64" if dtype == torch.float64 else "float32",
    )
    eng = RBCDEngine(prob, cfg)
    st = eng.initialize()
    return prob, eng, st.X, eng._solver_cache(eng._edges(st.weights))


def chain(run_one, X, R: int, k: int, device):
    """k chained solves sweeping robots round-robin; one sync at the end."""
    stats = []
    common.sync(device)
    t0 = time.perf_counter()
    for i in range(k):
        X, s = run_one(X, i % R)
        stats.append(s)
    common.sync(device)
    return time.perf_counter() - t0, X, stats


def timed(name: str, run_one, X0, R: int, k: int, device) -> dict:
    """One kernel's figures over a warm solve and a k-solve chain."""
    run_one(X0, 0)
    before = common.counts()
    dt, _, stats = chain(run_one, X0, R, k, device)
    launches = common.launched(before)
    tcg = [int(s[fused_rtr.S_TCG]) for s in stats]
    return {
        f"{name}_ms_per_solve": dt / k * 1e3,
        f"{name}_tcg_per_solve": float(np.mean(tcg)),
        f"{name}_tcg_per_solve_min": min(tcg),
        f"{name}_tcg_per_solve_max": max(tcg),
        f"{name}_solves_per_sec": k / dt,
        f"{name}_launches": launches,
    }


def bench_one(n: int, num_robots: int, compare_k1: bool, k_solves: int, device,
              dtype) -> dict:
    prob, eng, X0, Pinv = setup(n, num_robots, device, dtype)
    e, params, w = prob.edges, eng.rtr_params, eng._windows
    row = {
        "n": n, "num_robots": num_robots, "edges": e.num_edges,
        "window_poses_max": w.max_poses, "window_edges_max": w.max_edges,
        "cluster": w.cluster, "k_solves": k_solves,
    }

    def run_k4(X, rb):
        return hbm_rtr.rtr_solve_hbm(X, rb, Pinv, e, params, w)

    row.update(timed("k4", run_k4, X0, num_robots, k_solves, device))
    log(f"n={n}: K4 {row['k4_ms_per_solve']:.4f} ms/solve "
        f"({row['k4_tcg_per_solve']} tCG/solve, windows <= {w.max_poses} poses)")
    if compare_k1:
        masks = eng._masks

        def run_k1(X, rb):
            Xk, s = fused_rtr.rtr_solve_fused(X, masks[rb], Pinv, e, params,
                                              windows=w, row=rb)
            return torch.where(masks[rb] > 0, Xk, X), s

        row.update(timed("k1", run_k1, X0, num_robots, k_solves, device))
        row["k4_over_k1_x"] = row["k4_ms_per_solve"] / row["k1_ms_per_solve"]
        log(f"n={n}: K1 {row['k1_ms_per_solve']:.4f} ms/solve "
            f"({row['k1_tcg_per_solve']} tCG/solve); K4/K1 {row['k4_over_k1_x']:.3f}")
    return row


def parse_sizes(text: str):
    """``n:robots[:k1],...`` → SIZES-like tuples (``:k1`` adds K1)."""
    out = []
    for item in text.split(","):
        parts = item.split(":")
        out.append((int(parts[0]), int(parts[1]), parts[2:] == ["k1"]))
    return tuple(out)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sizes", type=parse_sizes,
                   default=SIZES, help="n:robots[:k1],... (default the JAX script's)")
    p.add_argument("--k_solves", type=int, default=K_SOLVES)
    common.add_args(p)
    a = common.parse(p, argv, "bench_scale_hbm")
    device, dtype = a.device, common.DTYPES[a.dtype]
    card = common.card(device)
    log(f"card {card}; {a.dtype} on {device}")
    rows = [bench_one(n, R, k1, a.k_solves, device, dtype) for n, R, k1 in a.sizes]
    out = {
        "card": card,
        "device": str(device),
        "dtype": a.dtype,
        "note": "chained distinct-state block solves, robots in turn, one end "
                "sync; K4 (windowed) and, where the JAX script compared its VMEM "
                "kernel, K1 on the same robot windows",
        "rows": rows,
    }
    return common.emit(out, a.out)


if __name__ == "__main__":
    main()
