"""Scale bench of the colored-Parallel engine: block updates per second and
tCG iterations per solve on synthetic spheres of 2,500 to 50,000 poses.

Port of ``scripts/bench_scale.py``. Run from the repository root on a
machine with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.bench_scale [--out PATH]

Worlds: ``generate_world("sphere", n, robots, rot_noise 0.01, trans_noise
0.05, seed 0)`` at the JAX script's sizes (n = 2,500 / 10,000 / 25,000 /
50,000 with 5 / 8 / 10 / 16 robots; ``--sizes`` cuts them for tests),
Odometry init, the Parallel rule, relative-change tolerance 0 and
``--iters`` (60) updates per solve, RTR 3 × 50, gradnorm tol 0.5, fp32.
Each update is one K1 launch on its colour class's window
(``RBCDEngine.run``). The JAX script ran RoundRobin above 16,000 poses
because its windowed kernel serves one contiguous block only; K1's colour
windows have no such limit, so every size runs Parallel here.

Timing is ``bench.py``'s: 6 chained solves from distinct gauge-rotated
inputs (the angle from the sum of the previous solve's X[:, 0, 0]), one
synchronization at the end, after two warm solves. Per size: block updates
per second, ms per step, the tCG iterations per solve (the engine's sum of
K1's counters; VERDICT r5 #3) and their rate, the final cost, K1's
launches.

The JAX script caught a failed size and stopped; here a failure exits
nonzero. Prints progress on stderr and one JSON line on stdout; never
writes the root ``baseline_results.json`` (the TPU's record).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from dpgo_ros_tpu_torch.io.synthetic import generate_world
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import quadratic
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu_torch.scripts import common
from dpgo_ros_tpu_torch.scripts.bench import make_perturb
from dpgo_ros_tpu_torch.scripts.common import log
from dpgo_ros_tpu_torch.utils.config import AgentConfig, InitMethod, UpdateRule

ITERS = 60
K_CHAIN = 6
SIZES = ((2500, 5), (10000, 8), (25000, 10), (50000, 16))


def bench(n: int, num_robots: int, iters: int = ITERS, device="cuda",
          dtype=torch.float32, k_chain: int = K_CHAIN) -> dict:
    data, _, _ = generate_world(
        "sphere", n=n, num_robots=num_robots, rot_noise=0.01,
        trans_noise=0.05, seed=0,
    )
    prob = LiftedProblem.from_data(data, r=5, dtype=dtype, device=device)
    rule = UpdateRule.PARALLEL
    cfg = AgentConfig(
        num_robots=num_robots,
        update_rule=rule,
        local_initialization_method=InitMethod.ODOMETRY,
        relative_change_tolerance=0.0,
        max_iteration_number=iters,
        RTR_iterations=3,
        RTR_tCG_iterations=50,
        RTR_gradnorm_tol=0.5,
        dtype="float64" if dtype == torch.float64 else "float32",
    )
    eng = RBCDEngine(prob, cfg)
    st = eng.initialize()

    def call(s):
        out, info = eng.run(s, max_iters=iters)
        return out, info["tcg_iterations"]

    perturb = make_perturb(prob.r, dtype, prob.device)
    out, _ = call(st)
    sig = torch.sum(out.X[:, 0, 0])
    call(st._replace(X=perturb(st.X, sig, 0.5)))
    before = common.counts()
    cur, tcgs = st, []
    common.sync(device)
    t0 = time.perf_counter()
    for i in range(k_chain):
        out, tcg = call(cur)
        tcgs.append(tcg)
        if i < k_chain - 1:
            sig = torch.sum(out.X[:, 0, 0])
            cur = st._replace(X=perturb(st.X, sig, i + 1.0))
    common.sync(device)
    dt = (time.perf_counter() - t0) / k_chain
    launches = common.launched(before)
    steps = int(out.iteration)
    sizes = np.bincount(eng.robot_colors, minlength=eng.num_colors)
    updates = int(sum(sizes[s % eng.num_colors] for s in range(steps)))
    tcg = float(np.mean(tcgs))
    f_final = float(quadratic.cost(out.X, prob.edges))
    log(f"n={n} R={num_robots}: {steps} steps ({updates} updates, tcg={tcg}) in "
        f"{dt:.3f}s/solve = {updates / dt:.1f} updates/s; cost {float(st.cost):.3e} -> "
        f"{f_final:.3e}; {eng.num_colors} colours, launches {launches}")
    return {
        "n": n,
        "num_robots": num_robots,
        "rule": rule.value,
        "num_colors": eng.num_colors,
        "steps": steps,
        "block_updates": updates,
        "block_updates_per_sec": updates / dt,
        "tcg_iters": tcg,
        "tcg_iters_min": min(tcgs),
        "tcg_iters_max": max(tcgs),
        "tcg_iters_per_update": tcg / updates,
        "tcg_iters_per_sec": tcg / dt,
        "ms_per_step": dt / steps * 1e3,
        "s_per_solve": dt,
        "init_cost": float(st.cost),
        "final_cost": f_final,
        "k_chain": k_chain,
        "launches": launches,
    }


def parse_sizes(text: str):
    """``n:robots,...`` → SIZES-like tuples."""
    return tuple(tuple(int(v) for v in item.split(":")) for item in text.split(","))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sizes", type=parse_sizes, default=SIZES,
                   help="n:robots,... (default the JAX script's)")
    p.add_argument("--iters", type=int, default=ITERS)
    p.add_argument("--k_chain", type=int, default=K_CHAIN)
    common.add_args(p)
    a = common.parse(p, argv, "bench_scale")
    device, dtype = a.device, common.DTYPES[a.dtype]
    card = common.card(device)
    log(f"card {card}; {a.dtype} on {device}")
    rows = [bench(n, R, a.iters, device, dtype, a.k_chain) for n, R in a.sizes]
    out = {
        "card": card,
        "device": str(device),
        "dtype": a.dtype,
        "note": "engine run (colored-Parallel, K1 on the colour windows), reference "
                "RTR budget, chained distinct-input timing; worlds from io/synthetic.py",
        "rows": rows,
    }
    return common.emit(out, a.out)


if __name__ == "__main__":
    main()
