"""End-to-end engine solves on the card, the JAX script's presets.

Port of ``scripts/exp_e2e.py``. Run from the repository root on a machine
with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.exp_e2e [preset ...] [--out PATH]

Presets (:data:`PRESETS`, default ``tiny``): ``tiny`` (tinyGrid3D, 1 and 2
robots, RoundRobin), ``small`` (smallGrid3D, 1 and 2 robots RoundRobin, 2
robots Parallel), ``sphere`` (sphere2500, 5 robots, RoundRobin, Chordal
init, rel tol 0.2) and ``sphere_accel`` (the same, accelerated); the
others start from the Odometry init at rel tol 1e-2. Each world is its
file where it exists, else its stand-in. Every solve runs
``RBCDEngine.run`` from its initialization: on the card each RoundRobin
update is one K4 launch on the robot's window and each Parallel update one
K1 launch on its colour's window (one more per restart of an accelerated
step). Per solve: the initial cost, iterations, final cost, convergence,
the Riemannian gradient's norm at the end, the solve's wall seconds, the
median milliseconds per iteration, and the kernels' launches. Default
fp32; ``--device cpu --dtype float64`` gives the JAX script's fp64 CPU
numbers (the engine has no fp64 route on the card). Prints progress on
stderr and one JSON line on stdout.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import quadratic
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu_torch.scripts import common, roofline
from dpgo_ros_tpu_torch.scripts.common import log
from dpgo_ros_tpu_torch.utils.config import AgentConfig, InitMethod, UpdateRule

RR, PAR = UpdateRule.ROUND_ROBIN, UpdateRule.PARALLEL
# preset: [(world, robots, rule, solve() keywords)], the JAX script's
PRESETS = {
    "tiny": [("tinyGrid3D", 1, RR, dict(tol=1e-2, max_iters=50)),
             ("tinyGrid3D", 2, RR, dict(tol=1e-2, max_iters=100))],
    "small": [("smallGrid3D", 1, RR, dict(tol=1e-2, max_iters=100)),
              ("smallGrid3D", 2, RR, dict(tol=1e-2, max_iters=100)),
              ("smallGrid3D", 2, PAR, dict(tol=1e-2, max_iters=100))],
    "sphere": [("sphere2500", 5, RR, dict(init=InitMethod.CHORDAL, tol=0.2,
                                          max_iters=1000))],
    "sphere_accel": [("sphere2500", 5, RR, dict(accel=True, init=InitMethod.CHORDAL,
                                                tol=0.2, max_iters=1000))],
}


def solve(name: str, num_robots: int, rule: UpdateRule, accel=False,
          init=InitMethod.ODOMETRY, tol=0.1, max_iters=300, r=5, *, device,
          dtype="float32", ylift=None) -> dict:
    """One solve of the JAX script's ``solve`` (``ylift`` replaces the
    engine's draw)."""
    data, _, _, _ = roofline.load_world(name, num_robots=num_robots)
    prob = LiftedProblem.from_data(data, r=r, dtype=common.DTYPES[dtype], device=device)
    cfg = AgentConfig(
        num_robots=num_robots,
        relaxation_rank=r,
        update_rule=rule,
        acceleration=accel,
        local_initialization_method=init,
        relative_change_tolerance=tol,
        max_iteration_number=max_iters,
        RTR_gradnorm_tol=0.5,
        dtype=dtype,
    )
    eng = RBCDEngine(prob, cfg)
    st = eng.initialize(ylift=ylift)
    f0 = float(st.cost)
    before = common.counts()
    st, info = eng.run(st)
    launches = common.launched(before)
    T, st = eng.finalize(st)
    g = quadratic.rgrad(st.X, eng._edges(st.weights))
    row = {
        "world": name, "robots": num_robots, "rule": rule.value, "acceleration": accel,
        "init_cost": f0,
        "iterations": info["iterations"],
        "final_cost": info["final_cost"],
        "converged": info["converged"],
        "gradnorm": float(torch.linalg.vector_norm(g)),
        "total_time_sec": info["total_time_sec"],
        "median_iter_ms": float(np.median(info["history"]["iter_time_sec"]) * 1e3),
        "restarts": info["restarts"],
        "launches": launches,
    }
    log(f"[{name} x{num_robots} {rule.value} accel={accel}] init cost {f0:.4e} "
        f"iters={row['iterations']} final={row['final_cost']:.6e} "
        f"converged={row['converged']} gradnorm={row['gradnorm']:.3e} "
        f"time={row['total_time_sec']:.1f}s med_iter={row['median_iter_ms']:.1f}ms "
        f"launches { {k: v for k, v in launches.items() if v} }")
    return row


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("presets", nargs="*", default=["tiny"], help=f"of {', '.join(PRESETS)}")
    common.add_args(p)
    a = common.parse(p, argv, "exp_e2e")
    unknown = [n for n in a.presets if n not in PRESETS]
    if unknown:
        p.error(f"unknown presets {unknown}")
    if a.dtype == "float64" and a.device == "cuda":
        p.error("--dtype float64 runs the engine's plain route, which runs on the CPU "
                "only (--device cpu)")
    card = common.card(a.device)
    log(f"card {card}; {a.dtype} on {a.device}")
    out = {"presets": {name: [solve(w, R, rule, **kw, device=a.device, dtype=a.dtype)
                              for w, R, rule, kw in PRESETS[name]]
                       for name in a.presets},
           "card": card, "device": a.device, "dtype": a.dtype}
    return common.emit(out, a.out)


if __name__ == "__main__":
    main()
