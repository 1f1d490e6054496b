"""The spmd program's colored-Parallel step on the card at M mesh slots.

Port of ``scripts/scaling_bench.py``. Run from the repository root on a
machine with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.scaling_bench [--slots 1,2,4,8] [--out PATH]

For each M of ``--slots`` the sphere2500 world (``--world``; its file
where it exists, else its stand-in) is split among M robots, one per mesh
slot, all slots on the one card (``multihost.local_mesh``): colored
Parallel RBCD (Odometry init, gradnorm 0.5, fp32) as ``--mode spmd`` runs
it, each active slot's solve one K1 launch on its slot window. One warm
step, then ``--iters`` (default 30) steps chained through the state and
one synchronization. Per row: ms per step, ms per sweep (a sweep is the
``colors`` steps that update every robot once: the world's work per sweep
is the same at every M, so strong scaling keeps it flat), the K1 launches
of the timed steps and the active slot-steps they must equal, and the
separator set's poses and bytes (what an M-card mesh would exchange per
step). The slots share one card, so the rows show the program's cost per
slot, not a multi-card speedup. Prints progress on stderr and one JSON
line on stdout.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import quadratic
from dpgo_ros_tpu_torch.parallel import multihost, spmd
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu_torch.scripts import common, roofline
from dpgo_ros_tpu_torch.scripts.common import log
from dpgo_ros_tpu_torch.utils.config import AgentConfig, InitMethod, UpdateRule

SLOTS = (1, 2, 4, 8)
NUM_ITERS = 30


def config(num_robots: int) -> AgentConfig:
    """The JAX script's mesh configuration (the kernel route: fp32)."""
    return AgentConfig(
        num_robots=num_robots,
        update_rule=UpdateRule.PARALLEL,
        local_initialization_method=InitMethod.ODOMETRY,
        RTR_gradnorm_tol=0.5,
        dtype="float32",
        use_fused_kernel=True,
    )


def active_slot_steps(colors, steps) -> int:
    """The block solves of the per-step program over ``steps`` (step
    indices): Σ over them of the slots whose colour is the step's."""
    colors = np.asarray(colors)
    k = int(colors.max()) + 1
    return int(sum((colors == it % k).sum() for it in steps))


def separators(prob: LiftedProblem) -> int:
    """The poses with an edge to another robot's block."""
    return int((prob.separator_mask(torch.float32) > 0).sum())


def measure(world: str, num_robots: int, num_devices: int, iters: int, device) -> dict:
    """One mesh's row: ``world`` as ``num_robots`` robots on
    ``num_devices`` slots of this process (grouped first where there are
    more robots than slots; the separator set is the robots')."""
    data, _, _, _ = roofline.load_world(world, num_robots=num_robots)
    # the separator volume is the robot partition's, whatever the slots
    n_sep = separators(LiftedProblem.from_data(data, r=5, dtype=torch.float32,
                                               device="cpu"))
    if num_devices < num_robots:
        data = spmd.group_robots(data, num_devices)
        num_robots = num_devices
    prob = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device=device)
    eng = RBCDEngine(prob, config(num_robots))
    st0 = eng.initialize()
    sp = spmd.ShardedProblem.build(prob, st0.X.cpu().numpy().astype(np.float32),
                                   eng.robot_colors, num_devices=num_devices)
    st, step = spmd.build_spmd_step(sp, config(num_robots),
                                    multihost.local_mesh(num_devices, device))
    st = step(0, 0, st)  # warm
    common.sync(device)
    before = common.counts()
    t0 = time.perf_counter()
    for it in range(1, iters + 1):
        st = step(it, 0, st)
    common.sync(device)
    dt = (time.perf_counter() - t0) / iters
    launches = common.launched(before)
    vol = n_sep * prob.r * (prob.d + 1) * 4  # the separator set, fp32
    return {
        "devices": num_devices, "robots": data.num_robots, "colors": eng.num_colors,
        "steps": iters,
        "ms_per_step": dt * 1e3,
        "ms_per_sweep": dt * eng.num_colors * 1e3,
        "active_slot_steps": active_slot_steps(sp.color, range(1, iters + 1)),
        "warm_slot_steps": active_slot_steps(sp.color, [0]),
        "launches": launches,
        "separator_poses": n_sep,
        "allgather_bytes_per_step": vol,
        "gathered_cost": gathered_cost(sp, st, prob),
    }


def gathered_cost(sp, st, prob: LiftedProblem) -> float:
    """The world's cost of the mesh state (``gather_trajectory``)."""
    Xg = spmd.gather_trajectory(sp, st, prob.num_poses)
    return float(quadratic.cost(torch.as_tensor(Xg, dtype=prob.dtype, device=prob.device),
                                prob.edges))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", default="sphere2500", choices=sorted(roofline.STAND_INS))
    p.add_argument("--slots", type=common.ints, default=SLOTS)
    p.add_argument("--iters", type=int, default=NUM_ITERS)
    common.add_args(p)
    a = common.parse(p, argv, "scaling_bench")
    if a.dtype != "float32":
        p.error("--dtype: the mesh program's kernel route is float32 only")
    card = common.card(a.device)
    log(f"card {card}; on {a.device}")
    rows = []
    for M in a.slots:
        r = measure(a.world, M, M, a.iters, a.device)
        log(f"M={M} (colors={r['colors']}): {r['ms_per_step']:8.2f} ms/step "
            f"{r['ms_per_sweep']:8.2f} ms/sweep; K1 {r['launches']['k1']} for "
            f"{r['active_slot_steps']} active slot-steps")
        rows.append(r)
    return common.emit({"world": a.world, "rows": rows, "card": card,
                        "device": a.device}, a.out)


if __name__ == "__main__":
    main()
