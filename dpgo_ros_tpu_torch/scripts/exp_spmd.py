"""The spmd mesh program at 8 slots on the card: colored Parallel RBCD on
the smallGrid3D world.

Port of ``scripts/exp_spmd.py``. Run from the repository root on a machine
with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.exp_spmd [--out PATH]

The ``--world`` (default the smallGrid3D stand-in) split among
``--slots`` (8) robots, one per mesh slot, all slots on the one card:
Parallel (Odometry init, rel tol 1e-2, gradnorm 0.5, fp32), each active
slot's solve one K1 launch on its slot window. Reports the robots'
colours, the initial cost, ``--steps`` (60) steps with a synchronization
after each, as the JAX script runs them, ``gather_trajectory``'s final
cost, each slot's relative change, and the K1 launches with the active
slot-steps they must equal. ``--device cpu --dtype float64`` runs the
plain fp64 route (``use_fused_kernel=False``). Prints progress on stderr
and one JSON line on stdout.
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
from dpgo_ros_tpu_torch.scripts import common, roofline, scaling_bench
from dpgo_ros_tpu_torch.scripts.common import log
from dpgo_ros_tpu_torch.utils.config import AgentConfig, InitMethod, UpdateRule


def config(num_robots: int, dtype: str) -> AgentConfig:
    """The JAX script's configuration; fp64 on the plain route."""
    return AgentConfig(
        num_robots=num_robots,
        update_rule=UpdateRule.PARALLEL,
        local_initialization_method=InitMethod.ODOMETRY,
        relative_change_tolerance=1e-2,
        RTR_gradnorm_tol=0.5,
        dtype=dtype,
        use_fused_kernel=dtype == "float32",
    )


def run(world: str, slots: int, steps: int, device, dtype: str = "float32",
        ylift=None) -> dict:
    """The experiment's record (``ylift`` replaces the engine's draw)."""
    data, _, _, _ = roofline.load_world(world, num_robots=slots)
    cfg = config(slots, dtype)
    prob = LiftedProblem.from_data(data, r=5, dtype=common.DTYPES[dtype], device=device)
    eng = RBCDEngine(prob, cfg)
    st0 = eng.initialize(ylift=ylift)
    log(f"colors: {eng.robot_colors.tolist()} num_colors: {eng.num_colors}")
    sp = spmd.ShardedProblem.build(prob, st0.X.cpu().numpy(), eng.robot_colors,
                                   num_devices=slots, dtype=np.dtype(dtype).type)
    st, step = spmd.build_spmd_step(sp, cfg, multihost.local_mesh(slots, device))
    e_full = eng._edges(st0.weights)
    f0 = float(quadratic.cost(st0.X, e_full))
    log(f"init cost: {f0}")
    before = common.counts()
    t0 = time.time()
    for it in range(steps):
        st = step(it, 0, st)
        common.sync(device)
    wall = time.time() - t0
    launches = common.launched(before)
    Xg = spmd.gather_trajectory(sp, st, prob.num_poses)
    f = float(quadratic.cost(torch.as_tensor(Xg, dtype=prob.dtype, device=prob.device),
                             e_full))
    rel = st.rel_change.cpu().numpy().ravel().tolist()
    log(f"{steps} iters in {wall:.1f}s; final cost {f}; rel_change per robot {rel}")
    return {"colors": eng.robot_colors.tolist(), "num_colors": eng.num_colors,
            "init_cost": f0, "steps": steps, "wall_s": wall, "final_cost": f,
            "rel_change": rel, "launches": launches,
            "active_slot_steps": scaling_bench.active_slot_steps(sp.color, range(steps))}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", default="smallGrid3D", choices=sorted(roofline.STAND_INS))
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--steps", type=int, default=60)
    common.add_args(p)
    a = common.parse(p, argv, "exp_spmd")
    if a.dtype == "float64" and a.device == "cuda":
        p.error("--dtype float64 runs the plain route, which runs on the CPU only "
                "(--device cpu): the engine that initializes the mesh is fp32 on the card")
    card = common.card(a.device)
    log(f"card {card}; {a.dtype} on {a.device}")
    out = dict(run(a.world, a.slots, a.steps, a.device, a.dtype), world=a.world,
               slots=a.slots, card=card, device=a.device, dtype=a.dtype)
    return common.emit(out, a.out)


if __name__ == "__main__":
    main()
