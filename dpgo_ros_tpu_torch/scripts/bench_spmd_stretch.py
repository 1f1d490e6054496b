"""spmd mesh step rate on the card: per-step programs against in-kernel
multi-step stretches.

Port of ``scripts/bench_spmd_stretch.py``. Run from the repository root on a
machine with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.bench_spmd_stretch [--out PATH]

The mesh program (``parallel/spmd.py``) runs S solver steps per launch
(``spmd_steps_per_launch``) and exchanges separators between launches: S =
1 is the per-step program (one K1 launch per active slot and step), S > 1
a stretch (one K2 launch per slot and launch). Two meshes, the JAX
script's, both on one card here (the JAX script ran the second on a
virtual CPU mesh):

* M = 1: the sphere2500 world (its file where it exists, else its stand-in)
  grouped into one robot, RTR stretches (exact: the slot's block is the
  whole state), S ∈ {1, 16, 64, 128}, 256 iterations;
* M = 8: the smallGrid3D world as 8 robots on 8 slots, RGD-tick stretches
  (stepsize 0.2; full block solves against stale separators diverge), S ∈
  {1, 16, 64} (S = 1 is the RTR per-step program), 128 iterations.

Launches chain through the state, one synchronization at the end. Per row:
wall seconds, ms per iteration and per launch, iterations per second, the
final cost of the gathered state, the kernels' launches. ``--world``,
``--grid_world`` and the ``--*_strides`` / ``--*_iters`` flags cut the run
for tests. Prints progress on stderr and one JSON line on stdout; never
writes the root ``SPMD_STRETCH_r05.json`` (the TPU's record).
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

M1_STRIDES, M1_ITERS = (1, 16, 64, 128), 256
M8_STRIDES, M8_ITERS = (1, 16, 64), 128
STRETCH_RGD = 0.2


def build(world: str, num_robots: int, num_devices: int, S: int, rgd, device):
    """(problem, engine, initial engine state, ShardedProblem, initial slot
    state, step) of the mesh program, as the JAX script builds it."""
    data, _, _, _ = roofline.load_world(world, num_robots=num_robots)
    if num_devices < num_robots:
        data = spmd.group_robots(data, num_devices)
        num_robots = num_devices
    prob = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device=device)
    cfg = AgentConfig(
        num_robots=num_robots,
        update_rule=UpdateRule.PARALLEL,
        local_initialization_method=InitMethod.CHORDAL,
        RTR_gradnorm_tol=0.5,
        dtype="float32",
        use_fused_kernel=True,
        spmd_steps_per_launch=S,
        spmd_stretch_rgd_stepsize=rgd,
    )
    eng = RBCDEngine(prob, cfg)
    st0 = eng.initialize()
    sp = spmd.ShardedProblem.build(prob, st0.X.cpu().numpy().astype(np.float32),
                                   eng.robot_colors, num_devices=num_devices)
    init, step = spmd.build_spmd_step(sp, cfg, multihost.local_mesh(num_devices, device))
    return prob, eng, st0, sp, init, step


def measure(world: str, num_robots: int, num_devices: int, S: int, rgd,
            total_iters: int, device) -> dict:
    prob, eng, st0, sp, init, step = build(world, num_robots, num_devices, S, rgd, device)
    launches = max(1, total_iters // S)
    step(0, 0, init)  # warm
    common.sync(device)
    before = common.counts()
    st = init
    t0 = time.perf_counter()
    for lt in range(launches):
        st = step(lt, 0, st)
    common.sync(device)
    dt = time.perf_counter() - t0
    kernels = common.launched(before)
    iters = launches * S
    Xg = torch.as_tensor(spmd.gather_trajectory(sp, st, prob.num_poses), device=prob.device)
    f = float(quadratic.cost(Xg, eng._edges(st0.weights)))
    return {
        "S": S,
        "rgd_stepsize": rgd,
        "launches": launches,
        "solver_iters": iters,
        "wall_s": dt,
        "ms_per_iter": dt / iters * 1e3,
        "ms_per_launch": dt / launches * 1e3,
        "iters_per_sec": iters / dt,
        "final_cost": f,
        "kernel_launches": kernels,
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", default="sphere2500", choices=sorted(roofline.STAND_INS),
                   help="the M = 1 mesh's world (5 robots grouped into one slot)")
    p.add_argument("--grid_world", default="smallGrid3D",
                   choices=sorted(roofline.STAND_INS), help="the M = 8 mesh's world")
    p.add_argument("--m1_strides", type=common.ints, default=M1_STRIDES)
    p.add_argument("--m1_iters", type=int, default=M1_ITERS)
    p.add_argument("--m8_strides", type=common.ints, default=M8_STRIDES)
    p.add_argument("--m8_iters", type=int, default=M8_ITERS)
    common.add_args(p)
    a = common.parse(p, argv, "bench_spmd_stretch")
    if a.dtype != "float32":
        p.error("--dtype: the mesh program's kernel route is float32 only")
    device = torch.device(a.device)
    card = common.card(device)
    log(f"card {card}; on {device}")
    configs = {}
    # the single-card mesh: the world grouped into one slot, exact RTR stretches
    rows = []
    for S in a.m1_strides:
        r = measure(a.world, 5, 1, S, None, a.m1_iters, device)
        log(f"M=1 {a.world} RTR S={S}: {r}")
        rows.append(r)
    configs[f"{a.world}_M1_rtr"] = rows
    configs[f"{a.world}_M1_speedup"] = rows[0]["ms_per_iter"] / min(
        r["ms_per_iter"] for r in rows)
    # the 8-slot mesh: RGD-tick stretches (staleness-robust)
    rows = []
    for S in a.m8_strides:
        rgd = None if S == 1 else STRETCH_RGD
        r = measure(a.grid_world, 8, 8, S, rgd, a.m8_iters, device)
        log(f"M=8 {a.grid_world} S={S} rgd={rgd}: {r}")
        rows.append(r)
    configs[f"{a.grid_world}_M8"] = rows
    if len(rows) > 1:
        configs[f"{a.grid_world}_M8_speedup"] = rows[0]["ms_per_iter"] / min(
            r["ms_per_iter"] for r in rows[1:])
    out = {"card": card, "device": str(device), "configs": configs}
    return common.emit(out, a.out)


if __name__ == "__main__":
    main()
