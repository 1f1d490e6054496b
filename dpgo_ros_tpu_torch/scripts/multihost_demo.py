"""Multi-process spmd RBCD demo: launch once per process.

Port of ``scripts/multihost_demo.py``. N processes × k local slots form one
N·k-slot mesh (``parallel/multihost.py``): the processes rendezvous over
``torch.distributed`` (gloo where they share a card or run on the CPU, NCCL
where each has its own), every one builds the identical problem and runs
the same spmd steps (``parallel/spmd.py``) on its slots; the separator
exchange crosses processes. On the card each slot's solve is one K1 launch.

    python -m dpgo_ros_tpu_torch.scripts.multihost_demo --num_processes 2 \\
        --process_id 0 --synthetic sphere --synthetic_n 500 --device cpu &
    python -m dpgo_ros_tpu_torch.scripts.multihost_demo --num_processes 2 \\
        --process_id 1 --synthetic sphere --synthetic_n 500 --device cpu &

Prints one parseable line per process:

    MULTIHOST_RESULT {"process_id": i, "num_processes": N,
                      "global_devices": N·k, "init_cost": ..., "final_cost": ...,
                      "steps": n, "elapsed_s": ...}

``--checkpoint_dir`` saves the final gathered state (process 0 writes);
``--resume`` resumes every process from such a checkpoint. ``--x_out``
writes the final gathered lifted state (process 0) as .npy, for exact
comparisons between process layouts.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="localhost:12360")
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--device", "--platform", choices=["cuda", "cpu"], default="cuda",
                    help="where the slots run (--platform: the JAX demo's name)")
    ap.add_argument("--local_devices", type=int, default=4,
                    help="mesh slots per process")
    ap.add_argument("--dataset", default="smallGrid3D")
    ap.add_argument("--synthetic", choices=["sphere", "grid3d"],
                    help="a synthetic world instead of --dataset (the bundled "
                         "datasets may be absent)")
    ap.add_argument("--synthetic_n", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--rank", type=int, default=5)
    ap.add_argument("--checkpoint_dir", default=None,
                    help="save the final full state here (process 0 writes)")
    ap.add_argument("--resume", default=None,
                    help="checkpoint dir to resume from (all processes read)")
    ap.add_argument("--x_out", default=None,
                    help="write the final gathered lifted state here (.npy, "
                         "process 0)")
    a = ap.parse_args(argv)

    from dpgo_ros_tpu_torch.parallel import multihost

    mesh = multihost.initialize(a.coordinator, a.num_processes, a.process_id,
                                local_slot_count=a.local_devices,
                                device=a.device)
    try:
        return _run(a, mesh)
    finally:
        multihost.shutdown()


def _run(a, mesh) -> int:
    from dpgo_ros_tpu_torch.models.problem import LiftedProblem
    from dpgo_ros_tpu_torch.ops import quadratic
    from dpgo_ros_tpu_torch.parallel import spmd
    from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
    from dpgo_ros_tpu_torch.utils import checkpoint as ckpt
    from dpgo_ros_tpu_torch.utils.config import AgentConfig, InitMethod, UpdateRule

    M = mesh.global_slots  # one robot block per global slot
    print(f"# proc {mesh.process_id}/{mesh.num_processes}: {mesh.local_slots} "
          f"local / {M} global slots on {mesh.device} ({mesh.backend})",
          file=sys.stderr, flush=True)
    # every process builds the identical replicated problem (deterministic)
    if a.synthetic:
        from dpgo_ros_tpu_torch.io.synthetic import generate_world

        kw = dict(n=a.synthetic_n)
        if a.synthetic == "grid3d":
            side = max(2, round(a.synthetic_n ** (1.0 / 3.0)))
            kw = dict(grid_shape=(side, side, side))
        data = generate_world(a.synthetic, num_robots=M, seed=42, **kw)[0]  # the CLI's
    else:
        from dpgo_ros_tpu_torch.io.datasets import load_g2o_dataset

        data = load_g2o_dataset(a.dataset, num_robots=M)
    prob = LiftedProblem.from_data(data, r=a.rank, dtype=torch.float32,
                                   device=mesh.device)
    cfg = AgentConfig(num_robots=M, update_rule=UpdateRule.PARALLEL,
                      local_initialization_method=InitMethod.ODOMETRY,
                      RTR_gradnorm_tol=0.5, dtype="float32")
    eng = RBCDEngine(prob, cfg)
    st0 = eng.initialize()
    f_init = float(quadratic.cost(st0.X, prob.edges))

    sp = spmd.ShardedProblem.build(prob, st0.X.cpu().numpy(), eng.robot_colors,
                                   num_devices=M)
    st, step = spmd.build_spmd_step(sp, cfg, mesh)
    it0 = 0
    if a.resume:
        host, _, meta = ckpt.load_state(a.resume, spmd.SpmdState)
        st = spmd.place_state(host, st, mesh)
        it0 = int(meta.get("it", 0))
        print(f"# proc {mesh.process_id}: resumed from {a.resume} (it {it0})",
              file=sys.stderr, flush=True)

    t0 = time.time()
    for it in range(it0, a.steps):
        st = step(it, 0, st)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    elapsed = time.time() - t0

    if a.checkpoint_dir:
        host = spmd.gather_state(st, M, mesh)  # a collective: every process
        if mesh.process_id == 0:
            ckpt.save_state(a.checkpoint_dir, host, meta={"it": a.steps})
            print(f"# checkpoint written to {a.checkpoint_dir}", file=sys.stderr,
                  flush=True)
    Xg = spmd.gather_trajectory(sp, st, prob.num_poses, mesh)
    if a.x_out and mesh.process_id == 0:
        np.save(a.x_out, Xg)
    f_final = float(quadratic.cost(
        torch.as_tensor(Xg, device=mesh.device), prob.edges))
    print("MULTIHOST_RESULT " + json.dumps({
        "process_id": mesh.process_id,
        "num_processes": mesh.num_processes,
        "global_devices": M,
        "init_cost": f_init,
        "final_cost": f_final,
        "steps": a.steps,
        "elapsed_s": round(elapsed, 3),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
