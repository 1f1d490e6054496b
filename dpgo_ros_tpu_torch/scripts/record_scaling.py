"""The scaling record on the card: the spmd step at M slots, multi-process
meshes sharing the card, and the one-card anchor with its N-card model.

Port of ``scripts/record_scaling.py``. Run from the repository root on a
machine with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.record_scaling [--out PATH]

1. ``slots``: ``scaling_bench``'s rows at M ∈ ``--slots`` (default 1, 2,
   4, 8) on the sphere2500 world split among M robots, M slots on the one
   card: ms per step and per sweep, colours, the separator exchange's
   poses and bytes, K1 launches against active slot-steps.
2. ``multi_process``: ``scripts/multihost_demo.py`` as P ∈ ``--processes``
   (default 1, 2) processes sharing the card over gloo, 4 / P slots each
   (one 4-slot mesh whatever P), ``--mh_steps`` steps on a synthetic
   sphere of ``--mh_n`` poses (default the sphere2500 stand-in): steps per
   second, and the final cost, which every process of a run and every P
   must give bit for bit. A run that
   fails is recorded with its error and the script exits 1 after its JSON
   line.
3. ``single_card``: the anchor, the world's 5 robots grouped into one slot
   (one K1 launch per step), measured here, with block updates per second
   and the N-card projection of ``scaling_model`` on the H100's links.

``--device cpu`` runs every part on the CPU (the kernels' plain versions;
the processes over gloo on the CPU). Prints progress on stderr and one
JSON line on stdout; never writes the root ``SCALING_r02.json`` (the TPU's
record).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from dpgo_ros_tpu_torch.parallel import multihost
from dpgo_ros_tpu_torch.scripts import common, roofline, scaling_bench, scaling_model
from dpgo_ros_tpu_torch.scripts.common import log

PROCESSES = (1, 2)
MESH_SLOTS = 4
MH_WORLD = dict(synthetic="sphere", synthetic_n=2500)  # the sphere2500 stand-in
MH_STEPS = 24


def run_multihost(num_processes: int, steps: int, device: str, world: dict) -> dict:
    """One multi-process mesh: ``num_processes`` processes of
    ``multihost_demo`` with ``MESH_SLOTS / num_processes`` slots each.
    Raises unless every process reports and all report one final cost."""
    port = multihost.free_port()
    cmd = [sys.executable, "-m", "dpgo_ros_tpu_torch.scripts.multihost_demo",
           "--coordinator", f"localhost:{port}", "--num_processes", str(num_processes),
           "--local_devices", str(MESH_SLOTS // num_processes), "--steps", str(steps),
           "--device", device, "--synthetic", world["synthetic"],
           "--synthetic_n", str(world["synthetic_n"])]
    procs = [subprocess.Popen(cmd + ["--process_id", str(pid)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=common.REPO,
                              env=dict(os.environ, OMP_NUM_THREADS="1"))
             for pid in range(num_processes)]
    outs = []
    try:
        outs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = [json.loads(line.split(" ", 1)[1]) for out, _ in outs
           for line in out.splitlines() if line.startswith("MULTIHOST_RESULT")]
    if len(res) != num_processes or any(p.returncode for p in procs):
        raise RuntimeError(f"{len(res)} of {num_processes} results, exit codes "
                           f"{[p.returncode for p in procs]}: "
                           + " | ".join(err[-400:] for _, err in outs))
    if any(r["final_cost"] != res[0]["final_cost"] for r in res):
        raise RuntimeError(f"final costs differ across processes: {res}")
    elapsed = max(r["elapsed_s"] for r in res)
    return {"processes": num_processes, "slots_per_process": MESH_SLOTS // num_processes,
            "steps": res[0]["steps"], "elapsed_s": elapsed,
            "steps_per_s": res[0]["steps"] / elapsed, "final_cost": res[0]["final_cost"]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", default="sphere2500", choices=sorted(roofline.STAND_INS))
    p.add_argument("--slots", type=common.ints, default=scaling_bench.SLOTS)
    p.add_argument("--iters", type=int, default=scaling_bench.NUM_ITERS)
    p.add_argument("--processes", type=common.ints, default=PROCESSES)
    p.add_argument("--mh_steps", type=int, default=MH_STEPS)
    p.add_argument("--mh_n", type=int, default=MH_WORLD["synthetic_n"],
                   help="poses of the multi-process runs' synthetic sphere")
    common.add_args(p)
    a = common.parse(p, argv, "record_scaling")
    if a.dtype != "float32":
        p.error("--dtype: the mesh program's kernel route is float32 only")
    if any(MESH_SLOTS % P for P in a.processes):
        p.error(f"--processes: each must divide the mesh's {MESH_SLOTS} slots")
    card = common.card(a.device)
    log(f"card {card}; on {a.device}")
    doc = {"dataset": f"{a.world}, colored-parallel spmd", "card": card,
           "device": a.device,
           "caveats": "every slot and process shares the one card: the rows show the "
                      "mesh program's cost per slot and the exchange's structure, not "
                      "a multi-card speedup (scripts/multicard_check.py runs four cards)"}
    rows = []
    for M in a.slots:
        r = scaling_bench.measure(a.world, M, M, a.iters, a.device)
        log(f"M={M}: {r['ms_per_step']:.3f} ms/step, {r['ms_per_sweep']:.3f} ms/sweep, "
            f"colors {r['colors']}, {r['allgather_bytes_per_step']} bytes/step")
        rows.append(r)
    doc["slots"] = rows
    mh, failed = [], False
    world = dict(MH_WORLD, synthetic_n=a.mh_n)
    for P in a.processes:
        try:
            mh.append(run_multihost(P, a.mh_steps, a.device, world))
            log(f"{P} process(es): {mh[-1]}")
        except (RuntimeError, subprocess.TimeoutExpired) as ex:
            mh.append({"processes": P, "error": str(ex)[:2000]})
            failed = True
            log(f"{P} process(es) FAILED: {ex}")
    costs = {r["final_cost"] for r in mh if "final_cost" in r}
    doc["multi_process"] = {"world": world, "mesh_slots": MESH_SLOTS, "rows": mh,
                            "bit_identical_across_layouts": len(costs) == 1 and not failed}
    failed = failed or len(costs) != 1
    t0 = time.time()
    anchor = scaling_model.anchor(a.world, a.iters, a.device)
    log(f"single card: {anchor['ms_per_step']:.3f} ms/step ({time.time() - t0:.1f} s)")
    V = anchor["allgather_bytes_per_step"]
    doc["single_card"] = anchor
    doc["n_card_projection"] = {
        "note": "eff = t_comp/(t_comp + V/BW), V the full separator set (upper bound: an "
                "all-gather delivers (N-1)/N of it per card); t_comp the measured "
                "one-card step",
        "t_comp_ms": anchor["ms_per_step"],
        "rows": [dict(ln, allgather_bytes_per_step=V,
                      separator_poses=anchor["separator_poses"],
                      t_comm_us=V / ln["bytes_per_s"] * 1e6,
                      efficiency_no_overlap=anchor["step_s"] / (
                          anchor["step_s"] + V / ln["bytes_per_s"]))
                 for ln in scaling_model.LINKS],
    }
    common.emit(doc, a.out)
    if failed:
        raise SystemExit("record_scaling: a multi-process run failed or the final costs "
                         "differ across layouts")
    return doc


if __name__ == "__main__":
    main()
