"""The load-balance efficiency model with slot repartitioning, anchored
on the card.

Port of ``scripts/record_scaling_r05.py``. Run from the repository root on
a machine with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.record_scaling_r05 [--out PATH]

A partition fixed by the data (tunnels' per-robot split) caps the mesh at
the hottest robot's work; ``spmd.repartition_slots`` re-cuts the global
pose sequence into work-balanced contiguous slot blocks (splitting hot
robots, co-scheduling cold ones). For each benchmark of
``scaling_model.BENCHES``: the blocks, skew and separator set
(:func:`stats_for`) of the fixed partition and of the repartitioned slots,
each with the model's efficiency on the H100's links
(``scaling_model.efficiency``, the formulas of ``record_scaling_r03``). The
anchor step is the M = 1 spmd step of ``--anchor_world`` measured on the
card in this run (one K1 launch per step). ``--benches`` and
``--anchor_iters`` cut the run for tests. Prints progress on stderr and one
JSON line on stdout; never writes the root ``SCALING_r05.json`` (the TPU's
record).
"""

from __future__ import annotations

import argparse

import numpy as np

from dpgo_ros_tpu_torch.parallel.spmd import repartition_slots
from dpgo_ros_tpu_torch.scripts import common, roofline, scaling_bench, scaling_model
from dpgo_ros_tpu_torch.scripts.common import log


def stats_for(data) -> dict:
    """The partition's blocks, work skew and separator set from the
    measurements alone, as the JAX script counts them."""
    num_poses = np.asarray(data.num_poses, np.int64)
    offs = np.concatenate([[0], np.cumsum(num_poses)])
    m = data.measurements
    gsrc = offs[m.src_robot] + m.src_frame
    gdst = offs[m.dst_robot] + m.dst_frame
    owner = np.searchsorted(offs[1:], gsrc, side="right")
    downer = np.searchsorted(offs[1:], gdst, side="right")
    edges = np.bincount(owner, minlength=data.num_robots)
    work = num_poses + edges
    cross = owner != downer
    seps = np.unique(np.concatenate([gsrc[cross], gdst[cross]])).size
    return {
        "num_slots": int(data.num_robots),
        "poses": num_poses.astype(int).tolist(),
        "edges_owned": edges.astype(int).tolist(),
        "work_skew_max_over_mean": float(work.max() / work.mean()),
        "separator_poses": int(seps),
        "allgather_bytes_per_step": int(seps * scaling_model.SEP_BYTES_PER_POSE),
    }


def with_efficiency(sk: dict, R: int, t_step: float) -> dict:
    return {**sk, "efficiency": scaling_model.efficiency(
        sk["work_skew_max_over_mean"], sk["allgather_bytes_per_step"], R, t_step)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--benches", type=scaling_model.benches_arg, default=scaling_model.BENCHES,
                   help="comma-separated subset of the benchmark worlds")
    p.add_argument("--anchor_world", default="sphere2500",
                   choices=sorted(roofline.STAND_INS))
    p.add_argument("--anchor_iters", type=int, default=scaling_bench.NUM_ITERS)
    common.add_args(p)
    a = common.parse(p, argv, "record_scaling_r05")
    card = common.card(a.device)
    log(f"card {card}; on {a.device}")
    anchor = scaling_model.anchor(a.anchor_world, a.anchor_iters, a.device)
    t_step = anchor["step_s"]
    log(f"anchor: M = 1 spmd step {t_step * 1e3:.4f} ms ({a.anchor_world})")
    rows = {}
    for name, R, _ in a.benches:
        base = with_efficiency(stats_for(roofline.load_world(name, R)[0]), R, t_step)
        rp = with_efficiency(stats_for(repartition_slots(roofline.load_world(name, R)[0], R)),
                             R, t_step)
        rows[f"{name}_{R}slot"] = {"fixed_partition": base, "repartitioned": rp}
        log(f"{name}@{R}: skew {base['work_skew_max_over_mean']:.3f} -> "
            f"{rp['work_skew_max_over_mean']:.3f}; eff {base['efficiency']} -> "
            f"{rp['efficiency']}; seps {base['separator_poses']} -> {rp['separator_poses']}")
    out = {"model": scaling_model.MODEL + " Repartitioned rows: spmd.repartition_slots "
                                          "(work-balanced contiguous slot cuts).",
           "links": scaling_model.LINKS, "anchor": anchor, "anchor_step_sec": t_step,
           "benchmarks": rows, "card": card, "device": a.device}
    return common.emit(out, a.out)


if __name__ == "__main__":
    main()
