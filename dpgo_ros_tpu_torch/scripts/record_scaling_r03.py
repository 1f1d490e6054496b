"""The N-card efficiency model with each benchmark's load-balance skew,
anchored on the card.

Port of ``scripts/record_scaling_r03.py``. Run from the repository root on
a machine with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.record_scaling_r03 [--out PATH]

In the mesh program every slot owns one robot's contiguous pose block and
works through its rows and owned edges every step, so a step takes as long
as the largest block: the balance efficiency is mean(work)/max(work), with
a block's work its poses plus its owned edges (:func:`skew_for`). For each
benchmark of ``scaling_model.BENCHES`` (the five roofline stand-ins and
the two small grids, a world's file first where it exists) the skew under
the reference's equal-pose partition and, but for tunnels, under the
work-balanced one (``balance="work"``), the separator poses and bytes, and
the model's efficiency on the H100's links (``scaling_model``). The anchor
step is the M = 1 spmd step of ``--anchor_world`` measured on the card in
this run (one K1 launch per step), not the TPU's. ``--benches`` and
``--anchor_iters`` cut the run for tests. Prints progress on stderr and one
JSON line on stdout; never writes the root ``SCALING_r03.json`` (the TPU's
record).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.scripts import common, roofline, scaling_bench, scaling_model
from dpgo_ros_tpu_torch.scripts.common import log


def skew_for(data) -> dict:
    """The partition's blocks (poses, owned edges), work skew (max over
    mean of poses + owned edges) and separator set, as the JAX script
    counts them."""
    prob = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device="cpu")
    R = prob.num_robots
    he = prob.host_edges
    src = np.asarray(he.src)
    msk = np.asarray(he.mask) > 0
    offs = np.asarray(prob.offsets)
    poses = np.asarray(prob.num_poses, np.float64)
    owner = np.searchsorted(offs, src[msk], side="right") - 1
    edges = np.bincount(owner, minlength=R).astype(np.float64)
    work = poses + edges
    # separator poses: endpoints of cross-block edges
    dst = np.asarray(he.dst)[msk]
    downer = np.searchsorted(offs, dst, side="right") - 1
    cross = owner != downer
    seps = np.unique(np.concatenate([src[msk][cross], dst[cross]])).size
    return {
        "num_robots": R,
        "poses": poses.astype(int).tolist(),
        "edges_owned": edges.astype(int).tolist(),
        "work_skew_max_over_mean": float(work.max() / work.mean()),
        "separator_poses": int(seps),
        "allgather_bytes_per_step": int(seps * scaling_model.SEP_BYTES_PER_POSE),
    }


def bench_row(name: str, R: int, kind: str, t_step: float) -> dict:
    sk = skew_for(roofline.load_world(name, R)[0])
    if kind == "g2o":
        # the remedy: work-balanced contiguous cuts, same classification
        skb = skew_for(roofline.load_world(name, R, balance="work")[0])
        sk["work_skew_balanced"] = skb["work_skew_max_over_mean"]
        sk["poses_balanced"] = skb["poses"]
    V = sk["allgather_bytes_per_step"]
    eff = scaling_model.efficiency(sk["work_skew_max_over_mean"], V, R, t_step)
    if "work_skew_balanced" in sk:
        eff.update({k + "_workbalanced": v for k, v in scaling_model.efficiency(
            sk["work_skew_balanced"], V, R, t_step).items()})
    return {**sk, "efficiency": eff}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--benches", type=scaling_model.benches_arg, default=scaling_model.BENCHES,
                   help="comma-separated subset of the benchmark worlds")
    p.add_argument("--anchor_world", default="sphere2500",
                   choices=sorted(roofline.STAND_INS))
    p.add_argument("--anchor_iters", type=int, default=scaling_bench.NUM_ITERS)
    common.add_args(p)
    a = common.parse(p, argv, "record_scaling_r03")
    card = common.card(a.device)
    log(f"card {card}; on {a.device}")
    anchor = scaling_model.anchor(a.anchor_world, a.anchor_iters, a.device)
    t_step = anchor["step_s"]
    log(f"anchor: M = 1 spmd step {t_step * 1e3:.4f} ms ({a.anchor_world})")
    rows = {}
    for name, R, kind in a.benches:
        rows[f"{name}_{R}robot"] = row = bench_row(name, R, kind, t_step)
        log(f"{name}@{R}: skew {row['work_skew_max_over_mean']:.3f}, sep "
            f"{row['separator_poses']}, eff {row['efficiency']}")
    out = {"model": scaling_model.MODEL, "links": scaling_model.LINKS,
           "anchor": anchor, "benchmarks": rows, "card": card, "device": a.device}
    return common.emit(out, a.out)


if __name__ == "__main__":
    main()
