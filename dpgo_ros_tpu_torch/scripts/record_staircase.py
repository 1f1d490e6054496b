"""An honest rank ascent of the Riemannian staircase, on the card in fp64.

Port of ``scripts/record_staircase.py``. Run from the repository root on a
machine with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.record_staircase [--out PATH]

Starts the staircase (``models/certified.certified_solve``) AT rank d = 3,
where a poor start lands in a suboptimal critical point that the dual
certificate must reject, so that the escape ascends until the certified
optimum; records the ascent (ranks tried, final and refined cost, min
eigenvalue, the margin guard's verdict) and its agreement (rel 1e-4) with
the world's certified optimum f*, which the script certifies first from
the chordal start at the default rank (``golden_solves.golden``).

World and start: the JAX script's, the tinyGrid3D world (its file where it
exists, else its stand-in of ``roofline.STAND_INS``: the 3 × 3 × 1 grid)
from a random start, seeds 1, 2, ... (at most 29) until one ascends and
certifies. A perturbed chordal start (``certified.initial_point``'s
``"perturbed"``) certifies at rank 3 on both grid stand-ins (seeds 1–3,
tried on the CPU), as the JAX script found parking-garage's chordal start
does: it lies on the SDP's optimal face.

Prints progress on stderr and one JSON line on stdout; exits 1 unless the
recorded run ascended, certified and matched f*. Never writes the root
``STAIRCASE_r04.json`` (the TPU host's record).
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

from dpgo_ros_tpu_torch.models.certified import certified_solve
from dpgo_ros_tpu_torch.scripts import common, golden_solves, roofline
from dpgo_ros_tpu_torch.scripts.common import log

WORLD, INIT, SEEDS = "tinyGrid3D", "random", range(1, 30)


def run_one(name: str, seed: int, init: str, f_star: float, device, dtype) -> dict:
    data, _, _, stand_in = roofline.load_world(name, num_robots=1)
    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):  # the staircase's progress
        res = certified_solve(data, r0=data.d, init=init, init_seed=seed, verbose=True,
                              dtype=dtype, device=device)
    return {
        "dataset": name,
        "init": f"{init} (seed {seed}), r0=d={data.d}",
        "ranks_tried": list(res.ranks_tried),
        "rank_ascended": len(res.ranks_tried) > 1,
        "certified": bool(res.certified),
        "final_cost": res.cost,
        "refined_cost": res.refined_cost,
        "golden_optimum": f_star,
        "matches_golden": abs(res.refined_cost - f_star) <= 1e-4 * max(1.0, abs(f_star)),
        "min_eig": res.min_eig,
        "min_eig_check": res.min_eig_check,
        "margin_verified": bool(res.margin_verified),
        "wall_sec": round(time.time() - t0, 1),
        "stand_in": stand_in,
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_args(p, dtype="float64")
    a = common.parse(p, argv, "record_staircase")
    device, dtype = a.device, common.DTYPES[a.dtype]
    card = common.card(device)
    golden = golden_solves.golden(WORLD, device, dtype, card, verbose=False)
    f_star = golden["certified_global_optimum"]
    log(f"card {card}; {WORLD} f* {f_star!r} (rank {golden['rank']})")
    for seed in SEEDS:
        row = run_one(WORLD, seed, INIT, f_star, device, dtype)
        log(f"seed {seed}: ranks {row['ranks_tried']}, certified {row['certified']}, "
            f"refined cost {row['refined_cost']!r}")
        if row["rank_ascended"] and row["certified"]:
            break
    out = {
        "note": f"Riemannian-staircase rank ascent on {WORLD}: a rank-d solve from "
                f"a {INIT} start lands in a suboptimal critical point, the dual "
                "certificate rejects it and the escape ascends to the certified optimum",
        "golden": golden,
        "rows": [row],
        "ok": row["rank_ascended"] and row["certified"] and row["matches_golden"],
        "card": card,
        "device": str(device),
        "dtype": a.dtype,
    }
    return common.emit(out, a.out)


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
