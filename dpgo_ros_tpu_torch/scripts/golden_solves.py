"""Certified optima f* of the stand-in worlds, on the card.

Port of ``scripts/golden_solves.py``. Run from the repository root on a
machine with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.golden_solves [name ...] [--out PATH]

Runs the centralized Riemannian-staircase certified solve
(``models/certified.certified_solve``) in fp64 on the card, with the JAX
script's per-world budgets (:data:`CONFIGS`), on each named world (default:
all six): its file through ``io.datasets`` where it exists, else its
stand-in of ``roofline.STAND_INS``, as one robot (the JAX script's
``num_robots=1``). Each entry holds the JAX script's fields, the card's name
and power limit, and the stand-in's generator arguments (null for a file).
``sesync_published_f`` is null for a stand-in: the published optima belong
to the real files.

Prints progress on stderr and one JSON line ``{name: entry}`` on stdout;
``--out`` also writes it, merged into the file's entries if it exists (a
subset re-run updates only its names). The port's stand-in record is
``dpgo_ros_tpu_torch/scripts/golden_stand_ins.json``; the root
``golden_optima.json`` is the JAX package's and is never written.
``--device cpu`` runs the staircase on the host.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

from dpgo_ros_tpu_torch.models.certified import certified_solve
from dpgo_ros_tpu_torch.scripts import common, roofline
from dpgo_ros_tpu_torch.scripts.common import log

# SE-Sync published global optima (Rosen et al., IJRR 2019, Table 3) of the
# real files of these names: a provenance cross-check for a file only
SESYNC_F = {
    "sphere2500": 1687.0,
    "parking-garage": 1.26,
    "cubicle": 717.1,
    "torus3D": 24227.0,
}

# the JAX script's per-world solver budgets: the ill-conditioned parking
# garage needs a deep tCG budget to grind its long corridor modes
CONFIGS = {
    "tinyGrid3D": dict(),
    "smallGrid3D": dict(),
    "parking-garage": dict(
        rtr_iterations=400, rtr_tcg_iterations=1000, rtr_rounds=40,
        gradnorm_tol=1e-7,
    ),
    "sphere2500": dict(rtr_rounds=30, gradnorm_tol=1e-6),
    "torus3D": dict(rtr_rounds=30, gradnorm_tol=1e-6),
    "cubicle": dict(rtr_rounds=30, gradnorm_tol=1e-6),
}


def golden(name: str, device, dtype, card: dict, verbose: bool = True) -> dict:
    """The entry of one world: its certified solve on ``device``."""
    t0 = time.time()
    data, _, _, stand_in = roofline.load_world(name, num_robots=1)
    with contextlib.redirect_stdout(sys.stderr):  # the staircase's progress
        res = certified_solve(data, verbose=verbose, dtype=dtype, device=device,
                              **CONFIGS[name])
    return {
        "certified_global_optimum": res.cost,
        "rounded_cost": res.rounded_cost,
        "refined_cost": res.refined_cost,
        "certified": res.certified,
        "rank": res.rank,
        "ranks_tried": list(res.ranks_tried),
        "min_eig": res.min_eig,
        "crit_residual": res.crit_residual,
        "sesync_published_f": None if stand_in else SESYNC_F.get(name),
        "wall_sec": round(time.time() - t0, 1),
        "poses": data.total_poses,
        "edges": len(data.measurements),
        "stand_in": stand_in,
        "budget": CONFIGS[name],
        "dtype": str(dtype).replace("torch.", ""),
        "device": str(device),
        "card": card,
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("names", nargs="*", help=f"worlds of {sorted(CONFIGS)} (default all)")
    common.add_args(p, dtype="float64")
    a = common.parse(p, argv, "golden_solves")
    unknown = [n for n in a.names if n not in CONFIGS]
    if unknown:
        p.error(f"unknown datasets {unknown} (choose from {sorted(CONFIGS)})")
    names = a.names or list(CONFIGS)
    device, dtype = a.device, common.DTYPES[a.dtype]
    card = common.card(device)
    results = {}
    for name in names:
        log(f"=== {name} ===")
        results[name] = golden(name, device, dtype, card)
        log(f"{name}: {results[name]}")
    if a.out and Path(a.out).exists():
        merged = json.loads(Path(a.out).read_text())
        merged.update(results)
        results = merged
    return common.emit(results, a.out)


if __name__ == "__main__":
    main()
