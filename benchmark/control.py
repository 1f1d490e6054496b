"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 [--program 1] [--seconds S]

For each seed, on the cell's graphs made from it as a run makes them:

* the control: the configuration's plain reference (``references/<name>.py``,
  its ``solve`` with ``control=True``: for ``reference.py``, TF32 products in
  float32) computed in the program's place, judged against the reference
  in its own precision by the cell's numbers — the upper readings;
* with ``--program 1``: a short run of the cell itself (its window
  ``--seconds``), whose checks are the program's lower readings; all seeds
  in one process, so that set-up is paid once for the kernels.

Prints one JSON line per seed and reading. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from benchmark import compare, harness, world


def control_numbers(cell: harness.Cell, seed: int, device) -> dict:
    t = cell.traffic
    plain = cell.reference
    pool = int(t["pool"])
    gi = int(np.random.default_rng([seed, 13]).integers(pool))
    base = int(t["world_seed"]) + gi
    g = world.generate_world(**cell.config["world"], seed=base)
    cfg = cell.config["solver"]
    Y = plain.lifting_matrix(base, int(cfg["relaxation_rank"]), g["R"].shape[-1])
    t0 = time.perf_counter()
    ctl = plain.solve(g, cfg, Y, control=True, device=device)
    t1 = time.perf_counter()
    nums = compare.state_numbers(ctl, g, cell.config, plain)
    if ctl.get("stages") is not None:  # judged stage by stage, as the program's
        nums.update(plain.follow(g, cfg, Y, ctl["stages"], device=device))
        ref = None
    else:
        ref = plain.solve(g, cfg, Y, device=device)
        nums.update(compare.request_numbers(ctl, ref))
    t2 = time.perf_counter()
    return {"seed": seed, "graph": gi, "reading": "control", "numbers": nums,
            "control_s": t1 - t0, "reference_s": t2 - t1,
            "control_iterations": ctl["iterations"],
            "ref_iterations": ref["iterations"] if ref else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", type=int, default=0)
    p.add_argument("--control", type=int, default=1)
    p.add_argument("--seconds", type=float, default=5.0)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.Cell.load(manifest, a.workload, False)
    seeds = [int(s) for s in a.seeds.split(",")]
    log = lambda m: print(m, file=sys.stderr, flush=True)
    for seed in seeds:
        if a.program:
            out = harness.run_cell(manifest, a.workload, seed, a.seconds, False, log=log)
            print(json.dumps({"seed": seed, "reading": "program", "correct": out["correct"],
                              "attempted": out["attempted"],
                              "numbers": {k: c["value"] for k, c in out["checks"].items()}}),
                  flush=True)
        if a.control:
            print(json.dumps(control_numbers(cell, seed, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
