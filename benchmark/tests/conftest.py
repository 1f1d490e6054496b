"""Shared helpers of the benchmark's tests: runs of a cell shrunk for the
CPU, through the harness with the look for a card skipped."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

# small worlds on the CPU (the program's plain versions): name -> overrides
SMALL = {
    "dpgo_demo.warm": ({"n": 100}, {}),
    "dpgo_demo.warm_fused": ({"n": 100}, {}),
    "dpgo_gnc_demo.cold": ({"n": 160}, {"robust_opt_inner_iters_per_robot": 5}),
}


@pytest.fixture(scope="session")
def manifest():
    return harness.load_json(ROOT / "BENCHMARK.json")


def small_run(manifest, cell, seed=2**31 + 5, seconds=0.3, trace=False):
    world, solver = SMALL[cell]
    return harness.run_cell(manifest, cell, seed, seconds, trace, device="cpu",
                            world_override=world, solver_override=solver,
                            log=lambda m: None)
