"""Shared helpers of the benchmark's tests: runs of a cell shrunk for the
CPU, through the harness with the look for a card skipped."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

SMALL_DIR = Path(__file__).resolve().parent / "small"


def cells():
    """Every cell of ``BENCHMARK.json``, by name."""
    return sorted(w["name"] for w in harness.load_json(ROOT / "BENCHMARK.json")["workloads"])


def small(cell):
    """(world, solver) overrides that shrink ``cell`` for the program's
    plain versions on the CPU: ``small/<cell>.json``."""
    path = SMALL_DIR / f"{cell}.json"
    if not path.is_file():
        pytest.fail(f"{cell}: add benchmark/tests/small/{cell}.json, its shrink for the CPU")
    s = harness.load_json(path)
    return s.get("world", {}), s.get("solver", {})


@pytest.fixture(scope="session")
def manifest():
    return harness.load_json(ROOT / "BENCHMARK.json")


def small_run(manifest, cell, seed=2**31 + 5, seconds=0.3, trace=False):
    world, solver = small(cell)
    return harness.run_cell(manifest, cell, seed, seconds, trace, device="cpu",
                            world_override=world, solver_override=solver,
                            log=lambda m: None)
