"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout; the cells are ``BENCHMARK.json``'s workloads.
Set-up builds the cell's kernels (into the program's build directory inside
the checkout), makes the cell's graphs from ``--seed`` and warms up; the
window then runs requests back to back for ``--seconds``; the reference
checks a sample of the answers. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, ``breakdown`` in a traced run, and ``checks``: each number
compared with its limit, which also end standard error). Exits nonzero and
prints no result without a CUDA device, or if a JAX module was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "benchmark_cache"
# the kernel caches of the libraries the program may use, at fixed paths
# inside the checkout (the program's own nvcc builds go to build/dpgo_ros_tpu_torch)
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    if a.seed < 0:
        p.error("--seed must be a non-negative integer")

    import torch

    from benchmark import harness

    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in manifest["workloads"] if w["name"] == a.workload), None)
    if cell is None:
        log(f"unknown workload {a.workload!r}")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"{a.workload} needs {cell['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 3
    try:
        out = harness.run_cell(manifest, a.workload, a.seed, a.seconds, bool(a.trace),
                               device="cuda", t_start=T_START, log=log)
    except harness.ForbiddenImport as e:
        log(str(e))
        return 4
    bad = harness.forbidden_modules()  # the last look, as the result is printed
    if bad:
        log(str(harness.ForbiddenImport(bad)))
        return 4
    for k, c in out["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
