"""Collective ``dcp`` checkpoint check: launch once per process.

N processes join one ``torch.distributed`` group
(``parallel/multihost.py``: NCCL where each process has a card of its
own, gloo on the CPU or where they share a card), each builds the same
engine state (an ``RBCDState`` of random fields at ``--n`` poses, rank 5,
d = 3, and a lifting matrix, from one fixed seed) on ``--device``, saves
it collectively twice with ``utils/checkpoint.save_state(...,
backend="dcp")`` (the first save pays DCP's imports and set-up; the second
replaces it), loads it back collectively with the device and without, and
checks every field bit for bit against what it saved (any mismatch exits
nonzero).

    python -m dpgo_ros_tpu_torch.scripts.dcp_check --num_processes 2 \\
        --process_id 0 --coordinator localhost:12361 --path /tmp/ck --device cpu &
    python -m dpgo_ros_tpu_torch.scripts.dcp_check --num_processes 2 \\
        --process_id 1 --coordinator localhost:12361 --path /tmp/ck --device cpu

Prints one parseable line per process:

    DCP_RESULT {"process_id": i, "num_processes": N, "backend": ...,
                "device": ..., "first_save_ms": ..., "save_ms": ...,
                "load_ms": ..., "files": [...], "dcp_files": [...]}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from dpgo_ros_tpu_torch.parallel import multihost
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDState, state_from_numpy
from dpgo_ros_tpu_torch.utils import checkpoint as ckpt

SEED = 0


def random_state(n: int, dtype, device) -> tuple:
    """(RBCDState, YLift) of random fields: the same on every process."""
    rng = np.random.default_rng(SEED)
    r, d, robots, edges = 5, 3, 5, 2 * n
    shapes = dict(X=(n, r, d + 1), X_prev=(n, r, d + 1), V=(n, r, d + 1), theta=(),
                  cost=(), rel_change=(robots,), weights=(edges,), fixed_mask=(edges,),
                  mu=())
    arrays = {k: rng.standard_normal(s) for k, s in shapes.items()}
    arrays.update(iteration=int(rng.integers(1, 1000)),
                  weight_update_count=int(rng.integers(0, 10)))
    ylift = torch.as_tensor(rng.standard_normal((r, d)), dtype=dtype, device=device)
    return state_from_numpy(arrays, dtype=dtype, device=device), ylift


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        b = torch.as_tensor(b)
        return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    return int(a) == int(b)


def synced_ms(fn, device) -> tuple:
    """(fn(), its wall ms; a card synchronised on both sides)."""
    if device.type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="localhost:12361")
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--path", required=True, help="the checkpoint directory (shared)")
    ap.add_argument("--n", type=int, default=2500, help="poses of the state")
    ap.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    a = ap.parse_args(argv)
    mesh = multihost.initialize(a.coordinator, a.num_processes, a.process_id,
                                device=a.device)
    dev, dtype = mesh.device, getattr(torch, a.dtype)
    try:
        st, ylift = random_state(a.n, dtype, dev)
        first_ms, save_ms = (synced_ms(lambda: ckpt.save_state(
            a.path, st, ylift, {"n": a.n}, backend="dcp"), dev)[1] for _ in range(2))
        (on_dev, yl, meta), load_ms = synced_ms(
            lambda: ckpt.load_state(a.path, device=dev), dev)
        host, _, _ = ckpt.load_state(a.path)
    finally:
        multihost.shutdown()
    assert meta == {"n": a.n}, meta
    assert np.array_equal(yl, ylift.cpu().numpy())
    for f in RBCDState._fields:
        v = getattr(on_dev, f)
        assert _same(getattr(st, f), v), f
        assert not isinstance(v, torch.Tensor) or v.device == dev, (f, v.device)
        assert _same(getattr(st, f), getattr(host, f)), f
    out = {"process_id": a.process_id, "num_processes": a.num_processes,
           "backend": mesh.backend, "device": str(dev), "first_save_ms": first_ms,
           "save_ms": save_ms, "load_ms": load_ms,
           "files": sorted(os.listdir(os.path.dirname(os.path.abspath(a.path)))),
           "dcp_files": sorted(os.listdir(os.path.join(a.path, "dcp")))}
    print("DCP_RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
