"""Multi-process spmd runs of the port (``parallel/multihost.py``,
``scripts/multihost_demo.py``) on the CPU with gloo.

The demo runs as real subprocesses (one per rank, a free localhost port
for the rendezvous, one intra-op thread each): 2 processes × 2 slots form
the same 4-slot mesh as 1 process × 4 slots, and the gathered final X is
bit-identical (the exchange and the GNC gathers only move data; every
slot's solve is the same computation). A 2 × 2 run stopped at step 12
with its gathered state checkpointed, then resumed by a fresh pair of
processes, ends bit-identical to the uninterrupted 24-step run.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dpgo_ros_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = ["-m", "dpgo_ros_tpu_torch.scripts.multihost_demo", "--device", "cpu",
        "--synthetic", "sphere", "--synthetic_n", "400"]


def _launch(num_processes, local, steps, x_out, *extra):
    """Start one demo process per rank; returns the Popen list."""
    port = multihost.free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [
        subprocess.Popen(
            [sys.executable, *DEMO, "--num_processes", str(num_processes),
             "--process_id", str(pid), "--coordinator", f"localhost:{port}",
             "--local_devices", str(local), "--steps", str(steps),
             "--x_out", x_out, *extra],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(num_processes)
    ]


def _results(procs):
    out = []
    for pid, p in enumerate(procs):
        try:
            so, se = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"proc {pid} failed:\n{se[-3000:]}"
        line = [l for l in so.splitlines() if l.startswith("MULTIHOST_RESULT")]
        assert line, so[-2000:]
        out.append(json.loads(line[0].split(" ", 1)[1]))
    return out


def test_two_processes_match_one_bitwise_and_resume(tmp_path):
    one, two = str(tmp_path / "one.npy"), str(tmp_path / "two.npy")
    part, resumed = str(tmp_path / "part.npy"), str(tmp_path / "resumed.npy")
    ck = str(tmp_path / "ck")
    single = _launch(1, 4, 24, one)
    pair = _launch(2, 2, 24, two)
    first = _launch(2, 2, 12, part, "--checkpoint_dir", ck)
    r1, r2, r3 = _results(single), _results(pair), _results(first)
    assert r1[0]["global_devices"] == r2[0]["global_devices"] == 4
    assert r2[0]["num_processes"] == 2
    # every process observes the same global state
    assert r2[0]["final_cost"] == r2[1]["final_cost"] == r1[0]["final_cost"]
    assert r1[0]["init_cost"] == r2[1]["init_cost"]
    assert r1[0]["final_cost"] < 0.1 * r1[0]["init_cost"]
    assert np.array_equal(np.load(one), np.load(two))
    assert os.path.isfile(os.path.join(ck, "meta.json"))
    r4 = _results(_launch(2, 2, 24, resumed, "--resume", ck))
    assert r4[0]["final_cost"] == r4[1]["final_cost"] == r1[0]["final_cost"]
    assert np.array_equal(np.load(resumed), np.load(one))
    assert not np.array_equal(np.load(part), np.load(one))


def test_one_process_mesh_has_no_group():
    try:
        mesh = multihost.initialize("localhost:1", 1, 0, local_slot_count=5, device="cpu")
        assert mesh.backend is None and multihost.global_slots() == 5
        assert not multihost.is_multihost()
        assert list(mesh.slots(3)) == [0, 1, 2] and list(mesh.slots(5)) == list(range(5))
        with pytest.raises(ValueError):
            mesh.slots(6)
    finally:
        multihost.shutdown()
    assert multihost.global_slots() == 1


def test_slot_ranges_are_process_contiguous():
    meshes = [multihost.SlotMesh(3, p, 2, None) for p in range(3)]
    assert [list(m.slots(6)) for m in meshes] == [[0, 1], [2, 3], [4, 5]]
    assert [list(m.slots(3)) for m in meshes] == [[0, 1], [2], []]


def test_multicard_check_needs_cards():
    """The multi-card check (N processes on N cards, NCCL) refuses to run
    without a card and prints no result."""
    from dpgo_ros_tpu_torch.scripts import multicard_check

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert multicard_check.main() == 1
