"""The spmd mesh program and the dcp checkpoint across cards: N processes
× 1 slot, each on a card of its own (NCCL), against 1 process × N slots
on one card.

Runs ``multihost_demo`` both ways on the synthetic sphere (the CLI's world,
seed 42, one robot per slot) for 24 and 120 steps, twice, after one
untimed step of each (it builds K1), and holds the N-card runs to the
one-card runs: the gathered lifted state and the cost bit-identical. The
separator exchange of the N-card runs is the NCCL branch of
``spmd._gather_slots`` (``all_gather_into_tensor`` on the cards' own
tensors). Each demo times its step loop; the difference between the 120-
and the 24-step loop, over 96, is a step's time with the communicators
already set up (the first ``all_gather`` sets them up).

Then ``dcp_check`` as N processes of one NCCL group, one card each, saves
and loads one replicated engine state through the ``dcp`` checkpoint
backend at 2,500 and 50,000 poses: every process reads it back bit for
bit, and the files are the metadata and one ``.distcp`` per rank.

    python -m dpgo_ros_tpu_torch.scripts.multicard_check   # every card, ≥ 2

Prints the cards (``nvidia-smi``), one ``MULTICARD_CHECK`` JSON line per
repeat, one ``MULTICARD_DCP`` line per checkpoint size, and exits 1 where a
run differs or fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from dpgo_ros_tpu_torch.parallel import multihost

WORLD_N, REPEATS, STEPS = 2500, 2, (24, 120)
DCP_N = (WORLD_N, 50_000)  # poses of the collective checkpoint's state
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run(module: str, num_processes: int, args: list, tag: str) -> list:
    """The ``tag`` JSON line of every process of one run of ``module``."""
    port = multihost.free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"dpgo_ros_tpu_torch.scripts.{module}",
         "--num_processes", str(num_processes), "--process_id", str(pid),
         "--coordinator", f"localhost:{port}", *args],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(num_processes)]
    out = []
    for pid, p in enumerate(procs):
        so, se = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(f"{module} process {pid}/{num_processes} failed:\n{se[-3000:]}")
        line = [l for l in so.splitlines() if l.startswith(tag)]
        out.append(json.loads(line[0].split(" ", 1)[1]))
    return out


def _demo(num_processes: int, local: int, steps: int, x_out: str) -> list:
    """MULTIHOST_RESULT of every process of one demo run."""
    return _run("multihost_demo", num_processes,
                ["--local_devices", str(local), "--synthetic", "sphere",
                 "--synthetic_n", str(WORLD_N), "--steps", str(steps), "--device", "cuda",
                 "--x_out", x_out], "MULTIHOST_RESULT")


def _dcp(N: int, n: int, path: str) -> dict:
    """``dcp_check`` as N processes, one card each (NCCL), at n poses: each
    reads the collective checkpoint back bit for bit (else it fails), and
    the files are the metadata and one ``.distcp`` per rank."""
    rs = _run("dcp_check", N, ["--path", path, "--n", str(n), "--device", "cuda"],
              "DCP_RESULT")
    files = [".metadata"] + [f"__{i}_0.distcp" for i in range(N)]
    ok = (all(r["backend"] == "nccl" and r["dcp_files"] == files for r in rs)
          and sorted(r["device"] for r in rs) == [f"cuda:{i}" for i in range(N)])
    return {"ok": ok, "cards": N, "n": n, "backend": rs[0]["backend"],
            "dcp_files": rs[0]["dcp_files"],
            **{k: [r[k] for r in rs] for k in ("first_save_ms", "save_ms", "load_ms")}}


def main() -> int:
    if not torch.cuda.is_available():
        print("multicard_check: no CUDA device", file=sys.stderr)
        return 1
    N = torch.cuda.device_count()
    if N < 2:
        print("multicard_check: needs two cards or more", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        _demo(1, N, 1, os.path.join(tmp, "one.npy"))
        _demo(N, 1, 1, os.path.join(tmp, "many.npy"))
        for rep in range(REPEATS):
            rec = {"rep": rep, "cards": N, "synthetic_n": WORLD_N}
            for steps in STEPS:
                one = _demo(1, N, steps, os.path.join(tmp, "one.npy"))
                many = _demo(N, 1, steps, os.path.join(tmp, "many.npy"))
                same = (np.array_equal(np.load(os.path.join(tmp, "one.npy")),
                                       np.load(os.path.join(tmp, "many.npy")))
                        and all(r["final_cost"] == one[0]["final_cost"] for r in many))
                ok &= same
                rec[f"steps{steps}"] = dict(
                    bit_identical=same, final_cost=one[0]["final_cost"],
                    one_card_s=one[0]["elapsed_s"],
                    n_cards_s=max(r["elapsed_s"] for r in many))
            a, b = (rec[f"steps{k}"] for k in STEPS)
            rec["steady_step_ms"] = {k: 1e3 * (b[k] - a[k]) / (STEPS[1] - STEPS[0])
                                     for k in ("one_card_s", "n_cards_s")}
            print("MULTICARD_CHECK " + json.dumps(rec), flush=True)
        for n in DCP_N:
            rec = _dcp(N, n, os.path.join(tmp, f"dcp{n}", "ck"))
            ok &= rec["ok"]
            print("MULTICARD_DCP " + json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
