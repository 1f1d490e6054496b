"""What the port's measurement scripts share.

Every script of this directory runs on the card unless the caller passes
``--device cpu``, prints progress on stderr and one JSON line on stdout,
names the card and its power limit in that line, and writes the line to
``--out`` only where the caller names a path, which must not be one of the
repository's root records (``*.json`` and ``*.jsonl`` at its root: the JAX
package's TPU records and the ledger).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional

import torch
from torch.overrides import TorchFunctionMode

from dpgo_ros_tpu_torch.ops import fused_asapp, fused_rtr, hbm_rtr, peak_chains
from dpgo_ros_tpu_torch.scripts import measure_peaks

REPO = Path(__file__).resolve().parents[2]
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def log(msg: str) -> None:
    print(f"# [{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def add_args(p: argparse.ArgumentParser, dtype: str = "float32") -> None:
    """``--device``, ``--dtype`` and ``--out``."""
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the card (default) or the CPU (plain versions of the kernels)")
    p.add_argument("--dtype", choices=tuple(DTYPES), default=dtype)
    p.add_argument("--out", help="also write the JSON line here (never a root record)")


def ints(text: str) -> tuple:
    """A comma-separated list of integers (an argument type)."""
    return tuple(int(v) for v in text.split(","))


def is_root_record(path: str) -> bool:
    """Whether ``path`` resolves to a JSON record at the repository's root."""
    r = Path(path).resolve()
    return r.parent == REPO and r.suffix in (".json", ".jsonl")


def parse(p: argparse.ArgumentParser, argv, who: str):
    """Parsed arguments, after the shared checks: ``--out`` is no root
    record, and without ``--device cpu`` the card is there (else exit)."""
    a = p.parse_args(argv)
    if getattr(a, "out", None) and is_root_record(a.out):
        p.error(f"--out {a.out}: the repository's root records are not this "
                "script's to write")
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{who}: needs a CUDA device (torch.cuda.is_available() is "
                         "false); --device cpu runs the kernels' plain versions")
    return a


def card(device) -> dict:
    """The card's name and power limit (nvidia-smi), or the CPU's stand-in
    entry with no power limit."""
    if torch.device(device).type == "cuda":
        return measure_peaks.card()
    return {"name": "cpu", "power_limit": None, "torch": torch.__version__, "cuda": None}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def emit(obj: dict, out: Optional[str] = None) -> dict:
    """Print ``obj`` as one JSON line on stdout; also write it to ``out``."""
    line = json.dumps(obj)
    print(line, flush=True)
    if out:
        Path(out).write_text(line + "\n")
    return obj


def counts() -> dict:
    """Every kernel wrapper's launch counter (K1–K6)."""
    return {"k1": fused_rtr.LAUNCHES, "k2": fused_rtr.RUN_LAUNCHES,
            "k3": fused_asapp.TICK_LAUNCHES, "k4": hbm_rtr.LAUNCHES,
            "k5": peak_chains.LAUNCHES, "k6": peak_chains.CML_LAUNCHES}


def launched(before: dict) -> dict:
    """The launches of each kernel since ``before`` (a :func:`counts`)."""
    return {k: v - before[k] for k, v in counts().items()}


# the Tensor methods that hand a value to the host (``numpy`` is left out:
# it only views a CPU tensor, and the read was the ``cpu`` before it)
_READS = {"cpu", "tolist", "item", "__float__", "__int__", "__bool__", "__index__",
          "equal"}


def _is_cpu(x) -> bool:
    return isinstance(x, (str, torch.device)) and torch.device(x).type == "cpu"


class _ReadCounter(TorchFunctionMode):
    def __init__(self, device):
        super().__init__()
        self.type, self.reads = torch.device(device).type, 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in _READS or (name == "to" and any(
                _is_cpu(x) for x in (*args[1:], kwargs.get("device")))):
            if any(isinstance(x, torch.Tensor) and x.device.type == self.type
                   for x in args):
                self.reads += 1
        return func(*args, **kwargs)


def host_reads(fn, device) -> int:
    """The values ``fn()`` reads from ``device`` into Python: calls of a
    Tensor method that hands a value to the host (``cpu``, ``to`` the CPU,
    ``tolist``, ``item``, ``float``/``int``/``bool``, ``torch.equal``) on a
    tensor on ``device``, counted by a TorchFunctionMode. A read inside a
    C++ operation (the size of a ``nonzero``) is not seen. Meant for the
    card: on the CPU the kernels' plain versions make reads of their own."""
    with _ReadCounter(device) as mode:
        fn()
    return mode.reads
