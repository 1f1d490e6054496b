"""Disk checkpoint and resume of solver state.

Port of ``dpgo_ros_tpu/utils/checkpoint.py``. A checkpoint is a directory
holding ``meta.json`` (``format``, ``backend``, ``state_class``,
``fields``, ``dtypes`` and the caller's ``meta``) beside the arrays: one
per field of the state NamedTuple, plus ``__ylift__`` for the engine's
lifting matrix. Host ints (the port's iteration counters) are written as
int32 0-d arrays, as JAX's are.

Backends:

* ``npz`` (default) — ``state.npz``, the JAX package's format, so that
  each package reads the other's checkpoints. Host-local; right for the
  single-process engine, fused, async and spmd paths.
* ``dcp`` — ``torch.distributed.checkpoint`` under ``dcp/`` (one
  ``__<rank>_0.distcp`` file per writing rank and a ``.metadata`` file):
  the counterpart of the JAX package's ``orbax`` backend, for a
  multi-process run whose processes each hold the state. Device tensors
  are saved as they are (DCP stages them) and loaded straight into
  tensors on the caller's device. When a ``torch.distributed`` process
  group is initialized, :func:`save_state` and :func:`load_state` are
  collective: every process calls them with the same replicated state, as
  each JAX host calls Orbax, DCP's planner writes each entry once, and the
  path must lie on a filesystem every process sees. A dcp save or load
  made by one rank alone under a group waits at its first barrier for
  ever (the CLI's spmd mode saves from rank 0 and so stays on npz).
  Without a group DCP runs in the one process. ``scripts/dcp_check.py``
  checks a collective save and load bit for bit (gloo, or NCCL with a
  card per process: ``scripts/multicard_check.py`` runs it on every card
  of one host). Its files are not Orbax's (which imports jax and writes
  its own OCDBT layout): neither package reads the other's sharded
  checkpoints, and an ``orbax`` checkpoint raises here.

* :func:`save_state` / :func:`load_state` — one state to or from a
  directory (written to ``path.tmp`` and swapped in).
* :class:`CheckpointManager` — ``root/step_<N>`` every ``every`` steps
  with retention; ``latest()`` finds the newest for ``--resume latest``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_META_NAME = "meta.json"
_ARRAYS_NAME = "state.npz"
_DCP_NAME = "dcp"
_STEP_RE = re.compile(r"^step_(\d+)$")


def _check_backend(backend: str) -> None:
    if backend == "orbax":
        raise NotImplementedError(
            "the orbax checkpoint backend has no counterpart in dpgo_ros_tpu_torch: "
            "Orbax imports jax and writes its own OCDBT layout; use backend=\"dcp\" "
            "(torch.distributed.checkpoint) for a multi-process run, or npz")
    if backend not in ("npz", "dcp"):
        raise ValueError(f"unknown checkpoint backend {backend!r}")


def _collective(backend: str) -> bool:
    """A dcp save or load that every process of the group joins."""
    import torch.distributed as dist

    return backend == "dcp" and dist.is_available() and dist.is_initialized()


def _writer(backend: str) -> bool:
    """Whether this process writes ``meta.json`` and moves directories:
    rank 0 of a collective save, else the caller."""
    import torch.distributed as dist

    return not _collective(backend) or dist.get_rank() == 0


def _barrier(backend: str) -> None:
    if _collective(backend):
        import torch.distributed as dist

        dist.barrier()


def _dcp_call(fn, state_dict, path: str) -> None:
    """``torch.distributed.checkpoint.save`` / ``load`` at ``path``: across
    the group when there is one, else in this process (without DCP's
    warning that it assumes so)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        fn(state_dict, checkpoint_id=path, no_dist=not _collective("dcp"))


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, (bool, np.bool_)):
        return np.asarray(v)
    if isinstance(v, (int, np.integer)):
        return np.asarray(v, np.int32)
    return np.asarray(v)


def _tensor(v) -> torch.Tensor:
    """A value as the dcp backend saves it: a tensor as it is (on its
    device), anything else as :func:`_host` converts it for npz."""
    return v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(_host(v))


def save_state(
    path: str,
    state,
    ylift=None,
    meta: Optional[Dict[str, Any]] = None,
    backend: str = "npz",
) -> str:
    """Write one checkpoint to directory ``path`` (replaced if present).

    ``state`` is a NamedTuple of tensors, arrays or ints (``RBCDState``,
    ``SpmdState``, ``ASAPPState``, or a host copy of one); ``ylift`` the
    engine's lifting matrix (needed to round a restored iterate the same
    way); ``meta`` JSON-serializable run metadata; ``backend`` ``npz`` or
    ``dcp`` (collective under a process group: every rank calls it; see
    the module)."""
    _check_backend(backend)
    tmp = path + ".tmp"
    writer = _writer(backend)
    if writer:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
    values = state._asdict()
    if ylift is not None:
        values["__ylift__"] = ylift
    if backend == "npz":
        arrays = {k: _host(v) for k, v in values.items()}
        np.savez(os.path.join(tmp, _ARRAYS_NAME), **arrays)
    else:
        import torch.distributed.checkpoint as dcp

        arrays = {k: _tensor(v) for k, v in values.items()}
        _barrier(backend)  # rank 0 has made path.tmp
        _dcp_call(dcp.save, arrays, os.path.join(tmp, _DCP_NAME))
    if writer:
        doc = {
            "format": 1,
            "backend": backend,
            "state_class": type(state).__name__,
            "fields": list(state._fields),
            "dtypes": {k: str(v.dtype).removeprefix("torch.") for k, v in arrays.items()},
            "meta": meta or {},
        }
        with open(os.path.join(tmp, _META_NAME), "w") as f:
            json.dump(doc, f, indent=1)
        # swap so that a crash mid-save never corrupts the latest checkpoint
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
    _barrier(backend)  # no process returns before the swap
    return path


def _load_dcp(path: str, device) -> Dict[str, Any]:
    """The dcp entries at ``path``: floating ones read straight into
    tensors on ``device``, the rest (and everything without ``device``)
    as numpy arrays."""
    import torch.distributed.checkpoint as dcp

    entries = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    out = {}
    for k, m in entries.items():
        dt = m.properties.dtype
        on = device if device is not None and dt.is_floating_point else "cpu"
        out[k] = torch.empty(m.size, dtype=dt, device=on)
    _dcp_call(dcp.load, out, path)
    on_device = device is not None
    return {k: v if on_device and v.is_floating_point() else v.numpy()
            for k, v in out.items()}


def _place(v, device, dtype):
    """A floating array (or a floating tensor the dcp reader put on
    ``device``) as a tensor on ``device`` (in ``dtype`` if given), a 0-d
    integer array as an int, any other array as a CPU tensor (e.g. a
    generator state)."""
    if isinstance(v, torch.Tensor) or np.issubdtype(v.dtype, np.floating):
        return torch.as_tensor(v, dtype=dtype, device=device)
    if v.ndim == 0 and np.issubdtype(v.dtype, np.integer):
        return int(v)
    return torch.as_tensor(v)


def load_state(
    path: str, state_cls=None, *, device=None, dtype: Optional[torch.dtype] = None
) -> Tuple[Any, Optional[np.ndarray], Dict[str, Any]]:
    """Load a checkpoint directory → (state, ylift, meta), whichever
    backend wrote it (a dcp checkpoint collectively under a process group).

    ``state_cls`` defaults to ``RBCDState``. With ``device`` the state's
    floating fields are tensors there (``dtype``: default the saved one),
    0-d integers ints, other arrays CPU tensors; without it every field is
    the saved numpy array (a host state, e.g. for
    ``spmd.place_state``). ``ylift`` is numpy or None."""
    with open(os.path.join(path, _META_NAME)) as f:
        doc = json.load(f)
    _check_backend(doc["backend"])
    if doc["backend"] == "npz":
        with np.load(os.path.join(path, _ARRAYS_NAME)) as z:
            arrays = {k: z[k] for k in z.files}
    else:
        arrays = _load_dcp(os.path.join(path, _DCP_NAME), device)
    ylift = arrays.pop("__ylift__", None)
    if isinstance(ylift, torch.Tensor):
        ylift = ylift.cpu().numpy()
    if state_cls is None:
        from dpgo_ros_tpu_torch.parallel.rbcd import RBCDState

        state_cls = RBCDState
    missing = [f for f in state_cls._fields if f not in arrays]
    if missing:
        raise ValueError(
            f"checkpoint at {path} missing fields {missing} for {state_cls.__name__}")
    if device is None:
        return state_cls(**{f: arrays[f] for f in state_cls._fields}), ylift, doc.get("meta", {})
    state = state_cls(**{f: _place(arrays[f], device, dtype) for f in state_cls._fields})
    return state, ylift, doc.get("meta", {})


class CheckpointManager:
    """Periodic checkpoints under ``root/step_<N>`` with retention.

    >>> mgr = CheckpointManager(root, every=50, max_to_keep=3)
    >>> eng.run(st, callback=lambda it, s: mgr.maybe_save(s.iteration, s, eng.Ylift))
    >>> step, path = mgr.latest()

    With ``backend="dcp"`` under a process group every process calls
    :meth:`save` (a collective :func:`save_state`); rank 0 retires the old
    steps and a barrier holds the others until it has.
    """

    def __init__(self, root: str, every: int = 0, max_to_keep: int = 3,
                 backend: str = "npz"):
        _check_backend(backend)
        self.root = root
        self.every = every
        self.max_to_keep = max_to_keep
        self.backend = backend
        os.makedirs(root, exist_ok=True)

    def step_path(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step}")

    def save(self, step: int, state, ylift=None, meta=None) -> str:
        meta = dict(meta or {})
        meta["step"] = int(step)
        p = save_state(self.step_path(step), state, ylift, meta, backend=self.backend)
        self._retain()
        return p

    def maybe_save(self, step: int, state, ylift=None, meta=None):
        """Callback-friendly: saves when ``step`` hits the cadence."""
        if self.every > 0 and step > 0 and step % self.every == 0:
            return self.save(step, state, ylift, meta)
        return None

    def steps(self):
        out = []
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            if m and os.path.isfile(os.path.join(self.root, name, _META_NAME)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[Tuple[int, str]]:
        s = self.steps()
        if not s:
            return None
        return s[-1], self.step_path(s[-1])

    def _retain(self):
        if _writer(self.backend):
            s = self.steps()
            for old in s[: max(0, len(s) - self.max_to_keep)]:
                shutil.rmtree(self.step_path(old), ignore_errors=True)
        _barrier(self.backend)  # no rank lists the steps mid-deletion
