"""Disk checkpoint and resume of solver state.

Port of ``dpgo_ros_tpu/utils/checkpoint.py``, in the same on-disk format:
a directory holding ``state.npz`` (one array per field of the state
NamedTuple, plus ``__ylift__`` for the engine's lifting matrix) and
``meta.json`` (``format``, ``backend``, ``state_class``, ``fields``,
``dtypes`` and the caller's ``meta``), so that each package reads the
other's checkpoints. Host ints (the port's iteration counters) are written
as int32 0-d arrays, as JAX's are.

* :func:`save_state` / :func:`load_state` — one state to or from a
  directory (written to ``path.tmp`` and swapped in).
* :class:`CheckpointManager` — ``root/step_<N>`` every ``every`` steps
  with retention; ``latest()`` finds the newest for ``--resume latest``.

Only the ``npz`` backend is ported: the JAX package's ``orbax`` backend has
no counterpart here and raises.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_META_NAME = "meta.json"
_ARRAYS_NAME = "state.npz"
_STEP_RE = re.compile(r"^step_(\d+)$")


def _check_backend(backend: str) -> None:
    if backend == "orbax":
        raise NotImplementedError(
            "the orbax checkpoint backend is not ported to dpgo_ros_tpu_torch: use npz")
    if backend != "npz":
        raise ValueError(f"unknown checkpoint backend {backend!r}")


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, (bool, np.bool_)):
        return np.asarray(v)
    if isinstance(v, (int, np.integer)):
        return np.asarray(v, np.int32)
    return np.asarray(v)


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
    way); ``meta`` JSON-serializable run metadata."""
    _check_backend(backend)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    arrays = {k: _host(v) for k, v in state._asdict().items()}
    if ylift is not None:
        arrays["__ylift__"] = _host(ylift)
    doc = {
        "format": 1,
        "backend": backend,
        "state_class": type(state).__name__,
        "fields": list(state._fields),
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "meta": meta or {},
    }
    np.savez(os.path.join(tmp, _ARRAYS_NAME), **arrays)
    with open(os.path.join(tmp, _META_NAME), "w") as f:
        json.dump(doc, f, indent=1)
    # swap so that a crash mid-save never corrupts the latest checkpoint
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def _place(v: np.ndarray, device, dtype):
    """A 0-d integer array as an int, a floating array as a tensor on
    ``device`` (in ``dtype`` if given), any other array as a CPU tensor
    (e.g. a generator state)."""
    if v.ndim == 0 and np.issubdtype(v.dtype, np.integer):
        return int(v)
    if np.issubdtype(v.dtype, np.floating):
        return torch.as_tensor(v, dtype=dtype, device=device)
    return torch.as_tensor(v)


def load_state(
    path: str, state_cls=None, *, device=None, dtype: Optional[torch.dtype] = None
) -> Tuple[Any, Optional[np.ndarray], Dict[str, Any]]:
    """Load a checkpoint directory → (state, ylift, meta).

    ``state_cls`` defaults to ``RBCDState``. With ``device`` the state's
    floating fields are tensors there (``dtype``: default the saved one),
    0-d integers ints, other arrays CPU tensors; without it every field is
    the saved numpy array (a host state, e.g. for
    ``spmd.place_state``). ``ylift`` is numpy or None."""
    with open(os.path.join(path, _META_NAME)) as f:
        doc = json.load(f)
    _check_backend(doc["backend"])
    with np.load(os.path.join(path, _ARRAYS_NAME)) as z:
        arrays = {k: z[k] for k in z.files}
    ylift = arrays.pop("__ylift__", None)
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
        s = self.steps()
        for old in s[: max(0, len(s) - self.max_to_keep)]:
            shutil.rmtree(self.step_path(old), ignore_errors=True)
