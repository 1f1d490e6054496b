"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Every input is made with numpy from a seed and handed to both packages, so
the JAX reference and the port compute on identical data.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib.util
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from dpgo_ros_tpu_torch.io.synthetic import generate_world
from dpgo_ros_tpu_torch.utils import config as t_config

# The port's CPU paths run many small ops; under the test runner's parallel
# workers one intra-op thread per process is faster than oversubscribing
# the cores.
torch.set_num_threads(1)

WORLDS = {
    "sphere256": dict(kind="sphere", n=256, num_robots=3, seed=0),
    "grid3d4": dict(kind="grid3d", grid_shape=(4, 4, 4), num_robots=2, seed=1),
}


def world(name: str):
    """(data, ground truth (n, 3, 4)) of a named small synthetic world."""
    data, gt, _ = generate_world(**WORLDS[name])
    return data, gt


def port_config(cfg) -> t_config.AgentConfig:
    """The port's ``AgentConfig`` with the fields of ``cfg``, a JAX-package
    ``AgentConfig`` that a test also hands to the JAX engine; enum members
    are mapped by value."""
    kinds = {"update_rule": t_config.UpdateRule,
             "local_initialization_method": t_config.InitMethod,
             "robust_cost_type": t_config.RobustCostType,
             "solver": t_config.SolverMethod}
    out = {}
    for f in dataclasses.fields(t_config.AgentConfig):
        v = getattr(cfg, f.name)
        if f.name in kinds and v is not None:
            v = kinds[f.name](v.value if isinstance(v, enum.Enum) else v)
        out[f.name] = v
    return t_config.AgentConfig(**out)


def rel_err(a, b) -> float:
    """max |a − b| / max |b| over finite entries; non-finite entries (a
    robot's rel change is inf until it first updates) must match exactly,
    else the error is inf."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    fin = np.isfinite(b)
    if a.shape != b.shape or not np.array_equal(a[~fin], b[~fin], equal_nan=True):
        return float("inf")
    a, b = a[fin], b[fin]
    if not b.size:
        return 0.0
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def random_state(n: int, r: int, d: int, seed: int, p_scale: float = 1.0):
    """(n, r, d+1) lifted state: sign-fixed QR Stiefel blocks + Gaussian p."""
    rng = np.random.default_rng(seed)
    Q, R = np.linalg.qr(rng.standard_normal((n, r, d)))
    s = np.sign(np.diagonal(R, axis1=-2, axis2=-1))
    Y = Q * np.where(s == 0, 1.0, s)[:, None, :]
    p = p_scale * rng.standard_normal((n, r, 1))
    return np.concatenate([Y, p], axis=-1)


def noisy_lifted_gt(gt: np.ndarray, r: int, seed: int, noise: float = 0.05):
    """Ground truth lifted through a random YLift plus ambient noise — a
    state near the optimum, like the solver's iterates."""
    rng = np.random.default_rng(seed)
    Yl, _ = np.linalg.qr(rng.standard_normal((r, gt.shape[1])))
    X = np.einsum("rd,ndk->nrk", Yl, gt)
    return X + noise * rng.standard_normal(X.shape)


def load_jax_script(name: str):
    """The JAX package's ``scripts/<name>.py`` as a module, without the
    persistent-cache settings it makes at import (they would move the test
    worker's JAX cache) and without the sys.path entries it adds."""
    import jax

    path = Path(__file__).resolve().parent.parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    with mock.patch.object(jax.config, "update"):
        spec.loader.exec_module(mod)
    sys.path[:] = saved
    return mod
