"""Gauge rotations of a lifted state: a frozen copy of
``dpgo_ros_tpu_torch/scripts/bench.py::make_perturb``'s rotation.

The cost is invariant and the solver equivariant under a left rotation of
the rank space, so a warm request that starts from the set-up's state turned
by its own angle does the same work on other bits; the rounded, anchored
trajectory is the same.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# radians per request index: no two requests of a run start from one state
STEP_RAD = 0.7309


def rotate(X: torch.Tensor, theta: float) -> torch.Tensor:
    """X (n, r, d+1) rotated by ``theta`` in the (0, 1) plane of the rank
    space, on X's device."""
    G = np.eye(X.shape[1])
    G[0, 0] = G[1, 1] = math.cos(theta)
    G[1, 0] = math.sin(theta)
    G[0, 1] = -G[1, 0]
    G = torch.as_tensor(G, dtype=X.dtype, device=X.device)
    return torch.einsum("sr,nrk->nsk", G, X).contiguous()
