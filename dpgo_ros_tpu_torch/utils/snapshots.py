"""Mid-run observability: periodic trajectory snapshots.

Port of ``dpgo_ros_tpu/utils/snapshots.py``. The reference republishes
trajectories and loop-closure markers while a solve runs: a 30 s
visualization timer (``src/PGOAgentROS.cpp:85-86``) republishes
PoseArray/Path/markers (``:622-660, 756-851``). :class:`SnapshotWriter` is
that timer for the host-loop runners (engine, spmd, async, fleet): every
``interval_sec`` of wall time, or every ``interval_iters`` iterations, it
rounds the current lifted state and writes

* ``snap_iter<NNNNNN>.tum`` — the global trajectory at that iteration,
* ``latest.html`` — a progressive HTML frame (robot-coloured, with the GNC
  loop-closure overlay when weights are given), atomically replaced,
* a row of ``snapshots.csv`` — iteration, wall seconds, cost, file.

A snapshot reads the state back to the host; the callers test
:meth:`SnapshotWriter._due` first, so that an iteration that writes none
reads nothing. CLI: ``--viz_interval SECONDS`` (0 disables),
``--viz_interval_iters N``, ``--viz_dir``.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from dpgo_ros_tpu_torch.ops import rounding
from dpgo_ros_tpu_torch.utils import export, viz


class SnapshotWriter:
    """Periodic trajectory snapshot writer for host-driven runs."""

    def __init__(
        self,
        directory: str,
        data,
        interval_sec: float = 30.0,
        interval_iters: Optional[int] = None,
        html: bool = True,
    ):
        self.dir = directory
        self.data = data
        self.interval_sec = float(interval_sec)
        self.interval_iters = interval_iters
        self.html = html
        self.count = 0
        self._t0 = time.time()
        self._last_t = self._t0
        self._last_it = None
        os.makedirs(directory, exist_ok=True)
        self._manifest = os.path.join(directory, "snapshots.csv")
        with open(self._manifest, "w") as f:
            f.write("iteration,wall_sec,cost,file\n")

    def _due(self, iteration: int) -> bool:
        if self.interval_iters is not None:
            if (
                self._last_it is None
                or iteration - self._last_it >= self.interval_iters
            ):
                return True
        if self.interval_sec > 0:
            return (time.time() - self._last_t) >= self.interval_sec
        return False

    def maybe_snapshot(
        self,
        iteration: int,
        X,
        weights=None,
        cost: Optional[float] = None,
    ) -> bool:
        """Write a snapshot if one is due. ``X`` is the lifted state
        (n, r, d+1) — rounded here — or an already-rounded (n, d, d+1)
        trajectory, a tensor (on any device) or an array."""
        if not self._due(iteration):
            return False
        self.snapshot(iteration, X, weights=weights, cost=cost)
        return True

    def snapshot(self, iteration, X, weights=None, cost=None) -> str:
        """Write one snapshot now; returns the TUM file's name. A lifted
        tensor is rounded on its own device and read back once."""
        d = self.data.d
        if X.shape[1] != d:  # lifted (n, r, d+1): round to SE(d)
            T = rounding.anchor_to_first_pose(
                rounding.round_solution(torch.as_tensor(X)))
            T = T.cpu().numpy()
        else:
            T = X.cpu().numpy() if isinstance(X, torch.Tensor) else np.asarray(X)
        name = f"snap_iter{int(iteration):06d}.tum"
        export.write_tum(os.path.join(self.dir, name), T)
        if self.html:
            if isinstance(weights, torch.Tensor):
                weights = weights.cpu().numpy()
            w = (
                np.asarray(weights)[: len(self.data.measurements)]
                if weights is not None
                else None
            )
            tmp = os.path.join(self.dir, ".latest.html.tmp")
            viz.write_html(
                tmp, T, self.data.num_poses, self.data.measurements, w,
                title=(
                    f"dpgo_ros_tpu live — iteration {int(iteration)}"
                    + (f", cost {cost:.4g}" if cost is not None else "")
                ),
            )
            os.replace(tmp, os.path.join(self.dir, "latest.html"))
        with open(self._manifest, "a") as f:
            f.write(
                f"{int(iteration)},{time.time() - self._t0:.3f},"
                f"{'' if cost is None else repr(float(cost))},{name}\n"
            )
        self._last_t = time.time()
        self._last_it = int(iteration)
        self.count += 1
        return name
