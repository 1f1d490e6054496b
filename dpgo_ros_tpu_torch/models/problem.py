"""LiftedProblem: a multi-robot pose graph as tensors on one device.

Port of ``dpgo_ros_tpu/models/problem.py``. Pose (robot k, frame f) maps to
the global index ``offsets[k] + f``; ``robot_of_pose`` maps back. The edge
tensors live on ``device``; ``host_edges`` keeps a numpy mirror of the static
structure so host-side preparation never reads the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from dpgo_ros_tpu_torch.types import EdgeType, PoseGraphData
from dpgo_ros_tpu_torch.ops.quadratic import EdgeSet, build_pull_index


@dataclasses.dataclass
class HostEdges:
    """Numpy mirror of an :class:`EdgeSet` (same field names)."""

    src: np.ndarray
    dst: np.ndarray
    R: np.ndarray
    t: np.ndarray
    kappa: np.ndarray
    tau: np.ndarray
    weight: np.ndarray
    mask: np.ndarray
    is_loop: np.ndarray
    pull: np.ndarray

    def to_torch(self, dtype: torch.dtype, device) -> EdgeSet:
        f = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
        i = lambda x: torch.as_tensor(x, dtype=torch.int64, device=device)
        return EdgeSet(
            src=i(self.src), dst=i(self.dst), R=f(self.R), t=f(self.t),
            kappa=f(self.kappa), tau=f(self.tau), weight=f(self.weight),
            mask=f(self.mask), is_loop=f(self.is_loop),
            pull=torch.as_tensor(self.pull, dtype=torch.int32, device=device),
        )


@dataclasses.dataclass
class LiftedProblem:
    edges: EdgeSet
    n: int
    d: int
    r: int
    num_robots: int
    offsets: np.ndarray  # (num_robots,) int64 block starts
    num_poses: np.ndarray  # (num_robots,) int64
    robot_of_pose: np.ndarray  # (n,) int32
    device: torch.device
    dtype: torch.dtype
    data: Optional[PoseGraphData] = None
    host_edges: Optional[HostEdges] = None

    @staticmethod
    def from_data(
        data: PoseGraphData,
        r: int = 5,
        *,
        dtype: torch.dtype = torch.float64,
        device="cuda",
    ) -> "LiftedProblem":
        """Lift ``data`` to tensors on ``device`` (the card unless the
        caller names another, e.g. ``device="cpu"`` for the plain paths)."""
        m = data.measurements
        offsets = np.zeros((data.num_robots,), np.int64)
        np.cumsum(data.num_poses[:-1], out=offsets[1:])
        src = offsets[m.src_robot] + m.src_frame
        dst = offsets[m.dst_robot] + m.dst_frame
        E = len(m)
        is_loop = (m.edge_type != EdgeType.ODOMETRY) & (~m.fixed_weight)
        np_dt = np.float64 if dtype == torch.float64 else np.float32
        host_edges = HostEdges(
            src=src.astype(np.int64),
            dst=dst.astype(np.int64),
            R=m.R.astype(np_dt),
            t=m.t.astype(np_dt),
            kappa=m.kappa.astype(np_dt),
            tau=m.tau.astype(np_dt),
            weight=m.weight.astype(np_dt),
            mask=np.ones(E, np_dt),
            is_loop=is_loop.astype(np_dt),
            pull=build_pull_index(src, dst, data.total_poses),
        )
        device = torch.device(device)
        return LiftedProblem(
            edges=host_edges.to_torch(dtype, device),
            n=data.total_poses,
            d=data.d,
            r=r,
            num_robots=data.num_robots,
            offsets=offsets,
            num_poses=np.asarray(data.num_poses, np.int64),
            robot_of_pose=np.repeat(
                np.arange(data.num_robots, dtype=np.int32), data.num_poses
            ),
            device=device,
            dtype=dtype,
            data=data,
            host_edges=host_edges,
        )

    def block_mask(self, robot_id: int) -> torch.Tensor:
        """(n, 1, 1) mask selecting robot_id's pose block."""
        m = torch.as_tensor(
            self.robot_of_pose == robot_id, dtype=self.dtype,
            device=self.device,
        )
        return m[:, None, None]

    # --- bookkeeping parity with DPGO::PoseGraph ---

    def num_measurements(self) -> int:
        """Live measurements (from the host mirror: no device read)."""
        return int(np.sum(self.host_edges.mask > 0))

    def counts_by_type(self) -> Tuple[int, int, int]:
        """(odometry, private loop closures, shared loop closures)."""
        if self.data is None:
            raise ValueError("counts_by_type needs the problem's PoseGraphData")
        return self.data.counts_by_type()

    def pose_block(self, X: torch.Tensor, robot_id: int) -> torch.Tensor:
        """Robot ``robot_id``'s rows of the global state (a view)."""
        o = int(self.offsets[robot_id])
        return X[o:o + int(self.num_poses[robot_id])]

    def global_trajectory(self, data: PoseGraphData) -> Optional[np.ndarray]:
        """Per-robot initial-guess trajectories stacked into (n, d, d+1),
        or None without an initial guess."""
        if data.initial_guess is None:
            return None
        return np.concatenate(
            [data.initial_guess[k] for k in range(data.num_robots)], axis=0
        )

    def separator_mask(self, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """(n,) mask of the poses touched by inter-robot edges — the public
        poses the reference exchanges (``msg/PublicPoses.msg``), for
        communication-volume telemetry; built from the host mirror and
        placed on the problem's device."""
        he = self.host_edges
        rop = self.robot_of_pose
        shared = (rop[he.src] != rop[he.dst]) & (he.mask > 0)
        m = np.zeros(self.n, bool)
        m[he.src[shared]] = True
        m[he.dst[shared]] = True
        return torch.as_tensor(m, dtype=dtype or self.dtype, device=self.device)
