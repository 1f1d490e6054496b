"""Contiguous multi-robot partitioning of a single-file pose graph.

Replicates the reference dataset publisher's semantics
(``src/PGODatasetPublisherNode.cpp:84-135``):

* n poses are split into ``num_robots`` contiguous blocks of
  ``n // num_robots`` poses; the last robot absorbs the remainder.
* global pose id -> (robot, local frame) by block membership.
* edges are classified: same robot & consecutive frames -> odometry;
  same robot otherwise -> private loop closure; different robots -> shared
  loop closure.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from dpgo_ros_tpu_torch.io.g2o import read_g2o
from dpgo_ros_tpu_torch.types import EdgeType, MeasurementBatch, PoseGraphData


def classify_edge_types(
    src_robot, src_frame, dst_robot, dst_frame
) -> np.ndarray:
    """Edge classification shared by every ingestion/regrouping path
    (reference rules, ``PGODatasetPublisherNode.cpp:108-135``): same robot &
    consecutive frames → odometry; same robot otherwise → private loop
    closure; different robots → shared loop closure."""
    same = np.asarray(src_robot) == np.asarray(dst_robot)
    odo = same & (np.asarray(src_frame) + 1 == np.asarray(dst_frame))
    return np.where(
        odo,
        EdgeType.ODOMETRY,
        np.where(
            same, EdgeType.PRIVATE_LOOP_CLOSURE, EdgeType.SHARED_LOOP_CLOSURE
        ),
    ).astype(np.int32)


def contiguous_partition(n: int, num_robots: int) -> Tuple[np.ndarray, np.ndarray]:
    """Return (robot_of_pose, local_frame_of_pose), each (n,).

    Matches ``PGODatasetPublisherNode.cpp:84-103``: blocks of
    ``n // num_robots``; robot num_robots-1 takes indices up to n.
    """
    if num_robots <= 0 or n < num_robots:
        raise ValueError(
            f"num_robots must be in [1, num_poses]; got {num_robots} for n={n}"
        )
    per = n // num_robots
    gids = np.arange(n)
    robot = np.minimum(gids // per, num_robots - 1).astype(np.int32)
    start = (robot.astype(np.int64) * per).astype(np.int64)
    local = (gids - start).astype(np.int32)
    return robot, local


def balanced_contiguous_partition(
    weights: np.ndarray, num_robots: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Contiguous blocks minimizing the max per-block weight sum (the
    classic linear-partition problem: bottleneck binary search + greedy
    feasibility).

    The reference's equal-pose-count split (``PGODatasetPublisherNode.cpp:
    84-103``) balances poses but not edge work: on parking-garage@5 the
    loop closures concentrate in two blocks (work skew 1.73 → projected
    N-chip efficiency 0.57, SCALING_r03.json). Weighting each pose by
    1 + its owned-edge count restores balance while keeping blocks
    contiguous (odometry stays chain-lane-friendly).

    Returns (robot_of_pose, local_frame_of_pose).
    """
    w = np.asarray(weights, np.float64)
    n = int(w.size)
    if num_robots <= 0 or n < num_robots:
        raise ValueError(
            f"num_robots must be in [1, n]; got {num_robots} for n={n}"
        )

    def cuts_for(B):
        """Greedy fill at bottleneck B → block start indices, or None if
        infeasible. Every block stays non-empty."""
        starts = [0]
        acc = 0.0
        for i in range(n):
            remaining_blocks = num_robots - len(starts)
            if acc > 0.0 and acc + w[i] > B:
                if remaining_blocks == 0:
                    return None
                # never strand fewer poses than blocks still to open
                if n - i < remaining_blocks:
                    return None
                starts.append(i)
                acc = 0.0
            acc += w[i]
        return starts

    lo, hi = float(w.max()), float(w.sum())
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if cuts_for(mid) is not None:
            hi = mid
        else:
            lo = mid
    starts = cuts_for(hi)
    # open any unopened blocks by splitting from the tail (rare: only when
    # the bottleneck search leaves fewer than num_robots blocks)
    while len(starts) < num_robots:
        starts.append(n - (num_robots - len(starts)))
    starts = sorted(set(starts))
    bounds = starts + [n]
    robot = np.zeros((n,), np.int32)
    local = np.zeros((n,), np.int32)
    for k in range(num_robots):
        a, b = bounds[k], bounds[k + 1]
        robot[a:b] = k
        local[a:b] = np.arange(b - a)
    return robot, local


def pose_work_weights(n: int, edge_src: np.ndarray) -> np.ndarray:
    """Per-pose kernel-work proxy: 1 (state row) + owned-edge count (edge
    lane passes; owner = src endpoint, matching the SPMD shard rule)."""
    w = np.ones((n,), np.float64)
    np.add.at(w, np.asarray(edge_src, np.int64), 1.0)
    return w


def partition_measurements(
    batch: MeasurementBatch, n: int, num_robots: int,
    robot: Optional[np.ndarray] = None,
    local: Optional[np.ndarray] = None,
) -> MeasurementBatch:
    """Re-index a global-ID measurement batch onto (robot, local frame) ids
    and classify edge types per the reference rules. Pass (robot, local)
    to use a custom (e.g. work-balanced) contiguous assignment."""
    if robot is None or local is None:
        robot, local = contiguous_partition(n, num_robots)
    src_robot = robot[batch.src_frame]
    dst_robot = robot[batch.dst_frame]
    src_frame = local[batch.src_frame]
    dst_frame = local[batch.dst_frame]
    edge_type = classify_edge_types(src_robot, src_frame, dst_robot, dst_frame)
    out = MeasurementBatch(
        src_robot=src_robot.astype(np.int32),
        src_frame=src_frame,
        dst_robot=dst_robot.astype(np.int32),
        dst_frame=dst_frame,
        R=batch.R,
        t=batch.t,
        kappa=batch.kappa,
        tau=batch.tau,
        weight=batch.weight,
        # odometry edges are never reweighted by GNC (reference marks them
        # fixedWeight=true, ``src/utils.cpp:141-149``)
        fixed_weight=batch.fixed_weight | (edge_type == EdgeType.ODOMETRY),
        edge_type=edge_type,
    )
    return out


def partition_g2o(
    path: str, num_robots: int, balance: str = "poses"
) -> PoseGraphData:
    """Load a g2o file and partition it into a multi-robot PoseGraphData
    (the reference dataset-publisher pipeline,
    ``PGODatasetPublisherNode.cpp:78-159``).

    ``balance``: "poses" = the reference's equal-pose-count blocks;
    "work" = contiguous blocks balancing poses + owned edges
    (:func:`balanced_contiguous_partition`) — same classification rules,
    different cut points.
    """
    batch, n, vertices = read_g2o(path)
    if balance == "work":
        wts = pose_work_weights(n, batch.src_frame)
        robot, local = balanced_contiguous_partition(wts, num_robots)
    elif balance == "poses":
        robot, local = contiguous_partition(n, num_robots)
    else:
        raise ValueError(f"unknown balance mode {balance!r}")
    out = partition_measurements(batch, n, num_robots, robot, local)
    num_poses = np.bincount(robot, minlength=num_robots).astype(np.int64)
    initial_guess: Optional[Dict[int, np.ndarray]] = None
    if vertices is not None:
        d = out.R.shape[-1] if len(out) else 3
        initial_guess = {}
        for r in range(num_robots):
            nk = int(num_poses[r])
            T = np.zeros((nk, d, d + 1))
            T[:, :, :d] = np.eye(d)
            initial_guess[r] = T
        for gid, T in vertices.items():
            initial_guess[int(robot[gid])][int(local[gid])] = T
    return PoseGraphData(
        measurements=out,
        num_poses=num_poses,
        d=int(out.R.shape[-1]) if len(out) else 3,
        initial_guess=initial_guess,
    )
