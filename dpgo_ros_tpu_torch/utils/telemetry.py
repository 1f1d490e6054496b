"""Per-iteration telemetry logging — reference schema parity.

The reference writes per-agent CSV logs with schema
``robot_id, cluster_id, num_active_robots, iteration, num_poses,
bytes_received, iter_time_sec, total_time_sec, rel_change``
(``src/PGOAgentROS.cpp:853-894``, written to
``logs/agent<k>/dpgo_log_<t>.csv``), with event strings ("TERMINATE",
"UPDATE_WEIGHT", "TIMEOUT") interleaved via ``logString``
(``PGOAgentROS.cpp:896-907``).
"""

from __future__ import annotations

import os
import time
from typing import Optional

HEADER = (
    "robot_id,cluster_id,num_active_robots,iteration,num_poses,"
    "bytes_received,iter_time_sec,total_time_sec,rel_change"
)


def public_poses_msg_bytes(num_poses: int, r: int, d: int) -> int:
    """Bytes of one PublicPoses message carrying ``num_poses`` lifted poses.

    Mirrors ``computePublicPosesMsgSize`` (``src/utils.cpp:251-260``):
    per pose one uint32 id + r×(d+1) float64 values, plus fixed header
    (robot_id, cluster_id, destination, instance, iteration, is_auxiliary).
    """
    header = 4 * 5 + 1
    per_pose = 4 + 8 * r * (d + 1) + 8  # id + matrix values + rows/cols
    return header + num_poses * per_pose


class IterationLogger:
    """Per-robot CSV logger with the reference's exact schema + events."""

    def __init__(
        self,
        robot_id: int,
        log_directory: Optional[str],
        cluster_id: int = 0,
    ):
        self.robot_id = robot_id
        self.cluster_id = cluster_id
        self.path: Optional[str] = None
        self._f = None
        self.t_start = time.time()
        if log_directory:
            os.makedirs(log_directory, exist_ok=True)
            self.path = os.path.join(
                log_directory,
                f"dpgo_log_{int(self.t_start)}.csv",
            )
            self._f = open(self.path, "w")
            self._f.write(HEADER + "\n")

    def log_iteration(
        self,
        num_active_robots: int,
        iteration: int,
        num_poses: int,
        bytes_received: int,
        iter_time_sec: float,
        rel_change: float,
    ) -> None:
        if self._f is None:
            return
        total = time.time() - self.t_start
        self._f.write(
            f"{self.robot_id},{self.cluster_id},{num_active_robots},"
            f"{iteration},{num_poses},{bytes_received},"
            f"{iter_time_sec:.6f},{total:.6f},{rel_change:.6e}\n"
        )
        self._f.flush()

    def log_event(self, event: str) -> None:
        """Interleave an event string row (reference ``logString``)."""
        if self._f is None:
            return
        self._f.write(f"{self.robot_id},{event}\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def separator_incoming_counts(problem) -> "list[int]":
    """Per-robot count of distinct *incoming* separator poses: poses owned
    by other robots that appear as an endpoint of an edge incident to the
    robot — exactly what PublicPoses messages deliver to it each iteration
    (reference ``publicPosesCallback`` → ``updateNeighborPoses``,
    ``src/PGOAgentROS.cpp:1255-1284``)."""
    import numpy as np

    rof = np.asarray(problem.robot_of_pose)
    he = problem.host_edges
    src = np.asarray(he.src)
    dst = np.asarray(he.dst)
    msk = np.asarray(he.mask) > 0
    sr, dr = rof[src], rof[dst]
    counts = []
    for k in range(problem.num_robots):
        inc = msk & (((sr == k) & (dr != k)) | ((dr == k) & (sr != k)))
        foreign = np.concatenate(
            [src[inc & (sr != k)], dst[inc & (dr != k)]]
        )
        counts.append(int(np.unique(foreign).size))
    return counts


def write_run_logs(
    log_directory: str,
    *,
    problem,
    rel_change_rows,
    iter_times=None,
    events=None,
    cluster_id: int = 0,
    num_active: Optional[int] = None,
    terminate: bool = True,
) -> "list[str]":
    """Write per-agent reference-schema CSVs for a completed engine/fused/
    spmd/async run (reference writes one CSV per agent under
    ``logs/agent<k>/``, ``src/PGOAgentROS.cpp:1017-1022``).

    ``rel_change_rows``: (iters, R) per-robot relative changes (NaN rows —
    unreached fused-run iterations — are dropped). ``iter_times``: per-
    iteration wall seconds, or None → 0 (on-device fused runs have no
    per-iteration host clock; callers may pass the mean). ``events``: list
    of (iteration_index, name) interleaved rows. Returns written paths.
    """
    import numpy as np

    rel = np.asarray(rel_change_rows, np.float64)
    if rel.ndim == 1:
        rel = rel[:, None] * np.ones((1, problem.num_robots))
    valid = ~np.all(np.isnan(rel), axis=1)
    rel = rel[valid]
    iters = rel.shape[0]
    R = problem.num_robots
    num_active = num_active if num_active is not None else R
    sep = separator_incoming_counts(problem)
    times = (
        np.asarray(iter_times, np.float64)[: iters]
        if iter_times is not None
        else np.zeros((iters,))
    )
    ev_by_iter: dict = {}
    for it, name in events or []:
        ev_by_iter.setdefault(int(it), []).append(str(name))
    paths = []
    t0 = time.time()
    for k in range(R):
        d = os.path.join(log_directory, f"agent{k}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"dpgo_log_{int(t0)}.csv")
        total = 0.0
        with open(path, "w") as f:
            f.write(HEADER + "\n")
            for i in range(iters):
                for name in ev_by_iter.get(i, []):
                    f.write(f"{k},{name}\n")
                total += float(times[i]) if i < len(times) else 0.0
                bytes_rx = public_poses_msg_bytes(
                    sep[k], problem.r, problem.d
                )
                rc = rel[i, k] if k < rel.shape[1] else rel[i, 0]
                f.write(
                    f"{k},{cluster_id},{num_active},{i + 1},"
                    f"{int(problem.num_poses[k])},{bytes_rx},"
                    f"{float(times[i]) if i < len(times) else 0.0:.6f},"
                    f"{total:.6f},{rc:.6e}\n"
                )
            if terminate:
                f.write(f"{k},TERMINATE\n")
        paths.append(path)
    return paths
