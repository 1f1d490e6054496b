"""Trajectory / result export — the framework's replacement for the
reference's rviz visualization layer (SURVEY.md §1-L7).

The reference publishes PoseArray + Path + PoseGraph topics and colored
loop-closure markers (green=accepted, red=rejected, blue=undecided by GNC
weight, ``src/PGOAgentROS.cpp:629-660, 756-851``). Here: g2o / TUM trajectory
files and a loop-closure classification report.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

from dpgo_ros_tpu_torch.io.g2o import rot_to_quat, write_g2o
from dpgo_ros_tpu_torch.types import EdgeType, MeasurementBatch


def write_tum(path: str, trajectory: np.ndarray, timestamps=None) -> None:
    """TUM format: ``t x y z qx qy qz qw`` per line (3D only)."""
    traj = np.asarray(trajectory)
    n, d = traj.shape[0], traj.shape[1]
    assert d == 3, "TUM export is 3D-only"
    ts = timestamps if timestamps is not None else np.arange(n, dtype=float)
    with open(path, "w") as f:
        for i in range(n):
            q = rot_to_quat(traj[i, :, :3])
            t = traj[i, :, 3]
            f.write(
                f"{ts[i]:.6f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
            )


def loop_closure_report(
    measurements: MeasurementBatch,
    weights: np.ndarray,
    path: Optional[str] = None,
) -> Dict:
    """Classify loop closures by final GNC weight (reference marker colors:
    accepted/rejected/undecided, ``PGOAgentROS.cpp:756-843``; statistics at
    ``:1058-1067``)."""
    w = np.asarray(weights)[: len(measurements)]
    lc = measurements.edge_type != EdgeType.ODOMETRY
    acc = lc & (w >= 1.0 - 1e-6)
    rej = lc & (w <= 1e-6)
    und = lc & ~acc & ~rej
    report = {
        "accept_loop_closures": int(acc.sum()),
        "reject_loop_closures": int(rej.sum()),
        "undecided_loop_closures": int(und.sum()),
        "edges": [
            {
                "src": [int(measurements.src_robot[k]), int(measurements.src_frame[k])],
                "dst": [int(measurements.dst_robot[k]), int(measurements.dst_frame[k])],
                "weight": float(w[k]),
                "status": (
                    "accepted" if acc[k] else "rejected" if rej[k] else "undecided"
                ),
            }
            for k in np.where(lc)[0]
        ],
    }
    if path:
        with open(path, "w") as f:
            json.dump(report, f, indent=1)
    return report


def export_solution(
    prefix: str,
    trajectory: np.ndarray,
    num_poses,
    measurements: Optional[MeasurementBatch] = None,
    weights: Optional[np.ndarray] = None,
    show_loops: bool = True,
) -> None:
    """Write the fleet solution: global g2o + per-robot TUM files + GNC
    report (the dump the reference produces at TERMINATE,
    ``publishOptimizedTrajectory``, ``PGOAgentROS.cpp:1077-1080``).

    ``show_loops`` gates the loop-closure overlay in the HTML only (the
    reference's ``visualize_loop_closures`` rviz-marker switch,
    ``PGOAgentROS.cpp:756-843``); the g2o/TUM/JSON dumps are unaffected."""
    write_g2o(prefix + "_global.g2o", trajectory, measurements)
    o = 0
    for k, nk in enumerate(np.asarray(num_poses)):
        write_tum(prefix + f"_robot{k}.tum", trajectory[o : o + int(nk)])
        o += int(nk)
    if measurements is not None and weights is not None:
        loop_closure_report(measurements, weights, prefix + "_loops.json")
    from dpgo_ros_tpu_torch.utils.viz import write_html

    write_html(
        prefix + ".html", trajectory, num_poses,
        measurements if show_loops else None,
        weights if show_loops else None,
    )
