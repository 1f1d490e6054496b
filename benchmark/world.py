"""Seeded multi-robot pose graphs: the benchmark's inputs.

A frozen copy of ``dpgo_ros_tpu_torch/io/synthetic.py::generate_world`` (the
``sphere`` and ``grid3d`` kinds, the pose-count partition and the edge
classification of ``io/partition.py``), in NumPy alone, so that the program
can change its generator and the benchmark's graphs stay what they were. A
graph is a dict of arrays: the measurements in the program's
``MeasurementBatch`` layout (SE-Sync convention, ``R_dst ≈ R_src R``,
``t_dst ≈ t_src + R_src t``), ``num_poses`` per robot, ``outlier`` (the
planted outlier loop closures) and ``ground_truth`` (n, 3, 4).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

ODOMETRY, PRIVATE_LOOP_CLOSURE, SHARED_LOOP_CLOSURE = 0, 1, 2


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _random_small_rotations(rng, n, sigma):
    """Axis-angle perturbations with angle ~ N(0, sigma) (small-angle)."""
    if sigma <= 0:
        return np.tile(np.eye(3), (n, 1, 1))
    axes = rng.standard_normal((n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True) + 1e-30
    angs = rng.standard_normal(n) * sigma
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2] = -axes[:, 2], axes[:, 1]
    K[:, 1, 0], K[:, 1, 2] = axes[:, 2], -axes[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -axes[:, 1], axes[:, 0]
    s = np.sin(angs)[:, None, None]
    c = (1.0 - np.cos(angs))[:, None, None]
    return np.eye(3) + s * K + c * (K @ K)


def _sphere_trajectory(n: int):
    """Spiral on a sphere of radius ring_size / 2; loop closures pair pose i
    with pose i + ring_size."""
    rings = max(4, int(np.sqrt(n)))
    ring_size = n // rings
    k = np.arange(n)
    theta = np.pi * (k + 0.5) / n
    phi = 2.0 * np.pi * (k % ring_size) / ring_size
    radius = 0.5 * ring_size
    p = radius * np.stack(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)],
        axis=1,
    )
    return p, ring_size


def _grid3d_trajectory(nx: int, ny: int, nz: int) -> np.ndarray:
    """Serpentine sweep of an nx × ny × nz lattice → (n, 3) positions."""
    pos = np.zeros((nx * ny * nz, 3))
    idx = 0
    for z in range(nz):
        for y in range(ny):
            for x in (range(nx) if y % 2 == 0 else range(nx - 1, -1, -1)):
                pos[idx] = (x, y, z)
                idx += 1
    return pos


def contiguous_partition(n: int, num_robots: int) -> Tuple[np.ndarray, np.ndarray]:
    """(robot of each pose, local frame of each pose): blocks of
    n // num_robots, the last robot taking the rest."""
    if num_robots <= 0 or n < num_robots:
        raise ValueError(f"num_robots must be in [1, {n}], got {num_robots}")
    per = n // num_robots
    gids = np.arange(n)
    robot = np.minimum(gids // per, num_robots - 1).astype(np.int32)
    return robot, (gids - robot.astype(np.int64) * per).astype(np.int32)


def classify_edge_types(src_robot, src_frame, dst_robot, dst_frame) -> np.ndarray:
    """Same robot and consecutive frames: odometry; same robot otherwise:
    private loop closure; two robots: shared loop closure."""
    same = src_robot == dst_robot
    odo = same & (src_frame + 1 == dst_frame)
    return np.where(odo, ODOMETRY,
                    np.where(same, PRIVATE_LOOP_CLOSURE, SHARED_LOOP_CLOSURE)
                    ).astype(np.int32)


def generate_world(
    kind: str = "sphere",
    n: int = 1000,
    num_robots: int = 1,
    grid_shape: Tuple[int, int, int] = (10, 10, 10),
    rot_noise: float = 0.01,
    trans_noise: float = 0.05,
    loop_prob: float = 1.0,
    loop_radius: float = 1.5,
    outlier_ratio: float = 0.0,
    kappa: Optional[float] = None,
    tau: Optional[float] = None,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """The graph of ``kind`` with noise and planted outliers drawn from
    ``seed`` (any non-negative integer): the same draws, in the same order,
    as the program's generator."""
    rng = np.random.default_rng(seed)
    if kind == "sphere":
        pos, ring = _sphere_trajectory(n)
        cand = np.stack([np.arange(n - ring), np.arange(ring, n)], axis=1)
    elif kind == "grid3d":
        nx, ny, nz = grid_shape
        n = nx * ny * nz
        pos = _grid3d_trajectory(nx, ny, nz)
        ii, jj = [], []
        for off in (nx, nx * ny):
            i = np.arange(n - off)
            keep = np.linalg.norm(pos[i + off] - pos[i], axis=1) <= loop_radius
            ii.append(i[keep])
            jj.append(i[keep] + off)
        cand = np.stack([np.concatenate(ii), np.concatenate(jj)], axis=1)
    else:
        raise ValueError(f"unknown world kind {kind!r}")

    dirs = np.diff(pos, axis=0, append=pos[-1:] + (pos[-1:] - pos[-2:-1]))
    yaw = np.arctan2(dirs[:, 1], dirs[:, 0])
    R_gt = np.stack([_rot_z(a) for a in yaw], axis=0)
    T_gt = np.concatenate([R_gt, pos[:, :, None]], axis=2)

    loops = cand[rng.uniform(size=len(cand)) < loop_prob]
    src = np.concatenate([np.arange(n - 1), loops[:, 0]])
    dst = np.concatenate([np.arange(1, n), loops[:, 1]])
    E = src.size
    is_loop_edge = np.zeros(E, bool)
    is_loop_edge[n - 1:] = True

    Ri, Rj = R_gt[src], R_gt[dst]
    R_rel = np.einsum("eij,eik->ejk", Ri, Rj)
    t_rel = np.einsum("eij,ei->ej", Ri, pos[dst] - pos[src])
    R_rel = np.einsum("eij,ejk->eik", R_rel, _random_small_rotations(rng, E, rot_noise))
    t_rel = t_rel + rng.standard_normal((E, 3)) * trans_noise

    outlier = np.zeros(E, bool)
    if outlier_ratio > 0:
        li = np.flatnonzero(is_loop_edge)
        bad = rng.choice(li, size=int(round(outlier_ratio * li.size)), replace=False)
        outlier[bad] = True
        R_rel[bad] = _random_small_rotations(rng, bad.size, np.pi / 2)
        span = pos.max(0) - pos.min(0)
        t_rel[bad] = rng.uniform(-1, 1, (bad.size, 3)) * span * 0.5

    kap = kappa if kappa is not None else 1.0 / max(rot_noise ** 2, 1e-6)
    ta = tau if tau is not None else 1.0 / max(trans_noise ** 2, 1e-6)
    robot, local = contiguous_partition(n, num_robots)
    src_robot, dst_robot = robot[src], robot[dst]
    src_frame, dst_frame = local[src], local[dst]
    edge_type = classify_edge_types(src_robot, src_frame, dst_robot, dst_frame)
    return dict(
        src_robot=src_robot.astype(np.int32),
        src_frame=src_frame.astype(np.int32),
        dst_robot=dst_robot.astype(np.int32),
        dst_frame=dst_frame.astype(np.int32),
        R=R_rel,
        t=t_rel,
        kappa=np.full(E, kap),
        tau=np.full(E, ta),
        weight=np.ones(E),
        fixed_weight=edge_type == ODOMETRY,
        edge_type=edge_type,
        num_poses=np.bincount(robot, minlength=num_robots).astype(np.int64),
        outlier=outlier,
        ground_truth=T_gt,
    )
