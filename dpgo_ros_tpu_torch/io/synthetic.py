"""Synthetic multi-robot pose-graph generator with exact ground truth.

The reference ships fixed datasets only (and its `.MISSING_LARGE_BLOBS`
notes two more it lost); there is no way to test at sizes beyond cubicle's
5,750 poses or to measure accept/reject precision-recall against real
labels (the tunnels CSVs carry none — docs/PARITY.md). This generator
produces worlds of ARBITRARY size with known ground truth:

* ``sphere``: a spiral on a sphere (the sphere2500 family) — loop closures
  connect adjacent rings at a constant index offset, so the graph is
  banded and exercises the kernel's diagonal lane-shift classes.
* ``grid3d``: a serpentine sweep of an nx×ny×nz lattice (the grid3D
  family) — loop closures connect lattice neighbors at offsets ±nx and
  ±nx·ny.

Measurements follow the SE-Sync/DPGO convention (``R_dst ≈ R_src·R``,
``t_dst ≈ t_src + R_src·t``) with isotropic Langevin-style rotation noise
(small-angle axis-angle) and Gaussian translation noise; a fraction of
loop closures can be replaced by uniform-random outliers (GNC testbeds
with EXACT labels, returned via ``outlier_mask``).

Ground truth rides in ``PoseGraphData.initial_guess`` (the same slot the
g2o loader uses for VERTEX lines) — solvers only consume it when
explicitly asked, and ``LiftedProblem.global_trajectory`` /
``ops.rounding.ate_translation`` give exact ATE against it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from dpgo_ros_tpu_torch.io.partition import (
    balanced_contiguous_partition,
    classify_edge_types,
    contiguous_partition,
    pose_work_weights,
)
from dpgo_ros_tpu_torch.types import EdgeType, MeasurementBatch, PoseGraphData


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


def _sphere_trajectory(n: int, rings: Optional[int] = None):
    """Spiral on the unit sphere scaled to radius ~ n^(1/2); returns
    (positions (n,3), ring_size) — loop closures pair i with i+ring_size."""
    rings = rings or max(4, int(np.sqrt(n)))
    ring_size = n // rings
    k = np.arange(n)
    # latitude sweeps pole to pole once over the whole spiral
    theta = np.pi * (k + 0.5) / n
    phi = 2.0 * np.pi * (k % ring_size) / ring_size
    radius = 0.5 * ring_size
    p = radius * np.stack(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
         np.cos(theta)], axis=1
    )
    return p, ring_size


def _grid3d_trajectory(nx: int, ny: int, nz: int) -> np.ndarray:
    """Serpentine sweep of the lattice → (n, 3) positions. Lattice
    neighbors across rows/planes sit near index offsets nx and nx·ny
    (exactly for even rows; the distance filter in generate_world keeps
    only true unit-distance neighbors)."""
    n = nx * ny * nz
    pos = np.zeros((n, 3))
    idx = 0
    for z in range(nz):
        for y in range(ny):
            xs = range(nx) if y % 2 == 0 else range(nx - 1, -1, -1)
            for x in xs:
                pos[idx] = (x, y, z)
                idx += 1
    return pos


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
    balance: str = "poses",
):
    """Build a PoseGraphData world; returns (data, ground_truth (n,3,4),
    outlier_mask (E,) bool over the generated edge order)."""
    rng = np.random.default_rng(seed)
    if kind == "sphere":
        pos, ring = _sphere_trajectory(n)
        cand = np.stack(
            [np.arange(n - ring), np.arange(ring, n)], axis=1
        )
    elif kind == "grid3d":
        nx, ny, nz = grid_shape
        n = nx * ny * nz
        pos = _grid3d_trajectory(nx, ny, nz)
        ii, jj = [], []
        for off in (nx, nx * ny):
            i = np.arange(n - off)
            d = np.linalg.norm(pos[i + off] - pos[i], axis=1)
            keep = d <= loop_radius
            ii.append(i[keep])
            jj.append(i[keep] + off)
        cand = np.stack(
            [np.concatenate(ii), np.concatenate(jj)], axis=1
        )
    else:
        raise ValueError(f"unknown synthetic world kind {kind!r}")

    # smooth ground-truth rotations: heading follows the trajectory yaw
    dirs = np.diff(pos, axis=0, append=pos[-1:] + (pos[-1:] - pos[-2:-1]))
    yaw = np.arctan2(dirs[:, 1], dirs[:, 0])
    R_gt = np.stack([_rot_z(a) for a in yaw], axis=0)
    T_gt = np.concatenate([R_gt, pos[:, :, None]], axis=2)

    keep = rng.uniform(size=len(cand)) < loop_prob
    loops = cand[keep]
    src = np.concatenate([np.arange(n - 1), loops[:, 0]])
    dst = np.concatenate([np.arange(1, n), loops[:, 1]])
    E = src.size
    is_loop_edge = np.zeros(E, bool)
    is_loop_edge[n - 1:] = True

    # noisy relative measurements (SE-Sync convention)
    Ri, Rj = R_gt[src], R_gt[dst]
    R_rel = np.einsum("eij,eik->ejk", Ri, Rj)  # Ri^T Rj
    # Ri^T v  (einsum "eij,ei->ej" contracts the FIRST matrix axis: M^T v)
    t_rel = np.einsum("eij,ei->ej", Ri, pos[dst] - pos[src])
    R_rel = np.einsum(
        "eij,ejk->eik", R_rel, _random_small_rotations(rng, E, rot_noise)
    )
    t_rel = t_rel + rng.standard_normal((E, 3)) * trans_noise

    outlier_mask = np.zeros(E, bool)
    if outlier_ratio > 0:
        li = np.flatnonzero(is_loop_edge)
        bad = rng.choice(
            li, size=int(round(outlier_ratio * li.size)), replace=False
        )
        outlier_mask[bad] = True
        R_rel[bad] = _random_small_rotations(rng, bad.size, np.pi / 2)
        span = pos.max(0) - pos.min(0)
        t_rel[bad] = rng.uniform(-1, 1, (bad.size, 3)) * span * 0.5

    kap = kappa if kappa is not None else 1.0 / max(rot_noise**2, 1e-6)
    ta = tau if tau is not None else 1.0 / max(trans_noise**2, 1e-6)

    # partition into robots (contiguous; optionally work-balanced)
    if balance == "work":
        w = pose_work_weights(n, src)
        robot, local = balanced_contiguous_partition(w, num_robots)
    else:
        robot, local = contiguous_partition(n, num_robots)
    src_robot, dst_robot = robot[src], robot[dst]
    src_frame, dst_frame = local[src], local[dst]
    edge_type = classify_edge_types(
        src_robot, src_frame, dst_robot, dst_frame
    )
    m = MeasurementBatch(
        src_robot=src_robot.astype(np.int32),
        src_frame=src_frame.astype(np.int32),
        dst_robot=dst_robot.astype(np.int32),
        dst_frame=dst_frame.astype(np.int32),
        R=R_rel,
        t=t_rel,
        kappa=np.full(E, kap),
        tau=np.full(E, ta),
        weight=np.ones(E),
        fixed_weight=(edge_type == EdgeType.ODOMETRY),
        edge_type=edge_type,
    )
    num_poses = np.bincount(robot, minlength=num_robots).astype(np.int64)
    gt = {
        k: T_gt[robot == k] for k in range(num_robots)
    }
    data = PoseGraphData(
        measurements=m, num_poses=num_poses, d=3, initial_guess=gt
    )
    return data, T_gt, outlier_mask


def add_random_loop_closures(
    data: PoseGraphData,
    ground_truth: np.ndarray,
    count: int,
    seed: int = 0,
    rot_noise: float = 0.01,
    trans_noise: float = 0.05,
) -> PoseGraphData:
    """``data`` plus ``count`` loop closures between random pose pairs
    (drawn with numpy from ``seed``; never two consecutive poses, so none
    reads as odometry), measured from ``ground_truth`` (n, 3, 4) with the
    generator's noise and the world's first κ and τ. It makes a banded
    world irregular: loop closures that reach any pose, in any robot.

    A check-only generator, the one function of this module that its JAX
    twin lacks: no CLI flag or engine path calls it; chip_smoke.py and the
    tests use it to hold the windowed block solve to the full-width one on
    irregular graphs."""
    rng = np.random.default_rng(seed)
    n = ground_truth.shape[0]
    pairs = np.zeros((0, 2), np.int64)
    while len(pairs) < count:
        cand = rng.integers(0, n, size=(count, 2))
        cand = cand[np.abs(cand[:, 0] - cand[:, 1]) > 1]
        pairs = np.concatenate([pairs, cand])[:count]
    src, dst = pairs[:, 0], pairs[:, 1]
    R_gt, pos = ground_truth[:, :, :3], ground_truth[:, :, 3]
    Ri, Rj = R_gt[src], R_gt[dst]
    R_rel = np.einsum("eij,eik->ejk", Ri, Rj)
    R_rel = np.einsum(
        "eij,ejk->eik", R_rel, _random_small_rotations(rng, count, rot_noise)
    )
    t_rel = np.einsum("eij,ei->ej", Ri, pos[dst] - pos[src])
    t_rel = t_rel + rng.standard_normal((count, 3)) * trans_noise
    m = data.measurements
    robot = np.repeat(np.arange(data.num_robots), data.num_poses)
    start = np.concatenate([[0], np.cumsum(data.num_poses)[:-1]])
    local = np.arange(n) - start[robot]
    edge_type = classify_edge_types(robot[src], local[src], robot[dst], local[dst])
    extra = MeasurementBatch(
        src_robot=robot[src].astype(np.int32),
        src_frame=local[src].astype(np.int32),
        dst_robot=robot[dst].astype(np.int32),
        dst_frame=local[dst].astype(np.int32),
        R=R_rel,
        t=t_rel,
        kappa=np.full(count, m.kappa[0]),
        tau=np.full(count, m.tau[0]),
        weight=np.ones(count),
        fixed_weight=np.zeros(count, bool),
        edge_type=edge_type,
    )
    return PoseGraphData(
        measurements=m.concat(extra), num_poses=data.num_poses, d=data.d,
        initial_guess=data.initial_guess,
    )
