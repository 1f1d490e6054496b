"""The work a block solve needs, counted from its inputs, and the card's
published peaks: a frozen copy of ``dpgo_ros_tpu_torch/utils/work.py``
(the counts of K2's and K4's RTR solves), on plain arrays.

Bytes count each operand read once and each output written once;
operations come from the solve's algebra (a multiply-add is 2) over the
poses and edges of the block's window and the TR and tCG iterations its
inputs needed, never from launch geometry, so the same work is read
whatever implements it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# One H100 SXM, NVIDIA's data sheet, at the full 700 W power limit: HBM3
# rate, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def least_seconds(nbytes: float, flops: float) -> Tuple[float, str]:
    """(s, "bytes" or "operations"): the least time the card could take to
    move ``nbytes`` at its memory rate or do ``flops`` at its float32 rate,
    whichever is larger."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def edge_bytes(E: int, d: int) -> int:
    """``E`` edges' operands read once: src/dst (int32), R, t, κ_eff,
    τ_eff (fp32)."""
    return E * (8 + 4 * d * d + 4 * d + 8)


def block_work(src: np.ndarray, dst: np.ndarray, mask: np.ndarray) -> Tuple[int, int, int]:
    """(poses in the block, edges that touch it, separator poses: the poses
    outside it that those edges reach) for a boolean (n,) pose mask over
    edges with global endpoints ``src``, ``dst``."""
    touch = mask[src] | mask[dst]
    ends = np.concatenate([src[touch], dst[touch]])
    return int(mask.sum()), int(touch.sum()), np.unique(ends[~mask[ends]]).size


def solve_bytes(nk: int, Ek: int, ns: int, r: int, d: int, stats: int) -> int:
    """One block solve's operands read once and outputs written once: the
    block's poses and their P⁻¹, the separator poses, the block's edges; the
    block's poses and a stats row of ``stats`` floats."""
    C, D = r * (d + 1), d + 1
    return 4 * (2 * nk * C + ns * C + nk * D * D + stats) + edge_bytes(Ek, d)


# Operation counts from the algebra: one pass of the linear edge map with its
# pull-index gather, per edge and row of r: residuals and both contribution
# rows, 4d² + 4d + 6, then 2 rows of d + 1 adds; per pose: tangent
# projection 4rd², preconditioned projection 2r(d+1)² + 4rd² + r(d+1),
# Newton–Schulz retraction 3rd + 20 (2rd² + rd(2d+1)).
def _edge_flops(E: int, r: int, d: int) -> float:
    return E * r * (4 * d * d + 4 * d + 6 + 2 * (d + 1))


def _pose_flops(r: int, d: int):
    C = r * (d + 1)
    proj = 4 * r * d * d
    prec = 2 * r * (d + 1) ** 2 + proj + C
    retract = 3 * r * d + 20 * (2 * r * d * d + r * d * (2 * d + 1))
    return proj, prec, retract, C


def tcg_flops(n: int, E: int, r: int, d: int) -> float:
    """One tCG iteration over ``n`` poses and ``E`` edges: the Hessian edge
    pass and the pose passes."""
    proj, prec, _, C = _pose_flops(r, d)
    return _edge_flops(E, r, d) + n * (1.5 * proj + prec + 23 * C)


def tr_flops(n: int, E: int, r: int, d: int) -> float:
    """One TR iteration's work outside its tCG iterations: the tCG set-up,
    the model decrease, the retraction of every pose, the trial gradient and
    the new norm."""
    proj, prec, retract, C = _pose_flops(r, d)
    return _edge_flops(E, r, d) + n * (3 * proj + prec + 13 * C + retract)


def rtr_flops(n: int, E: int, r: int, d: int, tr: int, tcg: int) -> float:
    """One RTR block solve with ``tr`` TR and ``tcg`` tCG iterations: the
    initial gradient and norm, ``tr`` × :func:`tr_flops` and ``tcg`` ×
    :func:`tcg_flops`."""
    proj, _, _, C = _pose_flops(r, d)
    return (_edge_flops(E, r, d) + n * (proj + 2 * C)
            + tr * tr_flops(n, E, r, d) + tcg * tcg_flops(n, E, r, d))
