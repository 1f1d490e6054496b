"""The work a kernel call must do, counted from its inputs, and the least
time the card could take for it.

Bytes count each operand read once and each output written once; operations
come from the kernels' algebra (a multiply-add is 2) over the poses and
edges a call needs, not the most it could touch. ``chip_smoke.py`` and
``scripts/roofline.py`` put these beside the kernels' measured times.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# the card's peaks (H100 SXM, NVIDIA's data sheet, at the full 700 W power
# limit): HBM3 rate, fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def bound(nbytes: float, flops: float) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` at its memory rate or do ``flops`` at its fp32 rate,
    whichever is larger."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def edge_bytes(E: int, d: int) -> int:
    """Bytes of ``E`` edges' operands read once: src/dst (int32), R, t,
    κ_eff, τ_eff (fp32)."""
    return E * (8 + 4 * d * d + 4 * d + 8)


def block_work(prob, mask: np.ndarray) -> Tuple[int, int, int]:
    """(poses in the block, edges that touch it, separator poses: the poses
    outside it that those edges reach) of ``prob`` (a ``LiftedProblem``)
    for a boolean (n,) pose mask."""
    he = prob.host_edges
    src, dst = np.asarray(he.src), np.asarray(he.dst)
    touch = mask[src] | mask[dst]
    ends = np.concatenate([src[touch], dst[touch]])
    return int(mask.sum()), int(touch.sum()), np.unique(ends[~mask[ends]]).size


def solve_bytes(prob, nk: int, Ek: int, ns: int, stats: int = 0) -> int:
    """One block solve's operands read once and outputs written once: the
    block's poses and their P⁻¹, the separator poses, the block's edges;
    the block's poses and the stats row (K1's 6 + 2R floats unless
    ``stats`` says otherwise)."""
    C, D = prob.r * (prob.d + 1), prob.d + 1
    stats = stats or 6 + 2 * prob.num_robots
    return 4 * (2 * nk * C + ns * C + nk * D * D + stats) + edge_bytes(Ek, prob.d)


def outside_work(prob, mask: np.ndarray) -> Tuple[int, float]:
    """(bytes, operations) of the world's cost over the edges with no
    endpoint in the block (K1's constant term, so that its f0 and f are the
    world's): those edges and the poses outside the window read once; per
    edge and row of r a residual and its square, 2d² + 4d + 4."""
    nk, Ek, ns = block_work(prob, mask)
    Eo = prob.edges.num_edges - Ek
    C = prob.r * (prob.d + 1)
    nbytes = edge_bytes(Eo, prob.d) + 4 * C * (prob.n - nk - ns)
    return nbytes, cost_flops(Eo, prob.r, prob.d)


def cost_flops(E: int, r: int, d: int) -> float:
    """The cost over ``E`` edges: per edge and row of r a residual and its
    square, 2d² + 4d + 4."""
    return float(E * r * (2 * d * d + 4 * d + 4))


# Operation counts from the kernels' algebra: one pass of the linear edge
# map with its pull-index gather, per edge and row of r: residuals and both
# contribution rows, 4d² + 4d + 6, then 2 rows of d + 1 adds; per pose:
# tangent projection 4rd², preconditioned projection 2r(d+1)² + 4rd² +
# r(d+1), Newton–Schulz retraction 3rd + 20 (2rd² + rd(2d+1)).
def _edge_flops(E: int, r: int, d: int) -> float:
    return E * r * (4 * d * d + 4 * d + 6 + 2 * (d + 1))


def _pose_flops(r: int, d: int):
    C = r * (d + 1)
    proj = 4 * r * d * d
    prec = 2 * r * (d + 1) ** 2 + proj + C
    retract = 3 * r * d + 20 * (2 * r * d * d + r * d * (2 * d + 1))
    return proj, prec, retract, C


def tcg_flops(n: int, E: int, r: int, d: int) -> float:
    """One tCG iteration of a solve over ``n`` poses and ``E`` edges: the
    Hessian edge pass and the pose passes."""
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


def rgd_flops(n: int, E: int, r: int, d: int) -> float:
    """One preconditioned Riemannian gradient step of a block of ``n``
    poses over ``E`` edges (K2's RGD variant): the edge pass, the
    preconditioned projection and the retraction of every pose."""
    proj, prec, retract, C = _pose_flops(r, d)
    return _edge_flops(E, r, d) + n * (proj + C + retract + prec + C)


def tick_flops(prob, steps: int, precond: bool) -> float:
    """One ASAPP tick: per robot and step, the edge pass over the edges
    that touch its block and the step on its own poses; the movement."""
    proj, prec, retract, C = _pose_flops(prob.r, prob.d)
    he, rof = prob.host_edges, np.asarray(prob.robot_of_pose)
    total = 0.0
    for k in range(prob.num_robots):
        Ek = int(np.sum((rof[he.src] == k) | (rof[he.dst] == k)))
        nk = int(np.sum(rof == k))
        per_pose = proj + C + retract + (prec + C if precond else 0)
        total += steps * (_edge_flops(Ek, prob.r, prob.d) + nk * per_pose) + nk * 3 * C
    return total


def tick_bytes(prob, precond: bool) -> int:
    """One tick's operands read once and outputs written once: every
    robot's own poses from X and its separator poses from the ring slot
    its delay selects, P⁻¹ (with the preconditioner), the delays, every
    edge once; X_new and the movement."""
    n, R, C = prob.n, prob.num_robots, prob.r * (prob.d + 1)
    rof = np.asarray(prob.robot_of_pose)
    stale = sum(block_work(prob, rof == k)[2] for k in range(R))
    pinv = n * (prob.d + 1) ** 2 if precond else 0
    return 4 * (2 * n * C + stale * C + pinv + 2 * R) + \
        edge_bytes(prob.edges.num_edges, prob.d)
