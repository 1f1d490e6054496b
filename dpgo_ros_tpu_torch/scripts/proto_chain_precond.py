"""Prototype: the block-tridiagonal (odometry-chain) preconditioner against
the damped block-Jacobi one, in tCG iterations per robot block.

Port of ``scripts/proto_chain_precond.py``. Run from the repository root on
a machine with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.proto_chain_precond [--out PATH]

From the chordal initialization of ``--world`` (default sphere2500, 5
robots), each robot block's Steihaug-tCG inner loop (κ = 0.1, θ = 1) runs
to its residual target under each preconditioner M and counts its
iterations: the damped block-Jacobi inverse (the solver's) and a block
Thomas solve of the block-tridiagonal chain (each block's diagonal blocks
and the odometry chain's off-diagonal ones). As in the JAX script, the CG
recursion, the assembly of Q's blocks and the Thomas solve run in numpy on
the host; Q's Riemannian Hessian, the gradient and the tangent projection
run through the port's ops on the chosen device and dtype (default fp32 on
the card, as the JAX script's). ``ylift`` (tests) replaces the engine's
draw. Prints progress on stderr and one JSON line on stdout.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import quadratic, stiefel
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu_torch.scripts import common, roofline
from dpgo_ros_tpu_torch.scripts.common import log
from dpgo_ros_tpu_torch.utils.config import AgentConfig, InitMethod, UpdateRule

DAMPING = 1e-2


def chain_blocks(X: np.ndarray, e, w: np.ndarray):
    """(Q's (n, d+1, d+1) diagonal blocks, {i: the (i, i+1) chain block})
    of the weighted edges, assembled edge by edge."""
    n, r, dp1 = X.shape
    d = dp1 - 1
    src, dst = e.src.cpu().numpy(), e.dst.cpu().numpy()
    R = e.R.double().cpu().numpy()
    t = e.t.double().cpu().numpy()
    msk = e.mask.double().cpu().numpy()
    kw = e.kappa.double().cpu().numpy() * w * msk
    tw = e.tau.double().cpu().numpy() * w * msk
    Dii = np.zeros((n, dp1, dp1))
    Bio = {}
    for k in range(len(src)):
        if msk[k] == 0:
            continue
        i, j = int(src[k]), int(dst[k])
        a = np.concatenate([t[k], [1.0]])  # u_i coefficient of the tau residual
        Qii = np.zeros((dp1, dp1))
        Qjj = np.zeros((dp1, dp1))
        Qij = np.zeros((dp1, dp1))
        Qii[:d, :d] += kw[k] * np.eye(d)
        Qii += tw[k] * np.outer(a, a)
        Qjj[:d, :d] += kw[k] * np.eye(d)
        Qjj[d, d] += tw[k]
        Qij[:d, :d] -= kw[k] * R[k]  # -kappa S_Y R S_Y^T
        Qij[:, d] -= tw[k] * a  # -tau a s_p^T
        Dii[i] += Qii
        Dii[j] += Qjj
        if j == i + 1:
            Bio[i] = Bio.get(i, np.zeros((dp1, dp1))) + Qij
    return Dii, Bio


def make_tri_solver(idx: np.ndarray, Ddamp: np.ndarray, Bio: dict):
    """The block-Thomas solve of one robot block's chain (``idx`` its
    sorted, contiguous pose indices), factored once."""
    dp1 = Ddamp.shape[-1]
    m = len(idx)
    A = Ddamp[idx]
    B = np.stack([Bio.get(int(idx[q]), np.zeros((dp1, dp1))) for q in range(m - 1)])
    Ainv = np.zeros_like(A)
    Amod = A.copy()
    for q in range(m):
        if q > 0:
            Amod[q] = A[q] - B[q - 1].T @ Ainv[q - 1] @ B[q - 1]
        Ainv[q] = np.linalg.inv(Amod[q])

    def solve(Vb):
        # row convention: z M = v  =>  M z^T = v^T (M symmetric)
        Y = np.swapaxes(Vb, 1, 2).copy()
        for q in range(1, m):
            Y[q] -= B[q - 1].T @ (Ainv[q - 1] @ Y[q - 1])
        Z = np.zeros_like(Y)
        Z[m - 1] = Ainv[m - 1] @ Y[m - 1]
        for q in range(m - 2, -1, -1):
            Z[q] = Ainv[q] @ (Y[q] - B[q] @ Z[q + 1])
        return np.swapaxes(Z, 1, 2)
    return solve


def run_cg(G, mask, Msolve, rhess, proj, kappa=0.1, maxit=400):
    """Preconditioned Steihaug-tCG iterations to the residual target
    ‖r‖ ≤ ‖r0‖·min(κ, ‖r0‖): (iterations, how it ended)."""
    g = G * mask
    r0 = g
    z0 = proj(Msolve(r0), mask)
    rz = (r0 * z0).sum()
    r0n = np.sqrt((r0 * r0).sum())
    target = r0n * min(kappa, r0n)
    rr, p = r0, -z0
    for k in range(maxit):
        Hp = rhess(p, mask)
        pHp = (p * Hp).sum()
        if pHp <= 0:
            return k + 1, "negcurv"
        alpha = rz / pHp
        rr = rr + alpha * Hp
        if np.sqrt((rr * rr).sum()) <= target:
            return k + 1, "converged"
        z = proj(Msolve(rr), mask)
        rz_new = (rr * z).sum()
        beta = rz_new / rz
        rz = rz_new
        p = -z + beta * p
    return maxit, "budget"


def run(world: str, num_robots: int, device, dtype: str = "float32", ylift=None) -> dict:
    data, _, _, _ = roofline.load_world(world, num_robots=num_robots)
    prob = LiftedProblem.from_data(data, r=5, dtype=common.DTYPES[dtype], device=device)
    cfg = AgentConfig(num_robots=num_robots, update_rule=UpdateRule.PARALLEL,
                      local_initialization_method=InitMethod.CHORDAL,
                      relative_change_tolerance=0.0, max_iteration_number=100,
                      RTR_iterations=3, RTR_tCG_iterations=200,
                      RTR_gradnorm_tol=0.5, dtype=dtype)
    eng = RBCDEngine(prob, cfg)
    before = common.counts()
    st = eng.initialize(ylift=ylift)
    Xt, e = st.X, prob.edges
    X = Xt.double().cpu().numpy()
    n, r, dp1 = X.shape
    w = st.weights.double().cpu().numpy()
    Dii, Bio = chain_blocks(X, e, w)
    parity = None
    if w.min() == 1.0:  # the diagonal blocks against precond_blocks (undamped)
        Pj = quadratic.precond_blocks(e, n, damping=0.0).double().cpu().numpy()
        parity = float(np.abs(Pj - Dii).max() / max(1.0, np.abs(Dii).max()))
        log(f"diag-block parity vs precond_blocks: rel err {parity:.2e}")
    scale = np.maximum(np.trace(Dii, axis1=-2, axis2=-1)[:, None, None] / dp1, 1.0)
    Ddamp = Dii + DAMPING * scale * np.eye(dp1)
    Dinv = np.linalg.inv(Ddamp)

    def on_device(V):
        return torch.as_tensor(V, dtype=prob.dtype, device=prob.device)

    def rhess(V, mask):
        return quadratic.rhess_vp(Xt, on_device(V), e).double().cpu().numpy() * mask

    def proj(V, mask):
        return stiefel.proj_tangent(Xt, on_device(V)).double().cpu().numpy() * mask

    def jac_solve(V):
        return np.einsum("nab,nbc->nac", V, Dinv)

    G = quadratic.rgrad(Xt, e).double().cpu().numpy()
    robot_of = np.asarray(prob.robot_of_pose)
    masks = eng._masks.double().cpu().numpy()
    rows = []
    for rb in range(prob.num_robots):
        mb = masks[rb].reshape(n, 1, 1)
        idx = np.where(robot_of == rb)[0]
        tri = make_tri_solver(idx, Ddamp, Bio)

        def tri_solve(V, idx=idx, tri=tri):
            out = np.zeros_like(V)
            out[idx] = tri(V[idx])
            return out

        kj, sj = run_cg(G, mb, jac_solve, rhess, proj)
        kt, stt = run_cg(G, mb, tri_solve, rhess, proj)
        rows.append({"robot": rb, "jacobi": kj, "jacobi_end": sj, "tridiag": kt,
                     "tridiag_end": stt, "ratio": kj / max(kt, 1)})
        log(f"robot {rb}: jacobi {kj} ({sj})  tridiag {kt} ({stt})  ratio "
            f"{kj / max(kt, 1):.2f}x")
    # no kernel is on this path: the operators are the plain ops
    return {"world": world, "poses": n, "diag_block_parity_rel_err": parity, "robots": rows,
            "launches": common.launched(before)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", default="sphere2500", choices=sorted(roofline.STAND_INS))
    p.add_argument("--num_robots", type=int, default=5)
    common.add_args(p)
    a = common.parse(p, argv, "proto_chain_precond")
    if a.dtype == "float64" and a.device == "cuda":
        p.error("--dtype float64 initializes through the engine's plain route, which runs "
                "on the CPU only (--device cpu)")
    card = common.card(a.device)
    log(f"card {card}; {a.dtype} on {a.device}")
    out = dict(run(a.world, a.num_robots, a.device, a.dtype), card=card, device=a.device,
               dtype=a.dtype)
    return common.emit(out, a.out)


if __name__ == "__main__":
    main()
