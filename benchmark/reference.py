"""The plain reference of one request: graph → rounded SE(3) trajectory.

NumPy and SciPy only, written for the benchmark from the algorithm's
definition (dpgo's RBCD with RTR block solves, mit-acl/dpgo and the
reference launch files' settings), independent of the program's code:

* the cost f(X) = Σ_e w_e [κ_e ‖Y_j − Y_i R_e‖² + τ_e ‖p_j − p_i − Y_i t_e‖²]
  is evaluated from the residuals, and its gradient and Hessian from the
  assembled sparse connection Laplacian Q (f = tr(M Q Mᵀ), M = [X_1 … X_n]);
* chordal initialization is the exact sparse least-squares solve, the
  odometry initialization the composed odometry chain, both aligned across
  robots through shared loop closures and anchored at the first pose;
* block updates in turn (RoundRobin), each a Riemannian trust-region solve
  with Steihaug–Toint truncated CG preconditioned by the damped
  block-Jacobi blocks of Q, on the robot's block with every other pose
  fixed; a robot's relative change is its block's Frobenius movement,
  passed to its neighbours as a lower bound;
* GNC-TLS weight rounds with the adaptive threshold schedule and resets,
  settled by residual at the end; SE-Sync rounding, anchored.

The initialization and the rounding's small eigenproblems run in NumPy on
the host; the block solves in plain PyTorch on a device, the card once the
program's state is freed (or the CPU). ``Arith(control=True)`` computes the
solves in the control's precision: float32 with every product's operands
rounded to TF32 (10 mantissa bits), the tensor cores' float32 mode.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, Optional

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

ODOMETRY, SHARED_LOOP_CLOSURE = 0, 2


class Arith:
    """The working precision of the solves and their device: float64, or
    the control's TF32 products in float32."""

    def __init__(self, control: bool = False, device="cpu"):
        self.control = control
        self.dtype = torch.float32 if control else torch.float64
        self.device = torch.device(device)
        self.eps = 1e-30 if control else 1e-300

    def t(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)

    def q(self, a: torch.Tensor) -> torch.Tensor:
        """An operand of a product, in the working precision."""
        if not self.control:
            return a
        b = a.contiguous().view(torch.int32)
        return ((b + 0x1000) & -8192).view(torch.float32)

    def mm(self, a, b):
        return torch.matmul(self.q(a), self.q(b))

    def sparse(self, Qm: sp.csr_matrix) -> torch.Tensor:
        """A sparse operand, as a CSR tensor on the device."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # "beta state", invariant checks
            return torch.sparse_csr_tensor(
                torch.as_tensor(Qm.indptr.astype(np.int64), device=self.device),
                torch.as_tensor(Qm.indices.astype(np.int64), device=self.device),
                self.q(self.t(Qm.data)), size=Qm.shape)

    def spmm(self, Qt: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
        return Qt @ self.q(Z)


def tf32(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to TF32 (10 mantissa bits), as float64."""
    b = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32).astype(np.float64)


def _dots(*pairs):
    """Inner products of tensor pairs, read on the host together."""
    return torch.stack([torch.sum(u * v) for u, v in pairs]).tolist()


def project_to_so(M: np.ndarray) -> np.ndarray:
    """Nearest rotation of each (…, d, d) matrix."""
    U, _, Vt = np.linalg.svd(M)
    det = np.linalg.det(U @ Vt)
    S = np.ones(M.shape[:-1])
    S[..., -1] = det
    return (U * S[..., None, :]) @ Vt


def se_compose(A, B):
    d = A.shape[-2]
    R = A[..., :d] @ B[..., :d]
    t = A[..., d] + np.einsum("...ij,...j->...i", A[..., :d], B[..., d])
    return np.concatenate([R, t[..., None]], -1)


def se_inverse(A):
    d = A.shape[-2]
    Rt = np.swapaxes(A[..., :d], -1, -2)
    return np.concatenate([Rt, -np.einsum("...ij,...j->...i", Rt, A[..., d])[..., None]], -1)


def anchor(T):
    return se_compose(np.broadcast_to(se_inverse(T[0]), T.shape), T)


def lifting_matrix(seed: int, r: int, d: int) -> np.ndarray:
    """The r × d lifting matrix on St(d, r) drawn from ``seed``: the
    sign-fixed QR factor of a Gaussian."""
    A = np.random.default_rng([seed, 7]).standard_normal((r, d))
    Q, R = np.linalg.qr(A)
    s = np.sign(np.diag(R))
    s[s == 0] = 1.0
    return Q * s[None, :]


class Problem:
    """A graph's edges in global pose indices, on the host and the device."""

    def __init__(self, g: Dict[str, np.ndarray], cfg: Dict, ar: Arith):
        self.g, self.cfg, self.ar = g, cfg, ar
        self.num_poses = np.asarray(g["num_poses"], np.int64)
        self.R_n = len(self.num_poses)
        self.offsets = np.concatenate([[0], np.cumsum(self.num_poses)])
        self.n = int(self.offsets[-1])
        self.d = g["R"].shape[-1]
        self.r = int(cfg["relaxation_rank"])
        self.src = self.offsets[g["src_robot"]] + g["src_frame"]
        self.dst = self.offsets[g["dst_robot"]] + g["dst_frame"]
        self.is_loop = (g["edge_type"] != ODOMETRY) & ~g["fixed_weight"]
        rob = np.repeat(np.arange(self.R_n), self.num_poses)
        a, b = rob[self.src], rob[self.dst]
        cross = a != b
        self.adj = np.zeros((self.R_n, self.R_n), bool)
        self.adj[a[cross], b[cross]] = True
        self.adj[b[cross], a[cross]] = True
        dev = ar.device
        self.touch = [torch.as_tensor(np.flatnonzero((a == k) | (b == k)), device=dev)
                      for k in range(self.R_n)]
        self.src_t = torch.as_tensor(self.src, device=dev)
        self.dst_t = torch.as_tensor(self.dst, device=dev)
        self.R_t, self.t_t = ar.t(g["R"]), ar.t(g["t"])[..., None]
        # the host's products in the working precision (the initialization's)
        self.qn = tf32 if ar.control else (lambda x: x)
        self.kappa_t, self.tau_t = ar.t(g["kappa"]), ar.t(g["tau"])

    # --- the cost from residuals

    def cost(self, X: torch.Tensor, w: torch.Tensor, edges=None) -> torch.Tensor:
        """f(X) under weights ``w`` (a 0-d tensor), over ``edges`` or all."""
        ar, d = self.ar, self.d
        e = slice(None) if edges is None else edges
        Xi, Xj = X[self.src_t[e]], X[self.dst_t[e]]
        r1 = Xj[..., :d] - ar.mm(Xi[..., :d], self.R_t[e])
        r2 = Xj[..., d] - Xi[..., d] - ar.mm(Xi[..., :d], self.t_t[e])[..., 0]
        return (torch.sum(w[e] * self.kappa_t[e] * torch.sum(r1 * r1, dim=(-2, -1)))
                + torch.sum(w[e] * self.tau_t[e] * torch.sum(r2 * r2, dim=-1)))

    # --- the connection Laplacian and its block-Jacobi preconditioner

    def laplacian(self, w: np.ndarray) -> sp.csr_matrix:
        """Q with f(X) = tr(M Q Mᵀ), in (d+1) × (d+1) pose blocks."""
        d, g, D = self.d, self.g, self.d + 1
        kw, tw = w * g["kappa"], w * g["tau"]
        R, t = g["R"], g["t"]
        E = len(kw)
        Qii = np.zeros((E, D, D))  # from A_e = [R; 0] (κ) and b_e = [t; 1] (τ) at src
        Qii[:, :d, :d] = kw[:, None, None] * (R @ np.swapaxes(R, -1, -2)) \
            + tw[:, None, None] * t[:, :, None] * t[:, None, :]
        Qii[:, :d, d] = Qii[:, d, :d] = tw[:, None] * t
        Qii[:, d, d] = tw
        Qjj = np.zeros((E, D, D))
        Qjj[:, :d, :d] = kw[:, None, None] * np.eye(d)
        Qjj[:, d, d] = tw
        Qij = np.zeros((E, D, D))
        Qij[:, :d, :d] = -kw[:, None, None] * R
        Qij[:, :d, d] = -tw[:, None] * t
        Qij[:, d, d] = -tw
        blocks = np.concatenate([Qii, Qjj, Qij, np.swapaxes(Qij, -1, -2)])
        bi = np.concatenate([self.src, self.dst, self.src, self.dst])
        bj = np.concatenate([self.src, self.dst, self.dst, self.src])
        ii, jj = np.meshgrid(np.arange(D), np.arange(D), indexing="ij")
        rows = (bi[:, None, None] * D + ii).ravel()
        cols = (bj[:, None, None] * D + jj).ravel()
        N = self.n * D
        Qm = sp.csr_matrix((blocks.ravel(), (rows, cols)), shape=(N, N))
        Qm.sum_duplicates()
        return Qm

    def precond_inverse(self, Qm) -> np.ndarray:
        """Inverses of Q's diagonal pose blocks, damped by 1 % of their
        mean diagonal (at least 1)."""
        D = self.d + 1
        idx = np.arange(self.n)[:, None, None] * D
        rr = np.broadcast_to(idx + np.arange(D)[None, :, None], (self.n, D, D))
        cc = np.broadcast_to(idx + np.arange(D)[None, None, :], (self.n, D, D))
        blocks = np.asarray(Qm[rr.ravel(), cc.ravel()]).reshape(self.n, D, D)
        scale = np.maximum(np.trace(blocks, axis1=-2, axis2=-1) / D, 1.0)
        return np.linalg.inv(blocks + 1e-2 * scale[:, None, None] * np.eye(D))


def _to_Z(X):
    n, r, D = X.shape
    return X.transpose(1, 2).reshape(n * D, r)


def _from_Z(Z, r, D):
    return Z.reshape(-1, D, r).transpose(1, 2)


class BlockSolver:
    """RTR on one robot's block (X outside it fixed), through Q's rows."""

    def __init__(self, pb: Problem, Qm, Pinv, k: int, w: torch.Tensor):
        self.pb, self.ar, self.k, self.w = pb, pb.ar, k, w
        D = pb.d + 1
        o, nk = int(pb.offsets[k]), int(pb.num_poses[k])
        self.rows = slice(o, o + nk)
        Q_rows = Qm[o * D:(o + nk) * D]
        self.Q_rows = self.ar.sparse(Q_rows)
        self.Q_bb = self.ar.sparse(Q_rows[:, o * D:(o + nk) * D].tocsr())
        self.Pinv = self.ar.t(Pinv[o:o + nk])
        self.edges = pb.touch[k]

    def _proj(self, Y, Yt, V):
        """Tangent projection at the block's Y (Yt = Yᵀ per pose)."""
        d, ar = self.pb.d, self.ar
        S = ar.mm(Yt, V[..., :d])
        S = 0.5 * (S + S.transpose(1, 2))
        return torch.cat([V[..., :d] - ar.mm(Y, S), V[..., d:]], dim=-1)

    def _egrad(self, Xb, C):
        r, D = self.pb.r, self.pb.d + 1
        return _from_Z(2.0 * (self.ar.spmm(self.Q_bb, _to_Z(Xb)) + C), r, D)

    def _retract(self, Xb, eta, iters: int = 20):
        """Polar retraction (Newton–Schulz from A / ‖A‖_F)."""
        d, ar = self.pb.d, self.ar
        A = Xb[..., :d] + eta[..., :d]
        Z = A * torch.rsqrt(torch.clamp(torch.sum(A * A, dim=(-2, -1)), min=1e-12))[:, None, None]
        I3 = 3.0 * torch.eye(d, dtype=ar.dtype, device=ar.device)
        for _ in range(iters):
            Z = 0.5 * ar.mm(Z, I3 - ar.mm(Z.transpose(1, 2), Z))
        return torch.cat([Z, Xb[..., d:] + eta[..., d:]], dim=-1)

    def solve(self, X: torch.Tensor, p: Dict):
        """Returns (X with the block solved, tCG iterations)."""
        ar, d, eps = self.ar, self.pb.d, self.ar.eps
        Xb = X[self.rows]
        C = ar.spmm(self.Q_rows, _to_Z(X)) - ar.spmm(self.Q_bb, _to_Z(Xb))
        Xw = X.clone()

        def cost(Xb_):
            Xw[self.rows] = Xb_
            return self.pb.cost(Xw, self.w, self.edges)

        def at(Xb_):
            Y = Xb_[..., :d].contiguous()
            return Y, Y.transpose(1, 2).contiguous()

        f = cost(Xb)
        G = self._egrad(Xb, C)
        Y, Yt = at(Xb)
        g = self._proj(Y, Yt, G)
        gn = math.sqrt(_dots((g, g))[0])
        radius, k, ktot = float(p["initial_radius"]), 0, 0
        while k < p["RTR_iterations"] and not gn <= p["RTR_gradnorm_tol"]:
            # Steihaug–Toint truncated CG on the block
            S = ar.mm(Yt, G[..., :d])
            S = 0.5 * (S + S.transpose(1, 2))

            def hess(V):
                EH = self._egrad(V, 0.0)
                EH = torch.cat([EH[..., :d] - ar.mm(V[..., :d], S), EH[..., d:]], dim=-1)
                return self._proj(Y, Yt, EH)

            def prec(V):
                return self._proj(Y, Yt, ar.mm(V, self.Pinv))

            r_ = g
            z = prec(r_)
            r_z, rr0 = _dots((r_, z), (r_, r_))
            eta = torch.zeros_like(Xb)
            Heta = torch.zeros_like(Xb)
            delta = -z
            r0 = math.sqrt(max(rr0, eps))
            target = r0 * min(r0 ** p["tcg_theta"], p["tcg_kappa"])
            kt = 0
            while kt < p["RTR_tCG_iterations"]:
                Hd = hess(delta)
                dHd, ee, ed, dd = _dots((delta, Hd), (eta, eta), (eta, delta), (delta, delta))
                alpha = r_z / (dHd if dHd > 0 else 1.0)
                kt += 1
                if dHd <= 0 or ee + 2 * alpha * ed + alpha * alpha * dd >= radius * radius:
                    dd = max(dd, eps)
                    disc = max(ed * ed + dd * (radius * radius - ee), 0.0)
                    tau = (-ed + math.sqrt(disc)) / dd
                    eta = eta + tau * delta
                    Heta = Heta + tau * Hd
                    break
                eta = eta + alpha * delta
                Heta = Heta + alpha * Hd
                r_ = r_ + alpha * Hd
                z = prec(r_)
                rr, r_z_new = _dots((r_, r_), (r_, z))
                if math.sqrt(max(rr, 0.0)) <= target:
                    break
                delta = (r_z_new / max(r_z, eps)) * delta - z
                r_z = r_z_new
            ktot += kt
            X_try = self._retract(Xb, eta)
            ge, eHe, nn, f_, f_try = torch.stack([
                torch.sum(g * eta), torch.sum(eta * Heta), torch.sum(eta * eta),
                f, cost(X_try)]).tolist()
            pred = -(ge + 0.5 * eHe)
            rho = (f_ - f_try) / (pred if abs(pred) > eps else eps)
            if rho < 0.25:
                radius *= 0.25
            elif rho > 0.75 and math.sqrt(nn) >= 0.99 * radius:
                radius = min(2.0 * radius, p["max_radius"])
            if rho > 0.1 and pred > 0:
                Xb, f, G = X_try, ar.t(f_try), self._egrad(X_try, C)
                Y, Yt = at(Xb)
            g = self._proj(Y, Yt, G)
            gn = math.sqrt(_dots((g, g))[0])
            k += 1
        X_out = X.clone()
        X_out[self.rows] = Xb
        return X_out, ktot


# ---------------------------------------------------------------- init


def _chordal(pb: Problem, k: int) -> np.ndarray:
    """Robot k's chordal initialization from its private edges: rotations
    by least squares with R_0 = I, projected to SO(d); then translations by
    least squares with t_0 = 0."""
    g, d = pb.g, pb.d
    nk = int(pb.num_poses[k])
    sel = (g["src_robot"] == k) & (g["dst_robot"] == k)
    i, j = g["src_frame"][sel].astype(np.int64), g["dst_frame"][sel].astype(np.int64)
    R, t = g["R"][sel], g["t"][sel]
    kw, tw = (g["weight"] * g["kappa"])[sel], (g["weight"] * g["tau"])[sel]
    # rotations: residual u_j − R_eᵀ u_i for the columns u of each Rᵀ
    I = np.broadcast_to(np.eye(d), R.shape)
    blocks = np.concatenate([kw[:, None, None] * (R @ np.swapaxes(R, -1, -2)),
                             kw[:, None, None] * I, -kw[:, None, None] * R,
                             -kw[:, None, None] * np.swapaxes(R, -1, -2)])
    bi, bj = np.concatenate([i, j, i, j]), np.concatenate([i, j, j, i])
    a, b = np.meshgrid(np.arange(d), np.arange(d), indexing="ij")
    L = sp.csr_matrix((blocks.ravel(), ((bi[:, None, None] * d + a).ravel(),
                                        (bj[:, None, None] * d + b).ravel())),
                      shape=(nk * d, nk * d))
    free = np.arange(d, nk * d)
    rhs = -L[free][:, :d] @ np.eye(d)
    q = pb.qn
    L.data = q(L.data)
    U = spla.spsolve(L[free][:, free].tocsc(), q(rhs))
    Rt = np.concatenate([np.eye(d)[None], np.asarray(U).reshape(nk - 1, d, d)])
    Rk = project_to_so(np.swapaxes(Rt, -1, -2))
    # translations: a τ-weighted graph Laplacian
    c = tw[:, None] * np.einsum("eab,eb->ea", Rk[i], t)
    Lt = sp.csr_matrix((np.concatenate([tw, tw, -tw, -tw]),
                        (np.concatenate([i, j, i, j]), np.concatenate([i, j, j, i]))),
                       shape=(nk, nk))
    bt = np.zeros((nk, d))
    np.add.at(bt, j, c)
    np.add.at(bt, i, -c)
    tk = np.zeros((nk, d))
    Lt.data = q(Lt.data)
    tk[1:] = np.asarray(spla.spsolve(Lt[1:, 1:].tocsc(), q(bt[1:]))).reshape(nk - 1, d)
    return np.concatenate([Rk, tk[..., None]], -1)


def _odometry(pb: Problem, k: int) -> np.ndarray:
    """Robot k's poses composed along its odometry."""
    g, d = pb.g, pb.d
    nk = int(pb.num_poses[k])
    sel = (g["src_robot"] == k) & (g["dst_robot"] == k) & (g["edge_type"] == ODOMETRY)
    rel = np.zeros((nk - 1, d, d + 1))
    rel[:, :, :d] = np.eye(d)
    f = g["src_frame"][sel]
    ok = f < nk - 1
    rel[f[ok], :, :d] = g["R"][sel][ok]
    rel[f[ok], :, d] = g["t"][sel][ok]
    T = np.zeros((nk, d, d + 1))
    T[0, :, :d] = np.eye(d)
    for a in range(nk - 1):
        T[a + 1] = se_compose(pb.qn(T[a]), pb.qn(rel[a]))
    return T


def initial_trajectory(pb: Problem) -> np.ndarray:
    """Local initializations, aligned robot to robot through the first
    shared loop closure that reaches each (breadth first from robot 0),
    anchored at the first pose."""
    g, d, cfg = pb.g, pb.d, pb.cfg
    method = cfg["local_initialization_method"]
    if method not in ("Chordal", "Odometry"):
        raise ValueError(f"initialization {method!r} is not in the reference")
    local = [(_chordal if method == "Chordal" else _odometry)(pb, k) for k in range(pb.R_n)]
    q = pb.qn
    compose = lambda A, B: se_compose(q(A), q(B))
    ident = np.concatenate([np.eye(d), np.zeros((d, 1))], -1)
    G = [None] * pb.R_n
    G[0] = ident
    if cfg["multirobot_initialization"] and pb.R_n > 1:
        order = np.flatnonzero(g["edge_type"] == SHARED_LOOP_CLOSURE)
        frontier, seen = [0], {0}
        while frontier:
            a = frontier.pop(0)
            for e in order:
                ra, rb = int(g["src_robot"][e]), int(g["dst_robot"][e])
                Me = np.concatenate([g["R"][e], g["t"][e][:, None]], -1)
                i, j = int(g["src_frame"][e]), int(g["dst_frame"][e])
                if ra == a and rb not in seen:
                    G[rb] = compose(compose(compose(G[a], local[a][i]), Me),
                                    se_inverse(local[rb][j]))
                    seen.add(rb)
                    frontier.append(rb)
                elif rb == a and ra not in seen:
                    G[ra] = compose(compose(G[a], local[a][j]),
                                    se_inverse(compose(local[ra][i], Me)))
                    seen.add(ra)
                    frontier.append(ra)
    T = np.concatenate([compose(np.broadcast_to(G[k] if G[k] is not None else ident,
                                                local[k].shape), local[k])
                        for k in range(pb.R_n)])
    return compose(np.broadcast_to(se_inverse(T[0]), T.shape), T)


# ---------------------------------------------------------------- rounding, GNC


def round_solution(X: torch.Tensor, ar: Arith) -> np.ndarray:
    """SE-Sync rounding: X projected on the top-d left singular subspace of
    M = [X_1 … X_n], the reflection fixed by a majority of determinants,
    each rotation projected to SO(d)."""
    n, r, D = X.shape
    d = D - 1
    M = X.transpose(0, 1).reshape(r, n * D)
    _, V = np.linalg.eigh(ar.mm(M, M.T).cpu().numpy().astype(np.float64))
    U = ar.t(V[:, ::-1][:, :d].copy())
    Xd = ar.mm(U.T[None], X).cpu().numpy().astype(np.float64)
    if np.sum(np.sign(np.linalg.det(Xd[:, :, :d]))) < 0:
        Xd[:, d - 1] *= -1.0
    return np.concatenate([project_to_so(Xd[:, :, :d]), Xd[:, :, d:]], -1)


def residuals(T: np.ndarray, pb: Problem) -> np.ndarray:
    g, d = pb.g, pb.d
    Ti, Tj = T[pb.src], T[pb.dst]
    dR = Tj[..., :d] - Ti[..., :d] @ g["R"]
    dt = Tj[..., d] - Ti[..., d] - np.einsum("eab,eb->ea", Ti[..., :d], g["t"])
    sq = g["kappa"] * np.sum(dR * dR, axis=(-2, -1)) + g["tau"] * np.sum(dt * dt, -1)
    return np.sqrt(np.maximum(sq, 0.0))


def gnc_weights(r, mu, barc):
    r2, c2 = r * r, barc * barc
    mid = barc / np.maximum(r, 1e-12) * math.sqrt(mu * (mu + 1.0)) - mu
    w = np.where(r2 >= (mu + 1.0) / mu * c2, 0.0, np.where(r2 <= mu / (mu + 1.0) * c2, 1.0, mid))
    return np.clip(w, 0.0, 1.0)


# ---------------------------------------------------------------- the solve


def _checked(cfg: Dict) -> bool:
    """Whether ``cfg`` is robust (GNC-TLS); raises on what the reference
    does not run."""
    if cfg["update_rule"] != "RoundRobin" or cfg.get("acceleration", False):
        raise ValueError("the reference runs the RoundRobin rule without acceleration")
    robust = cfg["robust_cost_type"]
    if robust not in ("L2", "GNC_TLS"):
        raise ValueError(f"robust cost {robust!r} is not in the reference")
    if cfg.get("relative_change_metric", "block_frobenius") != "block_frobenius":
        raise ValueError("the reference measures a block's change by its Frobenius norm")
    gnc = robust == "GNC_TLS"
    if gnc and (cfg["GNC_schedule"] != "adaptive" or not cfg["gnc_finalize_by_residual"]
                or cfg["weight_convergence_threshold"] > 0):
        raise ValueError("the reference runs the adaptive GNC schedule, settled by "
                         "residual, without weight freezing")
    return gnc


class Schedule:
    """When a solve makes its weight rounds and when it stops, as the
    reference's rule has it: a round before update ``it`` once every robot's
    relative change is under the inner tolerance, or after the inner budget
    of updates since the last (a fixed cadence without an inner tolerance),
    until K rounds; the solve stops once every robot's change is under the
    tolerance and no round is due, or at the budget of updates."""

    def __init__(self, cfg: Dict, R_n: int):
        self.gnc = _checked(cfg)
        self.R_n = R_n
        self.tol = float(cfg["relative_change_tolerance"])
        self.K = int(cfg.get("robust_opt_num_weight_updates", 0)) if self.gnc else 0
        self.inner_n = int(cfg.get("robust_opt_inner_iters_per_robot", 0)) * R_n
        self.inner_tol = cfg.get("robust_opt_inner_tol")
        self.max_iters = int(cfg["max_iteration_number"])
        if self.gnc:  # the reference's budget for GNC runs
            self.max_iters = (self.K + 1) * self.inner_n - 2

    def round_due(self, it: int, last_wu: int, rel: np.ndarray, wuc: int) -> bool:
        if not self.gnc or it == 0 or wuc >= self.K:
            return False
        if self.inner_tol is None:
            return it % self.inner_n == 0
        return bool(np.all(rel < self.inner_tol)) or it - last_wu >= self.inner_n

    def stops(self, rel: np.ndarray, wuc: int) -> bool:
        return bool(np.all(rel < self.tol)) and wuc >= self.K

    def gaps(self, rels, rounds_at, iterations: int) -> int:
        """How far a solve's own record departs from the rule, replayed on
        the relative changes it read after each update (``rels``): the
        rounds it made where the rule makes none or missed where the rule
        makes one (``rounds_at``: the updates they came before), plus 1 if
        it stopped after another number of updates than the rule."""
        rel = np.full(self.R_n, np.inf)
        last_wu = wuc = 0
        due, stop = [], None
        for it in range(self.max_iters):
            if self.round_due(it, last_wu, rel, wuc):
                due.append(it)
                last_wu, wuc = it, wuc + 1
            if it >= len(rels):
                break
            rel = np.asarray(rels[it], np.float64)
            if self.stops(rel, wuc):
                stop = it + 1
                break
        else:
            stop = self.max_iters
        return len(set(due) ^ set(int(a) for a in rounds_at)) + int(stop != int(iterations))


def _params(cfg: Dict) -> Dict:
    return dict(cfg, initial_radius=10.0, max_radius=1e4, tcg_kappa=0.1, tcg_theta=1.0)


def _solvers(pb: Problem, w: np.ndarray):
    Qm = pb.laplacian(w)
    Pinv = pb.precond_inverse(Qm)
    return [BlockSolver(pb, Qm, Pinv, k, pb.ar.t(w)) for k in range(pb.R_n)]


def _update(pb: Problem, blocks, X, it: int, rel: np.ndarray, p: Dict):
    """Update ``it`` (robot it mod R): (X, rel change, tCG iterations)."""
    k = it % pb.R_n
    X_new, kt = blocks[k].solve(X, p)
    moved = math.sqrt(float(torch.sum((X_new - X) ** 2)))
    rel = np.where(pb.adj[k], np.maximum(rel, moved), rel)
    rel[k] = moved
    return X_new, rel, kt


def _round_weights(pb: Problem, X, w: np.ndarray, fixed: np.ndarray, wuc: int,
                   cfg: Dict) -> np.ndarray:
    """GNC round ``wuc`` (0-based): TLS weights at μ = 3 and the threshold
    annealed from the loop closures' 90th-percentile residual to barc, on
    the rounded state; fixed edges keep theirs."""
    res = residuals(round_solution(X, pb.ar), pb)
    barc = float(cfg["GNC_barc"])
    K = int(cfg["robust_opt_num_weight_updates"])
    loops = res[pb.is_loop]
    p90 = max(float(np.quantile(loops, 0.9)) if loops.size else barc, barc)
    alpha = (wuc + 1.0) / max(K, 1)
    barc_k = max(math.exp((1 - alpha) * math.log(p90) + alpha * math.log(barc)), barc)
    return np.where(fixed, w, gnc_weights(res, 3.0, barc_k))


def _settle(pb: Problem, T: np.ndarray, w: np.ndarray, cfg: Dict) -> np.ndarray:
    """Undecided loop-closure weights settled by the final residual."""
    und = pb.is_loop & (w > 1e-6) & (w < 1.0 - 1e-6)
    return np.where(und, (residuals(T, pb) <= float(cfg["GNC_barc"])).astype(float), w)


def settle_gaps(g: Dict[str, np.ndarray], cfg: Dict, T: np.ndarray, w_round: np.ndarray,
                w_final: np.ndarray, margin: float = 1e-3) -> int:
    """The loop-closure weights a robust solve ended with that differ from
    its last round's weights settled by the rule on its own trajectory
    ``T`` (in float64): every edge keeps its round's weight, but an
    undecided loop closure, which goes to 1 if its residual is at most barc
    and else to 0. Edges whose residual lies within ``margin`` × barc of
    barc are not counted: there float32 may round either way."""
    pb = Problem(g, cfg, Arith())
    T = np.asarray(T, np.float64)
    w_ref = _settle(pb, T, np.asarray(w_round, np.float64), cfg)
    barc = float(cfg["GNC_barc"])
    near = np.abs(residuals(T, pb) - barc) <= margin * barc
    differ = np.asarray(w_final, np.float64) != w_ref
    return int(np.sum(differ & ~near))


def solve(g: Dict[str, np.ndarray], cfg: Dict, ylift: np.ndarray,
          control: bool = False, device="cpu") -> Dict:
    """One request's answer: ``T`` (n, d, d+1) rounded and anchored,
    ``cost`` (the weighted cost of the final iterate ``X`` under the weights
    ``w_pre``, before they are settled), ``iterations`` (block updates),
    ``weights`` (settled), ``tcg``, and for a robust configuration its
    ``stages`` (the start, each weight round's state before it and the
    weights it set, the end); the block solves on ``device``."""
    ar = Arith(control, device)
    pb = Problem(g, cfg, ar)
    gnc = _checked(cfg)
    p = _params(cfg)
    X0 = ar.t(np.einsum("rd,ndk->nrk", ylift, initial_trajectory(pb)))
    X = X0
    w = np.asarray(g["weight"], np.float64).copy()
    fixed = ~pb.is_loop if gnc else np.ones_like(pb.is_loop)
    R_n = pb.R_n
    rule = Schedule(cfg, R_n)
    rel = np.full(R_n, np.inf)
    it = last_wu = wuc = tcg = 0
    stages = {"start": dict(X=X0, weights=w, iteration=0), "rounds": []}
    blocks = _solvers(pb, w)
    while it < rule.max_iters:
        if rule.round_due(it, last_wu, rel, wuc):
            last_wu = it
            w = _round_weights(pb, X, w, fixed, wuc, cfg)
            stages["rounds"].append(dict(X=X, iteration=it, weights=w))
            rel = np.full(R_n, np.inf)
            wuc += 1
            if wuc <= int(cfg["robust_opt_num_resets"]):
                X = X0
            blocks = _solvers(pb, w)
        X, rel, kt = _update(pb, blocks, X, it, rel, p)
        tcg += kt
        it += 1
        if rule.stops(rel, wuc):
            break
    cost = float(pb.cost(X, ar.t(w)))
    stages["final"] = dict(X=X, weights=w, iteration=it)
    Tr = round_solution(X, ar)
    w_pre = w
    if gnc:
        w = _settle(pb, Tr, w, cfg)
    host = lambda v: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
    stages = {"start": {k: host(v) for k, v in stages["start"].items()},
              "rounds": [{k: host(v) for k, v in r.items()} for r in stages["rounds"]],
              "final": {k: host(v) for k, v in stages["final"].items()}}
    return dict(T=anchor(Tr), cost=cost, iterations=it, weights=w, tcg=tcg,
                X=host(X), w_pre=w_pre, stages=stages if gnc else None)


def follow(g: Dict[str, np.ndarray], cfg: Dict, ylift: np.ndarray, stages: Dict,
           device="cpu") -> Dict[str, float]:
    """A robust solve judged stage by stage from its own states, in float64:

    * ``init``: the start's rounded trajectory against the initialization's;
    * ``round_weights``: the largest gap of each round's weights against the
      round redone on the state the solve held before it;
    * ``stretch`` and ``stretch_cost``: each stretch after a weight round
      redone from the solve's own state and weights at its start (the
      initialization's state after a reset), for as many updates as the
      solve made; the largest gap of the rounded trajectories at its end,
      and of the cost there relative to the reference's.

    The stretch before the first round (every loop closure at weight 1, the
    outliers with them) is not redone: its path is chaotic, float32 and
    float64 runs from one state ending far apart (``PERF.md``); round 1 is
    judged from the state it ended in."""
    ar = Arith(False, device)
    pb = Problem(g, cfg, ar)
    _checked(cfg)
    p = _params(cfg)
    T0 = anchor(initial_trajectory(pb))
    out = {"init": float(np.max(np.abs(rounded(stages["start"]["X"]) - T0)))}
    fixed = ~pb.is_loop
    resets = int(cfg["robust_opt_num_resets"])
    rounds, end = stages["rounds"], stages["final"]
    w_prev = np.asarray(stages["start"]["weights"], np.float64)
    gaps, cgaps, wgaps = [], [], []
    for j, (a, b) in enumerate(zip(rounds, rounds[1:] + [end]), start=1):
        w = np.asarray(a["weights"], np.float64)
        w_ref = _round_weights(pb, ar.t(np.asarray(a["X"], np.float64)), w_prev, fixed,
                               j - 1, cfg)
        wgaps.append(float(np.max(np.abs(w - w_ref))))
        X = ar.t(np.asarray((stages["start"] if j <= resets else a)["X"], np.float64))
        blocks = _solvers(pb, w)
        rel = np.full(pb.R_n, np.inf)
        for it in range(int(a["iteration"]), int(b["iteration"])):
            X, rel, _ = _update(pb, blocks, X, it, rel, p)
        gaps.append(float(np.max(np.abs(anchor(round_solution(X, ar)) - rounded(b["X"])))))
        wt = ar.t(w)
        f_ref = float(pb.cost(X, wt))
        cgaps.append(abs(float(pb.cost(ar.t(np.asarray(b["X"], np.float64)), wt)) - f_ref)
                     / f_ref)
        w_prev = w
    if gaps:
        out.update(round_weights=max(wgaps), stretch=max(gaps), stretch_cost=max(cgaps))
    return out


def state_cost(g: Dict[str, np.ndarray], cfg: Dict, X: np.ndarray, w: np.ndarray) -> float:
    """f(X) under weights ``w`` in float64 on the CPU: how the comparison
    reads a state the program returned."""
    ar = Arith()
    return float(Problem(g, cfg, ar).cost(ar.t(np.asarray(X, np.float64)), ar.t(w)))


def rounded(X: np.ndarray) -> np.ndarray:
    """The anchored rounding of a state the program returned, in float64."""
    ar = Arith()
    return anchor(round_solution(ar.t(np.asarray(X, np.float64)), ar))
