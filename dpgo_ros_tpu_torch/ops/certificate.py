"""SE-Sync-style global-optimality certificate for the lifted PGO problem.

Port of ``dpgo_ros_tpu/ops/certificate.py``. Write the lifted state as the
r×N matrix X (N = n·(d+1): d Stiefel columns and one translation column
per pose) and the cost as f(X) = tr(X Q Xᵀ), Q the sparse PSD operator
that :func:`quadratic.apply_Q` applies. First-order criticality gives the
block-diagonal multipliers

    Λᵢ = sym(Yᵢᵀ ∇f(X)_{Yᵢ}) / 2     (translations: multiplier 0),

and the dual certificate operator is S = Q − Λ̂, Λ̂ = blockdiag(Λᵢ ⊕ 0).
If X is critical (S Xᵀ = 0) and S ⪰ 0, then XᵀX solves the SDP relaxation
and f(X) is its optimum; the rank-d rounding of X is then a global
minimizer of the SE(d) problem whenever rank(X) = d. A negative eigenvalue
of S with eigenvector v makes (0, …, 0, vᵀ) a descent direction one rank
up: the Riemannian staircase step (:func:`escape_direction`, used by
``models/certified.py``).

Λ, Q·X and the criticality residual are computed on X's device (the card
for CUDA tensors). The smallest eigenvalue comes from shifted Lanczos
(scipy ``eigsh``, ARPACK) on the host, over S assembled once as a host
CSR matrix (:func:`s_sparse`), or, with ``host_sparse=False``, over one
:func:`s_matvec` on X's device per Lanczos iteration. An fp32 X is
certified in fp32 (the S matrix and the Lanczos vectors in float32), as
the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dpgo_ros_tpu_torch.ops import quadratic, stiefel
from dpgo_ros_tpu_torch.ops.quadratic import EdgeSet


class CertificateResult(NamedTuple):
    """Outcome of :func:`certify`.

    ``is_global``: S ⪰ −eig_tol·scale and X first-order critical.
    ``min_eig``: smallest eigenvalue of S (absolute units of Q).
    ``crit_residual``: ‖S Xᵀ‖_F / max(1, ‖Q Xᵀ‖_F).
    ``eigvec``: eigenvector of ``min_eig`` as an (n, d+1) array (None when
    criticality failed and no eigensolve ran).
    ``scale``: the largest Frobenius norm of Q's diagonal blocks, the scale
    of the relative tests.
    ``min_eig_check``/``margin_verified``: the second-shift margin guard —
    a verdict decided within ``MARGIN_GUARD_BAND``·scale of the threshold
    is re-checked with an independent spectral shift and trusted only when
    both shifts agree.
    """

    is_global: bool
    min_eig: float
    crit_residual: float
    eigvec: Optional[np.ndarray]
    scale: float
    min_eig_check: Optional[float] = None
    margin_verified: bool = True


def lambda_blocks(X: torch.Tensor, e: EdgeSet) -> torch.Tensor:
    """Per-pose symmetric multipliers Λᵢ = sym(Yᵢᵀ ∇f_{Yᵢ}) / 2, (n, d, d)."""
    d = X.shape[-1] - 1
    G = quadratic.egrad(X, e)
    return stiefel.sym(X[..., :d].transpose(-1, -2) @ G[..., :d]) * 0.5


def s_matvec(V: torch.Tensor, X: torch.Tensor, Lam: torch.Tensor, e: EdgeSet) -> torch.Tensor:
    """S applied to a test state V (n, r_v, d+1): Q(V) − V_Y Λ per pose.
    Rank-agnostic: r_v = 1 certifies; r_v = r gives S Xᵀ."""
    d = X.shape[-1] - 1
    QV = quadratic.apply_Q(V, e)
    LV = V[..., :d] @ Lam
    return QV - torch.cat([LV, torch.zeros_like(V[..., d:])], dim=-1)


def crit_residual(X: torch.Tensor, Lam: torch.Tensor, e: EdgeSet) -> float:
    """‖S Xᵀ‖_F / max(1, ‖Q Xᵀ‖_F): 0 at exact first-order criticality."""
    num = torch.linalg.vector_norm(s_matvec(X, X, Lam, e))
    den = torch.linalg.vector_norm(quadratic.apply_Q(X, e))
    num, den = torch.stack([num, den]).tolist()
    return num / max(1.0, den)


def _q_scale(e: EdgeSet, n: int) -> float:
    """Spectral scale of Q: the largest Frobenius norm of its (undamped)
    diagonal blocks."""
    P = quadratic.precond_blocks(e, n, damping=0.0)
    return float(torch.max(torch.linalg.matrix_norm(P))) + 1e-30


# relative band around the accept threshold inside which a verdict needs
# the second shift's agreement (CertificateResult)
MARGIN_GUARD_BAND = 1e-7


def s_sparse(X: torch.Tensor, Lam: torch.Tensor, e: EdgeSet):
    """S = Q − Λ̂ as a host scipy CSR matrix in fp64. Per edge (i, j) with
    rotation R̃, translation t̃ and effective weights (κw, τw):

        Q_ii = [[κw·R̃R̃ᵀ + τw·t̃t̃ᵀ, τw·t̃], [τw·t̃ᵀ, τw]]
        Q_ij = [[−κw·R̃, −τw·t̃], [0, −τw]]      (Q_ji = Q_ijᵀ)
        Q_jj = [[κw·I_d, 0], [0, τw]]

    and Λ̂ subtracts Λᵢ on pose i's Y block; S v equals :func:`s_matvec`
    of v laid out pose-major ([Y columns | p] per pose)."""
    import scipy.sparse as sp

    host = lambda t: t.detach().cpu().numpy().astype(np.float64)
    n, _, B = X.shape
    d = B - 1
    src, dst = e.src.cpu().numpy(), e.dst.cpu().numpy()
    kw, tw = (host(w) for w in e.effective_weights())
    R, t = host(e.R), host(e.t)
    E = src.shape[0]
    Zii = np.zeros((E, B, B))
    Zii[:, :d, :d] = (kw[:, None, None] * np.einsum("eab,ecb->eac", R, R)
                      + tw[:, None, None] * t[:, :, None] * t[:, None, :])
    Zii[:, :d, d] = Zii[:, d, :d] = tw[:, None] * t
    Zii[:, d, d] = tw
    Zij = np.zeros((E, B, B))
    Zij[:, :d, :d] = -kw[:, None, None] * R
    Zij[:, :d, d] = -tw[:, None] * t
    Zij[:, d, d] = -tw
    Zjj = np.zeros((E, B, B))
    Zjj[:, :d, :d] = kw[:, None, None] * np.eye(d)
    Zjj[:, d, d] = tw
    rows_blk = np.repeat(np.arange(B), B)[None, :]
    cols_blk = np.tile(np.arange(B), B)[None, :]
    rows, cols, vals = [], [], []
    for bi, bj, Z in ((src, src, Zii), (src, dst, Zij),
                      (dst, src, np.swapaxes(Zij, -1, -2)), (dst, dst, Zjj)):
        rows.append((bi[:, None] * B + rows_blk).ravel())
        cols.append((bj[:, None] * B + cols_blk).ravel())
        vals.append(Z.reshape(E, -1).ravel())
    pidx = np.arange(n)[:, None] * B
    rows.append((pidx + np.repeat(np.arange(d), d)[None, :]).ravel())
    cols.append((pidx + np.tile(np.arange(d), d)[None, :]).ravel())
    vals.append(-host(Lam).reshape(n, -1).ravel())
    N = n * B
    return sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(N, N),
    ).tocsr()


def min_eig_lanczos(
    X: torch.Tensor,
    Lam: torch.Tensor,
    e: EdgeSet,
    num_eigs: int = 1,
    tol: float = 1e-6,
    maxiter: Optional[int] = None,
    sigma_boost: float = 1.0,
    host_sparse: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Smallest eigenpairs of S by shifted Lanczos: σ ≳ λ_max(S) from a
    ``which='LA'`` solve, then λ_max(σI − S) = σ − λ_min(S) (ARPACK's
    ``'SA'`` stalls on the exact null space S Xᵀ = 0 of a critical point).
    ``sigma_boost`` > 1 picks a larger, independent shift (the margin
    guard's second opinion). Returns (eigenvalues ascending (k,),
    eigenvectors (N, k)), N = n·(d+1) pose-major."""
    import scipy.sparse.linalg as sla

    n, _, dp1 = X.shape
    N = n * dp1
    dtype = np.float64 if X.dtype == torch.float64 else np.float32
    if host_sparse:
        S_host = s_sparse(X, Lam, e).astype(dtype)

        def s_apply(v):
            return S_host @ v.astype(dtype)
    else:
        def s_apply(v):
            V = torch.as_tensor(np.asarray(v, dtype), device=X.device).reshape(n, 1, dp1)
            return s_matvec(V.to(X.dtype), X, Lam, e).reshape(N).cpu().numpy().astype(dtype)

    def top_eig(matvec):
        op = sla.LinearOperator((N, N), matvec=matvec, dtype=dtype)
        try:
            vals, vecs = sla.eigsh(op, k=num_eigs, which="LA", tol=tol, maxiter=maxiter)
        except sla.ArpackNoConvergence as exc:  # pragma: no cover - rare
            if not len(exc.eigenvalues):
                raise
            vals, vecs = exc.eigenvalues, exc.eigenvectors
        return vals, vecs

    vals, _ = top_eig(s_apply)
    sigma = (abs(float(vals[-1])) * 1.01 + 1e-8) * float(sigma_boost)
    vals_sh, vecs = top_eig(lambda v: sigma * v - s_apply(v))
    return sigma - vals_sh[::-1], np.ascontiguousarray(vecs[:, ::-1])


def certify(
    X: torch.Tensor,
    e: EdgeSet,
    eig_tol: float = 1e-5,
    crit_tol: float = 1e-5,
    lanczos_tol: float = 1e-6,
    maxiter: Optional[int] = None,
) -> CertificateResult:
    """Certify a candidate lifted solution as globally optimal.
    ``eig_tol`` and ``crit_tol`` are relative to :func:`_q_scale`: S ⪰ 0 is
    accepted at min_eig ≥ −eig_tol·scale. A point that is not critical to
    ``crit_tol`` fails fast, without an eigensolve."""
    n = X.shape[0]
    Lam = lambda_blocks(X, e)
    scale = _q_scale(e, n)
    cres = crit_residual(X, Lam, e)
    if cres > crit_tol:
        return CertificateResult(False, float("nan"), cres, None, scale)
    vals, vecs = min_eig_lanczos(X, Lam, e, tol=lanczos_tol, maxiter=maxiter)
    min_eig = float(vals[0])
    is_global = min_eig >= -eig_tol * scale
    min_eig2, verified = None, True
    if abs(min_eig + eig_tol * scale) < MARGIN_GUARD_BAND * scale:
        vals2, _ = min_eig_lanczos(X, Lam, e, tol=lanczos_tol * 0.1,
                                   maxiter=maxiter, sigma_boost=3.0)
        min_eig2 = float(vals2[0])
        verified = (min_eig2 >= -eig_tol * scale) == is_global
    return CertificateResult(is_global, min_eig, cres, vecs[:, 0].reshape(n, X.shape[-1]),
                             scale, min_eig2, verified)


def escape_direction(
    X: torch.Tensor, result: CertificateResult
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Staircase rank ascent from a failed certificate: (X⁺, direction),
    X⁺ = X with a zero row appended (rank r+1) and the direction the
    eigenvector as that row — ⟨v, S v⟩ = min_eig < 0 makes it a strict
    second-order descent direction at X⁺. The caller takes a small step
    along it and re-solves at the new rank."""
    if result.eigvec is None:
        raise ValueError("certificate has no eigenvector (criticality failed)")
    n, r, dp1 = X.shape
    zeros = torch.zeros((n, 1, dp1), dtype=X.dtype, device=X.device)
    v = torch.as_tensor(result.eigvec, dtype=X.dtype, device=X.device)[:, None, :]
    return (torch.cat([X, zeros], dim=1),
            torch.cat([torch.zeros_like(X), v], dim=1))
