"""Numpy mirrors of the small SE(d)/rounding ops used on the fleet's
host-side protocol paths.

Copy of ``dpgo_ros_tpu/utils/hostmath.py`` for the PyTorch port (numpy
only). The fleet's agents (``parallel/agent_node.py``) run their
per-message and per-tick math here, on arrays of at most a few thousand
poses, so that no message handler launches device work; the solver paths
keep the torch versions (``ops/lie.py``, ``ops/rounding.py``). The
reference wrapper makes the same split: Eigen math on the node's callback
thread (``src/utils.cpp``).
"""

from __future__ import annotations

import numpy as np


def project_to_so_np(M: np.ndarray) -> np.ndarray:
    """Nearest-rotation projection of (..., d, d) via Procrustes SVD."""
    U, _, Vt = np.linalg.svd(M)
    det = np.linalg.det(U @ Vt)
    d = M.shape[-1]
    S = np.concatenate(
        [np.ones(M.shape[:-2] + (d - 1,), M.dtype), det[..., None]],
        axis=-1,
    )
    return (U * S[..., None, :]) @ Vt


def se_compose_np(Ta: np.ndarray, Tb: np.ndarray) -> np.ndarray:
    """(..., d, d+1) rigid-transform composition (Ra Rb, ta + Ra tb)."""
    d = Ta.shape[-2]
    Ra, ta = Ta[..., :d], Ta[..., d]
    Rb, tb = Tb[..., :d], Tb[..., d]
    R = Ra @ Rb
    t = ta + np.einsum("...ij,...j->...i", Ra, tb)
    return np.concatenate([R, t[..., None]], axis=-1)


def se_inverse_np(T: np.ndarray) -> np.ndarray:
    d = T.shape[-2]
    R, t = T[..., :d], T[..., d]
    Rt = np.swapaxes(R, -1, -2)
    ti = -np.einsum("...ij,...j->...i", Rt, t)
    return np.concatenate([Rt, ti[..., None]], axis=-1)


def odometry_chain_np(
    rel: np.ndarray, T0: np.ndarray | None = None
) -> np.ndarray:
    """Sequential odometry integration of (n-1, d, d+1) relative
    transforms → (n, d, d+1) absolute poses (``lie.odometry_chain`` is
    the device version)."""
    d = rel.shape[-2]
    n = rel.shape[0] + 1
    out = np.zeros((n, d, d + 1), rel.dtype)
    if T0 is None:
        out[0, :, :d] = np.eye(d, dtype=rel.dtype)
    else:
        out[0] = T0
    R = out[0, :, :d].copy()
    t = out[0, :, d].copy()
    for k in range(n - 1):
        Rk, tk = rel[k, :, :d], rel[k, :, d]
        t = t + R @ tk
        R = R @ Rk
        out[k + 1, :, :d] = R
        out[k + 1, :, d] = t
    return out


def lift_trajectory_np(T: np.ndarray, Ylift: np.ndarray) -> np.ndarray:
    """(n, d, d+1) → (n, r, d+1) via X_i = YLift T_i."""
    return np.einsum("rd,ndk->nrk", Ylift, T)


def round_via_lifting_np(X: np.ndarray, Ylift: np.ndarray) -> np.ndarray:
    """Per-pose world-frame recovery R_i = proj_SO(YLiftᵀ Y_i),
    t_i = YLiftᵀ p_i (``rounding.round_via_lifting``)."""
    d = X.shape[-1] - 1
    Z = np.einsum("rd,nrk->ndk", Ylift, X)
    R = project_to_so_np(Z[:, :, :d])
    return np.concatenate([R, Z[:, :, d:]], axis=-1)


def anchor_to_first_pose_np(
    T: np.ndarray, anchor: np.ndarray | None = None
) -> np.ndarray:
    T0inv = se_inverse_np(T[0])
    rel = se_compose_np(T0inv[None], T)
    if anchor is not None:
        rel = se_compose_np(anchor[None], rel)
    return rel


def measurement_residuals_np(
    T: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    R: np.ndarray,
    t: np.ndarray,
    kappa: np.ndarray,
    tau: np.ndarray,
) -> np.ndarray:
    """Whitened per-edge residuals on an SE(d) trajectory
    (``robust.measurement_residuals``)."""
    d = T.shape[1]
    Ti, Tj = T[src], T[dst]
    Ri, ti = Ti[:, :, :d], Ti[:, :, d]
    Rj, tj = Tj[:, :, :d], Tj[:, :, d]
    dR = Rj - np.einsum("eab,ebc->eac", Ri, R)
    dt = tj - ti - np.einsum("eab,eb->ea", Ri, t)
    sq = kappa * np.sum(dR * dR, axis=(-2, -1)) + tau * np.sum(
        dt * dt, axis=-1
    )
    return np.sqrt(np.maximum(sq, 0.0))


def gnc_tls_weights_np(
    residuals: np.ndarray, mu: float, barc: float
) -> np.ndarray:
    """GNC-TLS weights (``robust.gnc_tls_weights``)."""
    r2 = residuals * residuals
    c2 = barc * barc
    hi = (mu + 1.0) / mu * c2
    lo = mu / (mu + 1.0) * c2
    mid = barc / np.maximum(residuals, 1e-12) * np.sqrt(
        mu * (mu + 1.0)
    ) - mu
    w = np.where(r2 >= hi, 0.0, np.where(r2 <= lo, 1.0, mid))
    return np.clip(w, 0.0, 1.0)


def gnc_round_params_np(
    weight_update_count: int,
    cfg,
    mu_state: float,
    residuals: np.ndarray,
    loop_mask: np.ndarray,
):
    """(mu, barc) for a GNC round — numpy mirror of
    ``robust.gnc_round_params`` (all three schedules)."""
    schedule = getattr(cfg, "GNC_schedule", "reference")
    K = max(int(cfg.robust_opt_num_weight_updates), 1)
    k = float(weight_update_count)
    barc = float(cfg.GNC_barc)
    if schedule == "adaptive":
        r = np.where(loop_mask > 0, residuals, np.nan)
        p90 = np.nan_to_num(np.nanpercentile(r, 90.0), nan=barc)
        p90 = max(float(p90), barc)
        alpha = (k + 1.0) / K
        barc_k = float(
            np.exp((1.0 - alpha) * np.log(p90) + alpha * np.log(barc))
        )
        return 3.0, max(barc_k, barc)
    if schedule == "geometric":
        frac = k / max(K - 1, 1)
        mu = float(
            np.exp(
                np.log(cfg.GNC_mu_start)
                + frac * (np.log(cfg.GNC_mu_end) - np.log(cfg.GNC_mu_start))
            )
        )
        return mu, barc
    if schedule == "reference":
        return float(mu_state), barc
    # adaptive mu (mu_for_round's "adaptive" with fixed barc)
    floor = 1.05 * barc
    r = np.where(loop_mask > 0, residuals, np.nan)
    p90 = max(float(np.nan_to_num(np.nanpercentile(r, 90.0), nan=floor)), floor)
    alpha = (k + 1.0) / K
    cutoff = max(
        float(np.exp((1.0 - alpha) * np.log(p90) + alpha * np.log(floor))),
        floor,
    )
    return (barc * barc) / (cutoff * cutoff - barc * barc), barc
