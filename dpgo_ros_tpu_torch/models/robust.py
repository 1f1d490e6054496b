"""Robust costs and the GNC-TLS weight rounds, on torch tensors.

Port of ``dpgo_ros_tpu/models/robust.py``: DPGO's ``RobustCost`` family
(L2, L1, Huber, TLS, GM, GNC_TLS) and the wrapper's weight-update round
(reference ``src/PGOAgentROS.cpp:1211-1233``).

Residual convention: per-edge whitened residual
    r_e = sqrt( κ_e ‖R_j − R_i R_e‖_F² + τ_e ‖t_j − t_i − R_i t_e‖² )
on the current rounded SE(d) trajectory, compared with the GNC threshold
``barc``. ``jnp.nanpercentile(r, 90)`` becomes ``torch.nanquantile(r, 0.9)``
(both interpolate linearly); an all-NaN input falls back through
``nan_to_num`` as in the JAX code.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from dpgo_ros_tpu_torch.ops.quadratic import EdgeSet


def measurement_residuals(T: torch.Tensor, e: EdgeSet) -> torch.Tensor:
    """Whitened residual r_e per edge on an SE(d) trajectory T (n, d, d+1)."""
    d = T.shape[1]
    Ti, Tj = T[e.src], T[e.dst]
    Ri, ti = Ti[:, :, :d], Ti[:, :, d]
    Rj, tj = Tj[:, :, :d], Tj[:, :, d]
    dR = Rj - Ri @ e.R
    dt = tj - ti - (Ri @ e.t[..., None])[..., 0]
    sq = e.kappa * torch.sum(dR * dR, dim=(-2, -1)) + e.tau * torch.sum(
        dt * dt, dim=-1
    )
    return torch.sqrt(torch.clamp(sq, min=0.0))


def gnc_tls_weights(residuals: torch.Tensor, mu, barc) -> torch.Tensor:
    """GNC-TLS weights (Yang et al., RA-L 2020):
    0 if r² ≥ ((μ+1)/μ) c̄², 1 if r² ≤ (μ/(μ+1)) c̄², else (c̄/r)√(μ(μ+1)) − μ."""
    r2 = residuals * residuals
    c2 = barc * barc
    hi = (mu + 1.0) / mu * c2
    lo = mu / (mu + 1.0) * c2
    mid = barc / torch.clamp(residuals, min=1e-12) * (mu * (mu + 1.0)) ** 0.5 - mu
    one, zero = torch.ones_like(r2), torch.zeros_like(r2)
    w = torch.where(r2 >= hi, zero, torch.where(r2 <= lo, one, mid))
    return torch.clamp(w, 0.0, 1.0)


def robust_weight(rtype: str, residuals: torch.Tensor, barc: float) -> torch.Tensor:
    """IRLS weights of the non-GNC robust costs (DPGO
    ``mRobustCost.weight(residual)``)."""
    r = torch.clamp(torch.abs(residuals), min=1e-12)
    if rtype == "L2":
        return torch.ones_like(r)
    if rtype == "L1":
        return 1.0 / r
    if rtype == "Huber":
        return torch.where(r <= barc, torch.ones_like(r), barc / r)
    if rtype == "TLS":
        return (r <= barc).to(r.dtype)
    if rtype == "GM":  # Geman-McClure
        return (barc**2 / (barc**2 + r * r)) ** 2
    raise ValueError(f"unknown robust cost {rtype}")


def _loop_p90(residuals, loop_mask, fallback: float) -> torch.Tensor:
    """90th percentile of the loop-closure residuals, ≥ ``fallback``
    (which also stands in when no loop closure is selected)."""
    r = torch.where(
        loop_mask > 0, residuals, torch.full_like(residuals, float("nan"))
    )
    p90 = torch.nan_to_num(torch.nanquantile(r, 0.9), nan=fallback)
    return torch.clamp(p90, min=fallback)


def mu_for_round(
    weight_update_count: int, cfg, mu_state, dtype=torch.float64,
    residuals=None, loop_mask=None,
) -> torch.Tensor:
    """μ for the current GNC round under ``cfg.GNC_schedule``:
    "reference" the running μ state, "geometric" GNC_mu_start → GNC_mu_end
    across rounds, "adaptive" μ = c̄²/(cutoff² − c̄²) with the cutoff
    annealed geometrically from the loop residuals' P90 to 1.05·c̄."""
    schedule = getattr(cfg, "GNC_schedule", "reference")
    if schedule == "reference":
        return torch.as_tensor(mu_state, dtype=dtype)
    K = max(int(cfg.robust_opt_num_weight_updates), 1)
    k = torch.tensor(float(weight_update_count), dtype=dtype)
    if schedule == "geometric":
        frac = k / max(K - 1, 1)
        lo, hi = math.log(cfg.GNC_mu_start), math.log(cfg.GNC_mu_end)
        return torch.exp(lo + frac * (hi - lo))
    barc = cfg.GNC_barc
    floor = 1.05 * barc
    p90 = _loop_p90(residuals, loop_mask, floor)
    alpha = (k + 1.0) / K
    cutoff = torch.exp((1.0 - alpha) * torch.log(p90) + alpha * math.log(floor))
    cutoff = torch.clamp(cutoff, min=floor)
    return (barc * barc) / (cutoff * cutoff - barc * barc)


def gnc_round_params(
    weight_update_count: int, cfg, mu_state, residuals, loop_mask,
    dtype=torch.float64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(μ, barc) for this GNC round. "adaptive" anneals the threshold
    barc_k geometrically from the loop residuals' P90 to the configured
    barc across the K rounds at μ = 3; the other schedules anneal μ
    against the fixed barc (:func:`mu_for_round`)."""
    schedule = getattr(cfg, "GNC_schedule", "reference")
    if schedule != "adaptive":
        mu = mu_for_round(
            weight_update_count, cfg, mu_state, dtype=dtype,
            residuals=residuals, loop_mask=loop_mask,
        )
        return mu, torch.tensor(cfg.GNC_barc, dtype=dtype)
    K = max(int(cfg.robust_opt_num_weight_updates), 1)
    k = torch.tensor(float(weight_update_count), dtype=dtype)
    barc = cfg.GNC_barc
    p90 = _loop_p90(residuals, loop_mask, barc)
    alpha = (k + 1.0) / K
    barc_k = torch.exp((1.0 - alpha) * torch.log(p90) + alpha * math.log(barc))
    return torch.tensor(3.0, dtype=dtype), torch.clamp(barc_k, min=barc)


def update_weights_gnc(
    weights: torch.Tensor, fixed_mask: torch.Tensor, residuals: torch.Tensor,
    mu, barc, mu_step: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One GNC weight update; frozen edges (fixed_mask > 0) keep their
    weight. Returns (weights, next μ)."""
    w_new = gnc_tls_weights(residuals, mu, barc)
    return torch.where(fixed_mask > 0, weights, w_new), mu * mu_step


def classify_weights(
    weights: torch.Tensor, is_loop: torch.Tensor, mask: torch.Tensor
) -> Tuple[int, int, int]:
    """(accepted, rejected, undecided) loop-closure counts."""
    sel = (is_loop > 0) & (mask > 0)
    acc = int(torch.sum(sel & (weights >= 1.0 - 1e-6)))
    rej = int(torch.sum(sel & (weights <= 1e-6)))
    return acc, rej, int(torch.sum(sel)) - acc - rej
