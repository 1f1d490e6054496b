"""ATE of the distributed solves against a tight centralized solve and
against the exact ground truth, and GNC schedule independence, on the card.

Port of ``scripts/record_ate.py``. Run from the repository root on a machine
with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.record_ate [--out PATH]

* ``--world`` (default the sphere2500 stand-in), the JAX script's two
  configurations through ``RBCDEngine.run`` (K4, one launch per update):
  the distributed demo (5 robots, RoundRobin, Chordal init, rel tol 0.2,
  gradnorm 0.5, ≤ 1,000 updates) against the tight centralized solve (one
  robot, rel tol 1e-3, gradnorm 1e-2, ≤ 300 updates); the translational
  RMSE after Umeyama alignment (``rounding.ate_translation``) over the
  trajectory's span. Where the world is a stand-in, also the ATE of both
  solves against the exact ground truth that ``generate_world`` returns.
* ``--gnc_world`` (default the tunnels stand-in: 8 robots, 245 planted
  outlier loop closures), GNC-TLS (3 weight rounds, no resets, 30 inner
  iterations per robot, Odometry init): RoundRobin against Uniform (a
  genuinely different schedule; tunnels' robot graph is complete, so
  Parallel would equal RoundRobin). The ATE between the two, their
  accept/reject agreement over the loop closures (weight ≥ 0.5 accepts),
  and, on a stand-in, each one's recall of the planted outliers, its
  false rejections and its ATE against the ground truth.
  ``--outlier_ratio`` plants outliers in a stand-in that has none (a small
  GNC world for tests).

Defaults: ``--device cuda``, fp32, so the kernels run; ``--device cpu
--dtype float64`` reproduces the JAX script's fp64 CPU numbers. Prints
progress on stderr and one JSON line on stdout; never writes the root
``ATE_r02.json`` (the TPU's record).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from dpgo_ros_tpu_torch.io.synthetic import generate_world
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import rounding
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu_torch.scripts import common, roofline
from dpgo_ros_tpu_torch.scripts.common import log
from dpgo_ros_tpu_torch.utils.config import (
    AgentConfig,
    InitMethod,
    RobustCostType,
    UpdateRule,
)


def solve(data, cfg: AgentConfig, label: str, device):
    """(rounded trajectory (n, d, d+1), final state, info with the kernels'
    launches, problem) of one engine run from its initialization,
    finalized."""
    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
    prob = LiftedProblem.from_data(data, r=5, dtype=dtype, device=device)
    eng = RBCDEngine(prob, cfg)
    before = common.counts()
    t0 = time.time()
    st, info = eng.run(eng.initialize())
    T, st = eng.finalize(st)
    info["launches"] = common.launched(before)
    log(f"{label}: {info['iterations']} iters cost {info['final_cost']:.3f} "
        f"conv={info['converged']} ({time.time() - t0:.1f}s)")
    return T, st, info, prob


def ate(T: np.ndarray, T_ref: np.ndarray) -> float:
    """Translational RMSE of ``T`` after Umeyama alignment to ``T_ref``
    (both (n, d, d+1)), in fp64."""
    return float(rounding.ate_translation(torch.as_tensor(T, dtype=torch.float64),
                                          torch.as_tensor(T_ref, dtype=torch.float64)))


def span(T: np.ndarray) -> float:
    """The largest extent of the trajectory's translations along an axis."""
    return float(np.ptp(T[:, :, T.shape[2] - 1], axis=0).max())


def loop_closures(prob: LiftedProblem) -> np.ndarray:
    """(E,) bool: the problem's live loop closures."""
    e = prob.edges
    return (e.is_loop.cpu().numpy() > 0) & (e.mask.cpu().numpy() > 0)


def agreement(w_a, w_b, loop: np.ndarray) -> float:
    """The share of loop closures that both weight vectors accept or both
    reject (weight ≥ 0.5 accepts)."""
    return float(((np.asarray(w_a)[loop] >= 0.5) == (np.asarray(w_b)[loop] >= 0.5)).mean())


def outlier_record(w, planted: np.ndarray, loops: np.ndarray) -> dict:
    """The JAX CLI's ``outlier_ground_truth`` and the recall: planted
    outliers rejected (weight < 0.5), inlier loop closures (``loops``: the
    measurements that are no odometry) rejected, planted ones missed; the
    first ``len(planted)`` edges are the generated measurements."""
    rej = np.asarray(w)[: len(planted)] < 0.5
    true = int((rej & planted).sum())
    return {"planted": int(planted.sum()), "rejected_true": true,
            "rejected_false": int((rej & loops & ~planted).sum()),
            "missed": int((~rej & planted).sum()),
            "recall": true / max(int(planted.sum()), 1)}


def tun_cfg(rule, inner: int, num_robots: int, dtype: str) -> AgentConfig:
    """The JAX script's GNC configuration."""
    return AgentConfig(
        num_robots=num_robots, update_rule=rule,
        local_initialization_method=InitMethod.ODOMETRY,
        robust_cost_type=RobustCostType.GNC_TLS, GNC_use_probability=False,
        GNC_barc=3.0, robust_opt_num_weight_updates=3,
        robust_opt_num_resets=0, robust_opt_inner_iters_per_robot=inner,
        relative_change_tolerance=0.2, RTR_gradnorm_tol=0.5, dtype=dtype,
    )


def distributed_cfg(dtype: str) -> AgentConfig:
    return AgentConfig(
        num_robots=5, update_rule=UpdateRule.ROUND_ROBIN,
        local_initialization_method=InitMethod.CHORDAL,
        relative_change_tolerance=0.2, RTR_gradnorm_tol=0.5,
        max_iteration_number=1000, dtype=dtype,
    )


def centralized_cfg(dtype: str) -> AgentConfig:
    return AgentConfig(
        num_robots=1, update_rule=UpdateRule.ROUND_ROBIN,
        local_initialization_method=InitMethod.CHORDAL,
        relative_change_tolerance=1e-3, RTR_gradnorm_tol=1e-2,
        max_iteration_number=300, dtype=dtype,
    )


def sphere_record(world: str, device, dtype: str) -> dict:
    data5, gt, _, stand_in = roofline.load_world(world, num_robots=5)
    T_dist, _, info_d, _ = solve(data5, distributed_cfg(dtype),
                                 f"{world} distributed demo", device)
    data1, _, _, _ = roofline.load_world(world, num_robots=1)
    T_cent, _, info_c, _ = solve(data1, centralized_cfg(dtype),
                                 f"{world} centralized tight", device)
    a, s = ate(T_dist, T_cent), span(T_cent)
    rec = {
        "ate_rmse": a,
        "trajectory_span": s,
        "ate_over_span": a / s,
        "distributed_iters": info_d["iterations"],
        "distributed_cost": info_d["final_cost"],
        "centralized_iters": info_c["iterations"],
        "centralized_cost": info_c["final_cost"],
        "distributed_launches": info_d["launches"],
        "centralized_launches": info_c["launches"],
        "stand_in": stand_in,
    }
    if gt is not None:
        rec["distributed_ate_vs_ground_truth"] = ate(T_dist, gt)
        rec["centralized_ate_vs_ground_truth"] = ate(T_cent, gt)
        rec["ground_truth_span"] = span(gt)
    log(f"{world} ATE {a:.4f} over span {s:.1f}"
        + (f"; vs ground truth: distributed {rec['distributed_ate_vs_ground_truth']:.4f}, "
           f"centralized {rec['centralized_ate_vs_ground_truth']:.4f}" if gt is not None
           else ""))
    return rec


def gnc_record(world: str, device, dtype: str, outlier_ratio=None) -> dict:
    data, gt, planted, stand_in = roofline.load_world(world, num_robots=8)
    if outlier_ratio is not None:
        if stand_in is None:
            raise SystemExit("--outlier_ratio plants outliers in a stand-in only")
        stand_in = dict(stand_in, outlier_ratio=outlier_ratio)
        data, gt, planted = generate_world(**stand_in)
    runs = {}
    for key, rule in (("round_robin", UpdateRule.ROUND_ROBIN),
                      ("uniform", UpdateRule.UNIFORM)):
        runs[key] = solve(data, tun_cfg(rule, 30, data.num_robots, dtype),
                          f"{world} {rule.value} GNC", device)
    (T_rr, st_rr, info_r, prob), (T_u, st_u, info_u, _) = runs.values()
    a, s = ate(T_rr, T_u), span(T_u)
    loop = loop_closures(prob)
    w_r, w_u = st_rr.weights.cpu().numpy(), st_u.weights.cpu().numpy()
    rec = {
        "ate_rmse": a,
        "trajectory_span": s,
        "ate_over_span": a / s,
        "accept_reject_agreement": agreement(w_r, w_u, loop),
        "stand_in": stand_in,
    }
    for key, (T, st, info, _) in runs.items():
        rec[key] = {"iters": info["iterations"], "cost": info["final_cost"],
                    "converged": info["converged"], "launches": info["launches"]}
        if gt is not None:
            rec[key]["ate_vs_ground_truth"] = ate(T, gt)
        if planted is not None and planted.any():
            rec[key]["outliers"] = outlier_record(
                st.weights.cpu().numpy(), planted,
                np.asarray(data.measurements.edge_type) != 0)
    log(f"{world} GNC ATE {a:.4f} over span {s:.1f}; decision agreement "
        f"{rec['accept_reject_agreement']:.4f}")
    return rec


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", default="sphere2500", choices=sorted(roofline.STAND_INS))
    p.add_argument("--gnc_world", default="tunnels", choices=sorted(roofline.STAND_INS))
    p.add_argument("--outlier_ratio", type=float,
                   help="plant this share of outlier loop closures in the GNC stand-in")
    common.add_args(p)
    a = common.parse(p, argv, "record_ate")
    card = common.card(a.device)
    log(f"card {card}; {a.dtype} on {a.device}")
    out = {
        f"{a.world}_5robot_vs_centralized": sphere_record(a.world, a.device, a.dtype),
        f"{a.gnc_world}_8robot_gnc_schedule_independence": gnc_record(
            a.gnc_world, a.device, a.dtype, a.outlier_ratio),
        "card": card, "device": a.device, "dtype": a.dtype,
    }
    return common.emit(out, a.out)


if __name__ == "__main__":
    main()
