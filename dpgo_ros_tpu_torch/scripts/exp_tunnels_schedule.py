"""The tunnels GNC cross-schedule sweep on the card: RoundRobin against
Uniform under each weight-round configuration.

Port of ``scripts/exp_tunnels_schedule.py``. Run from the repository root
on a machine with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.exp_tunnels_schedule [config ...] [--out PATH]

For each named configuration of :data:`CONFIGS` (the JAX script's eight,
verbatim; default all) the 8-robot GNC-TLS problem (``--world``, default
the tunnels stand-in: a 2,500-pose sphere with 245 planted outlier loop
closures) is solved under RoundRobin and under Uniform through
``RBCDEngine.run`` (Odometry init, barc 3, no resets, the configuration's
weight rounds, inner budget, reject-freeze threshold, μ step, inner
tolerance and relative-change tolerance). Recorded per configuration, as
the JAX script does: the accept/reject agreement over the loop closures
(weight ≥ 0.5 accepts), the flipped edges, the ATE between the two
trajectories over the span, the flipped edges' residual over barc (each
edge's mean over both rounded solutions), each run's iterations, cost,
convergence and wall; with ``refit``, both schedules refitted (L2, rel tol
0.02, ≤ 2,000 updates) from their own trajectories on the common accept
set, and the ATE between the refits. Added here: each run's K4 launches,
and, on a stand-in, its recall of the planted outliers, its false
rejections and its ATE against the ground truth.

Default fp32 on the card: each engine update is one K4 launch on the
robot's window. ``--dtype float64`` runs the engine's plain route
(``use_fused_kernel=False``, JAX's numerics), on ``--device cpu`` only:
the engine has no fp64 route on the card. ``--outlier_ratio`` plants
outliers in a stand-in that has none (small worlds for tests). Prints
progress on stderr and one JSON line on stdout; never writes the root
``exp_tunnels_schedule.json`` (the TPU's record).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from dpgo_ros_tpu_torch.io.synthetic import generate_world
from dpgo_ros_tpu_torch.models import robust
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import rounding
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu_torch.scripts import common, record_ate, roofline
from dpgo_ros_tpu_torch.scripts.common import log
from dpgo_ros_tpu_torch.utils.config import (
    AgentConfig,
    InitMethod,
    RobustCostType,
    UpdateRule,
)

BARC = 3.0
NUM_ROBOTS = 8

# the JAX script's configurations (its comments say what each one tests)
CONFIGS = {
    "baseline": dict(wu=3, inner=50, wct=-1.0, mu_step=1.4, tol=0.2),
    "freeze6": dict(wu=6, inner=50, wct=0.01, mu_step=1.4, tol=0.2),
    "rejfreeze": dict(wu=3, inner=50, wct=0.01, mu_step=1.4, tol=0.2),
    "tight": dict(wu=3, inner=50, wct=-1.0, mu_step=1.4, tol=0.05),
    "rejfreeze_tight": dict(
        wu=4, inner=50, wct=0.01, mu_step=1.4, tol=0.05
    ),
    "innertol": dict(
        wu=3, inner=50, wct=-1.0, mu_step=1.4, tol=0.1, inner_tol=0.3
    ),
    "innertol_tight": dict(
        wu=3, inner=100, wct=-1.0, mu_step=1.4, tol=0.1, inner_tol=0.15
    ),
    "final": dict(
        wu=3, inner=100, wct=-1.0, mu_step=1.4, tol=0.1, inner_tol=0.15,
        refit=True,
    ),
}
RULES = (("ROUND_ROBIN", UpdateRule.ROUND_ROBIN), ("UNIFORM", UpdateRule.UNIFORM))


def gnc_config(rule: UpdateRule, c: dict, dtype: str) -> AgentConfig:
    """The JAX script's GNC configuration of ``c``; fp64 on the plain route."""
    return AgentConfig(
        num_robots=NUM_ROBOTS,
        update_rule=rule,
        local_initialization_method=InitMethod.ODOMETRY,
        robust_cost_type=RobustCostType.GNC_TLS,
        GNC_use_probability=False,
        GNC_barc=BARC,
        GNC_mu_step=c["mu_step"],
        robust_opt_num_weight_updates=c["wu"],
        robust_opt_num_resets=0,
        robust_opt_inner_iters_per_robot=c["inner"],
        weight_convergence_threshold=c["wct"],
        robust_opt_inner_tol=c.get("inner_tol"),
        relative_change_tolerance=c.get("tol", 0.2),
        RTR_gradnorm_tol=0.5,
        dtype=dtype,
        use_fused_kernel=False if dtype == "float64" else None,
    )


def refit_config(rule: UpdateRule, dtype: str) -> AgentConfig:
    """The JAX script's common-accept-set refit: L2, rel tol 0.02."""
    return AgentConfig(
        num_robots=NUM_ROBOTS,
        update_rule=rule,
        relative_change_tolerance=0.02,
        max_iteration_number=2000,
        RTR_gradnorm_tol=0.5,
        dtype=dtype,
        use_fused_kernel=False if dtype == "float64" else None,
    )


def _problem(data, dtype: str, device) -> LiftedProblem:
    return LiftedProblem.from_data(data, r=5, dtype=common.DTYPES[dtype], device=device)


def run_engine(prob: LiftedProblem, cfg: AgentConfig, trajectory=None, ylift=None,
               schedule=None):
    """(rounded trajectory (n, d, d+1), final state, info with the wall and
    the kernels' launches) of one finalized engine run. ``ylift`` and
    ``schedule`` replace the engine's own draws (tests hand in JAX's)."""
    eng = RBCDEngine(prob, cfg)
    before = common.counts()
    t0 = time.time()
    st, info = eng.run(eng.initialize(trajectory=trajectory, ylift=ylift),
                       schedule=schedule)
    T, st = eng.finalize(st)
    common.sync(prob.device)
    info["wall"] = time.time() - t0
    info["launches"] = common.launched(before)
    return T, st, info


def decisions(prob: LiftedProblem, st):
    """(loop closures, accepted loop closures, each edge's residual at the
    rounded solution), numpy (E,)."""
    loop = record_ate.loop_closures(prob)
    acc = loop & (st.weights.cpu().numpy() >= 0.5)
    r = robust.measurement_residuals(rounding.round_solution(st.X), prob.edges)
    return loop, acc, r.double().cpu().numpy()


def agreement(acc_a, acc_b, loop) -> float:
    """The share of loop closures that both runs accept or both reject."""
    return float((acc_a[loop] == acc_b[loop]).mean())


def flipped(acc_a, acc_b, loop) -> np.ndarray:
    """(E,) bool: the loop closures that one run accepts and the other
    rejects."""
    return loop & (acc_a != acc_b)


def flip_band(r_a, r_b, flips, barc: float = BARC) -> list:
    """The flipped edges' residual over barc, each edge's mean over both
    solutions, rounded to 3 places, ascending, the first 50."""
    r_mean = 0.5 * (r_a + r_b)
    return sorted(np.round(r_mean[flips] / barc, 3).tolist())[:50]


def common_weights(acc_a, acc_b, loop) -> np.ndarray:
    """The common accept set as weights: loop closures accepted by both
    runs 1, the others 0; every other edge keeps weight 1."""
    w = (acc_a & acc_b).astype(np.float64)
    w[~loop] = 1.0
    return w


def refit(data, T, w_common, rule: UpdateRule, dtype: str, device, ylift=None,
          schedule=None):
    """One schedule's L2 refit on the common accept set from its own
    trajectory ``T``: (refitted trajectory, info)."""
    prob = _problem(data, dtype, device)
    prob = dataclasses.replace(prob, edges=dataclasses.replace(
        prob.edges, weight=torch.as_tensor(w_common, dtype=prob.dtype, device=prob.device)))
    T2, _, info = run_engine(prob, refit_config(rule, dtype), trajectory=T,
                             ylift=ylift, schedule=schedule)
    return T2, info


def config_entry(name: str, c: dict, data, gt=None, planted=None, *, device, dtype: str,
                 ylift=None, schedule=None) -> dict:
    """The sweep's record of configuration ``c`` on ``data`` (the JAX
    script's entry and this port's additions). ``ylift`` and ``schedule``
    (the Uniform robots by iteration) replace the engine's draws in every
    run."""
    log(f"=== {name} {c} ===")
    runs = {}
    for key, rule in RULES:
        prob = _problem(data, dtype, device)
        T, st, info = run_engine(prob, gnc_config(rule, c, dtype), ylift=ylift,
                                 schedule=schedule if rule == UpdateRule.UNIFORM else None)
        loop, acc, r = decisions(prob, st)
        runs[key] = dict(T=T, st=st, acc=acc, loop=loop, r=r, info=info)
        log(f"{name}/{key}: {info['iterations']} iters, cost {info['final_cost']:.1f}, "
            f"acc {int(acc.sum())}, {info['wall']:.1f}s, launches "
            f"{ {k: v for k, v in info['launches'].items() if v} }")
    a, b = runs["ROUND_ROBIN"], runs["UNIFORM"]
    loop = a["loop"]
    flips = flipped(a["acc"], b["acc"], loop)
    ate = record_ate.ate(a["T"], b["T"])
    span = record_ate.span(a["T"])
    entry = {
        "config": c,
        "agreement": agreement(a["acc"], b["acc"], loop),
        "num_flipped": int(flips.sum()),
        "ate_rmse": ate,
        "span": span,
        "ate_over_span": ate / span,
        "flip_resid_over_barc": flip_band(a["r"], b["r"], flips),
        "runs": {},
    }
    loops = np.asarray(data.measurements.edge_type) != 0
    for key, run in runs.items():
        info = run["info"]
        rec = {"iters": info["iterations"], "cost": info["final_cost"],
               "converged": info["converged"], "wall": info["wall"],
               "accepted": int(run["acc"].sum()), "launches": info["launches"]}
        if gt is not None:
            rec["ate_vs_ground_truth"] = record_ate.ate(run["T"], gt)
        if planted is not None and planted.any():
            rec["outliers"] = record_ate.outlier_record(
                run["st"].weights.cpu().numpy(), planted, loops)
        entry["runs"][key] = rec
    if c.get("refit"):
        w = common_weights(a["acc"], b["acc"], loop)
        refits = {}
        for key, rule in RULES:
            refits[key], info = refit(
                data, runs[key]["T"], w, rule, dtype, device, ylift=ylift,
                schedule=schedule if rule == UpdateRule.UNIFORM else None)
            entry["runs"][key]["refit"] = {"iters": info["iterations"],
                                           "cost": info["final_cost"],
                                           "launches": info["launches"]}
            log(f"{name}/refit/{key}: {info['iterations']} iters, cost "
                f"{info['final_cost']:.1f}")
        ate_refit = record_ate.ate(refits["ROUND_ROBIN"], refits["UNIFORM"])
        entry["common_set_refit_ate"] = ate_refit
        entry["common_set_refit_ate_over_span"] = ate_refit / span
        log(f"{name}: common-accept-set refit ATE {ate_refit:.3f} "
            f"({100 * ate_refit / span:.3f}% of span)")
    log(f"{name}: agreement {entry['agreement']:.4f} ({entry['num_flipped']} flips), "
        f"ATE {ate:.3f} ({100 * ate / span:.3f}% of span)")
    return entry


def load(world: str, outlier_ratio=None):
    """(data, ground truth, planted outliers, stand-in arguments) of the
    8-robot GNC world."""
    data, gt, planted, stand_in = roofline.load_world(world, num_robots=NUM_ROBOTS)
    if outlier_ratio is not None:
        if stand_in is None:
            raise SystemExit("--outlier_ratio plants outliers in a stand-in only")
        stand_in = dict(stand_in, outlier_ratio=outlier_ratio)
        data, gt, planted = generate_world(**stand_in)
    return data, gt, planted, stand_in


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("configs", nargs="*", help=f"of {', '.join(CONFIGS)} (default all)")
    p.add_argument("--world", default="tunnels", choices=sorted(roofline.STAND_INS))
    p.add_argument("--outlier_ratio", type=float,
                   help="plant this share of outlier loop closures in the stand-in")
    common.add_args(p)
    a = common.parse(p, argv, "exp_tunnels_schedule")
    unknown = [n for n in a.configs if n not in CONFIGS]
    if unknown:
        p.error(f"unknown configurations {unknown}")
    if a.dtype == "float64" and a.device == "cuda":
        p.error("--dtype float64 runs the engine's plain route, which runs on the CPU "
                "only (--device cpu); on the card every update is the fp32 K4 kernel")
    card = common.card(a.device)
    log(f"card {card}; {a.dtype} on {a.device}")
    data, gt, planted, stand_in = load(a.world, a.outlier_ratio)
    results = {name: config_entry(name, CONFIGS[name], data, gt, planted,
                                  device=a.device, dtype=a.dtype)
               for name in (a.configs or CONFIGS)}
    out = {"world": a.world, "stand_in": stand_in, "configs": results, "card": card,
           "device": a.device, "dtype": a.dtype}
    return common.emit(out, a.out)


if __name__ == "__main__":
    main()
