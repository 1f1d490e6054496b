"""Every BASELINE.json configuration end to end, on the card.

Port of ``scripts/run_baselines.py``. Run from the repository root on a
machine with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.run_baselines [section ...] [--out PATH]

Sections (numbers on the command line select them; none = all), each on
its world's file where it exists, else its stand-in of ``roofline.STAND_INS``:

  1. tinyGrid3D single-agent L2, Odometry init (the engine: K4);
  2. smallGrid3D and cubicle, 2-robot synchronous RBCD (K4);
  3. sphere2500 5-robot demo, plain and with Nesterov acceleration (K4);
  4. parking-garage and torus3D asynchronous ASAPP, the RGD stepsize sweep
     with the O(1/t) decay (K3, one launch per tick);
  5. tunnels 8-robot GNC-TLS: the reference demo's configuration
     (RoundRobin, 50 inner iterations, 3 resets) and the colored-Parallel
     one (30 inner, no resets), each through the fused runner (K2, one
     launch per stretch between weight rounds).

Each result carries the kernel launches it made. Prints progress on stderr
and one JSON line on stdout; ``--out`` also writes it (merged into the
file's sections if it exists). Never writes the root
``baseline_results.json`` (the TPU's record). ``--device cpu --dtype
float64`` runs the JAX script's fp64 CPU configuration on the plain
versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import quadratic
from dpgo_ros_tpu_torch.parallel.asapp import ASAPPEngine
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu_torch.scripts import common, roofline
from dpgo_ros_tpu_torch.scripts.common import log
from dpgo_ros_tpu_torch.utils.config import (
    AgentConfig,
    InitMethod,
    RobustCostType,
    UpdateRule,
)

SECTIONS = (1, 2, 3, 4, 5)
# section 4: world, stepsizes, tick cap, movement tolerance (the JAX
# script's: parking-garage's optimum is tiny, so its stop needs a tighter
# tolerance than torus3D's)
ASAPP_SWEEPS = (
    ("parking-garage", (0.05, 0.1, 0.2), 24000, 1e-4),
    ("torus3D", (0.1, 0.3, 0.5), 6000, 1e-3),
)


def configs(section: int) -> dict:
    """{result name: (world, robots, AgentConfig)} of an RBCD section (1, 2,
    3 or 5), the JAX script's configurations field by field (the dtype
    left at its default; :func:`main` sets it)."""
    if section == 1:
        return {"tinyGrid3D_1robot_L2": ("tinyGrid3D", 1, AgentConfig(
            num_robots=1,
            local_initialization_method=InitMethod.ODOMETRY,
            relative_change_tolerance=1e-2,
            max_iteration_number=50,
            RTR_gradnorm_tol=0.1,
        ))}
    if section == 2:
        return {f"{name}_2robot_sync": (name, 2, AgentConfig(
            num_robots=2,
            update_rule=UpdateRule.ROUND_ROBIN,
            local_initialization_method=InitMethod.ODOMETRY,
            relative_change_tolerance=tol,
            max_iteration_number=200,
            RTR_gradnorm_tol=0.5,
        )) for name, tol in (("smallGrid3D", 1e-2), ("cubicle", 0.5))}
    if section == 3:
        return {f"sphere2500_5robot{'_accel' if accel else ''}": ("sphere2500", 5, AgentConfig(
            num_robots=5,
            update_rule=UpdateRule.ROUND_ROBIN,
            local_initialization_method=InitMethod.CHORDAL,
            acceleration=accel,
            relative_change_tolerance=0.2,
            max_iteration_number=1000,
            RTR_gradnorm_tol=0.5,
        )) for accel in (False, True)}
    if section == 5:
        gnc = dict(num_robots=8, local_initialization_method=InitMethod.ODOMETRY,
                   robust_cost_type=RobustCostType.GNC_TLS, GNC_use_probability=False,
                   GNC_barc=3.0, robust_opt_num_weight_updates=3,
                   relative_change_tolerance=0.2, RTR_gradnorm_tol=0.5)
        return {
            "tunnels_8robot_gnc_reference_demo": ("tunnels", 8, AgentConfig(
                update_rule=UpdateRule.ROUND_ROBIN, robust_opt_num_resets=3,
                robust_opt_inner_iters_per_robot=50, **gnc)),
            "tunnels_8robot_gnc": ("tunnels", 8, AgentConfig(
                update_rule=UpdateRule.PARALLEL, robust_opt_num_resets=0,
                robust_opt_inner_iters_per_robot=30, **gnc)),
        }
    raise ValueError(f"section {section} has no RBCD configuration")


def asapp_config(stepsize=None) -> AgentConfig:
    """Section 4's configuration (``stepsize`` None: the initialization's)."""
    if stepsize is None:
        return AgentConfig(num_robots=5, asynchronous=True,
                           local_initialization_method=InitMethod.CHORDAL)
    return AgentConfig(
        num_robots=5,
        asynchronous=True,
        RGD_stepsize=stepsize,
        max_delayed_iterations=3,
        asapp_stepsize_decay_ticks=2000,
        local_initialization_method=InitMethod.CHORDAL,
    )


def solve(data, cfg: AgentConfig, device, fused: bool = False) -> dict:
    """One run from the engine's initialization: ``RBCDEngine.run``, or with
    ``fused`` its fused runner (``make_fused_run`` to the iteration cap);
    the JAX script's record plus the launches, stand-in and route."""
    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
    prob = LiftedProblem.from_data(data, r=cfg.relaxation_rank, dtype=dtype, device=device)
    eng = RBCDEngine(prob, cfg)
    before = common.counts()
    t0 = time.time()
    st = eng.initialize()
    f0 = float(st.cost)
    if fused:
        # the resolved config's cap (a robust cost sets the reference's)
        st = eng.make_fused_run(eng.config.max_iteration_number)(st)
        rel = st.rel_change.cpu().numpy()
        info = {"final_cost": float(st.cost), "iterations": st.iteration,
                "converged": bool(np.all(rel < eng.config.relative_change_tolerance))}
        if cfg.robust_cost_type != RobustCostType.L2:
            info.update(eng.gnc_info(st.weights))
    else:
        st, info = eng.run(st)
    eng.finalize(st)
    common.sync(device)
    out = {
        "init_cost": f0,
        "final_cost": info["final_cost"],
        "iterations": info["iterations"],
        "converged": info["converged"],
        "wall_sec": round(time.time() - t0, 1),
        "route": "fused" if fused else "engine",
        "launches": common.launched(before),
    }
    if "gnc_stats" in info:
        out["gnc_stats"] = info["gnc_stats"]
    return out


def asapp_sweep(name: str, sweep, ticks: int, tol: float, device, dtype) -> dict:
    """Section 4 on one world: the sweep's runs from one chordal state, the
    best (lowest final cost) with the whole sweep beside it."""
    data, _, _, stand_in = roofline.load_world(name, num_robots=5)
    cfg_dtype = "float64" if dtype == torch.float64 else "float32"
    prob = LiftedProblem.from_data(data, r=5, dtype=dtype, device=device)
    st0 = RBCDEngine(prob, _with_dtype(asapp_config(), cfg_dtype)).initialize()
    f_init = float(quadratic.cost(st0.X, prob.edges))
    best, sweep_log = None, []
    for stepsize in sweep:
        eng = ASAPPEngine(prob, _with_dtype(asapp_config(stepsize), cfg_dtype))
        before = common.counts()
        t0 = time.time()
        st, info = eng.run(st0.X, num_ticks=ticks, chunk=2000, tol=tol)
        f = float(quadratic.cost(st.X, prob.edges))
        sweep_log.append({"stepsize": stepsize, "final_cost": f, "ticks": info["ticks"],
                          "wall_sec": round(time.time() - t0, 1),
                          "launches": common.launched(before)})
        log(f"{name} asapp stepsize={stepsize}: {f:.4e} ({time.time() - t0:.1f}s, "
            f"ticks={info['ticks']})")
        if best is None or f < best["final_cost"]:
            best = {"stepsize": stepsize, "init_cost": f_init, "final_cost": f,
                    "ticks": info["ticks"]}
    best["sweep"] = sweep_log
    best["stand_in"] = stand_in
    return best


def _with_dtype(cfg: AgentConfig, dtype: str) -> AgentConfig:
    return dataclasses.replace(cfg, dtype=dtype)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("sections", nargs="*", type=int, choices=SECTIONS,
                   help="section numbers to run (none = all)")
    common.add_args(p)
    a = common.parse(p, argv, "run_baselines")
    only = set(a.sections) or set(SECTIONS)
    device, dtype = a.device, common.DTYPES[a.dtype]
    card = common.card(device)
    log(f"card {card}; sections {sorted(only)}, {a.dtype} on {device}")
    results = {}
    for section in sorted(only):
        if section == 4:
            for name, sweep, ticks, tol in ASAPP_SWEEPS:
                results[f"{name}_5robot_asapp"] = asapp_sweep(name, sweep, ticks, tol,
                                                               device, dtype)
                log(f"{name}_5robot_asapp best: {results[f'{name}_5robot_asapp']}")
            continue
        for tag, (world, robots, cfg) in configs(section).items():
            data, _, _, stand_in = roofline.load_world(world, num_robots=robots)
            res = solve(data, _with_dtype(cfg, a.dtype), device, fused=section == 5)
            res["stand_in"] = stand_in
            results[tag] = res
            log(f"{tag}: {res}")
    for res in results.values():
        res["card"] = card
    if a.out and Path(a.out).exists():
        # merge: a partial run never drops the sections that did not run
        merged = json.loads(Path(a.out).read_text())
        merged.update(results)
        results = merged
    return common.emit(results, a.out)


if __name__ == "__main__":
    main()
