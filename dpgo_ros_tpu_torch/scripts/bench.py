"""The headline harness on the card: block updates per second of the
dpgo_demo configuration's synchronous RBCD solve.

Port of the root ``bench.py``. Run from the repository root on a machine
with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.roofline --out /tmp/roof.json
    python -m dpgo_ros_tpu_torch.scripts.bench --roofline /tmp/roof.json

Configuration (``launch/dpgo_demo.launch``): the sphere2500 world (its file
where it exists, else the stand-in of ``roofline.STAND_INS``), 5 robots,
r = 5, fp32, Chordal init, RTR 3 outer × 50 tCG iterations, gradnorm tol
0.5, relative-change tolerance 0, so every solve runs exactly ``--iters``
scheduled block updates. Three routes:

* ``parallel``: the colored-Parallel rule through the fused runner
  (``RBCDEngine.make_fused_run``, one K2 launch per solve on the colour
  classes' windows): the headline;
* ``roundrobin``: RoundRobin through the fused runner (K2 on the robots'
  windows);
* ``engine_roundrobin``: RoundRobin through ``RBCDEngine.run`` (one K4
  launch per update), the CLI's default mode.

The JAX harness, step by step:

* one timed region holds ``--k_chain`` chained solves, each from a distinct
  input: the initial state rotated by an O(r) gauge rotation in the (0, 1)
  plane whose angle θ = prev_cost·1e-3 + i·0.7309 is computed on the
  device from the previous solve's cost tensor (a data dependency from
  solve to solve; cost and solver are gauge-invariant, so every solve does
  the same work on other bits); one synchronization ends the region;
* the region runs ``--regions`` times and the median counts, with the
  min/max spread beside it;
* every solve must have run all ``--iters`` updates, and the final costs
  must lie within 1e-2·|c| + 1e-3 of each other; a failed check exits
  nonzero;
* the tCG iterations come from the kernels' counters (the fused runner's
  total, the engine's sum); their median, min and max per solve;
* ``--roofline PATH`` (a JSON that ``scripts/roofline.py --out`` wrote, never
  the root ``ROOFLINE.json``, the TPU's record) gives the device floor:
  the tCG per solve times the least valid per-tCG slope of the world's row
  (``rows[world]["k1" | "k4"]["per_tcg_iter_measured_s"]``); a per-solve
  wall under 0.9 × the floor marks ``device_floor_ok`` false. Without the
  flag the floor is null.

The port's runners read the card from the host inside a solve (the fused
runner twice per K2 launch, the engine once per update), so JAX's "one sync
per region" does not hold here; ``host_reads_per_solve`` counts those
reads in one more solve after the timed regions (``common.host_reads``;
null on the CPU, where the kernels' plain versions read values of their own).

``vs_baseline``: the reference's demo sleeps 0.1 s between UPDATE commands
(``inter_update_sleep_time``), ≤ 10 block updates/s before its solver time.

Prints progress on stderr and one JSON line on stdout: JAX's keys for the
headline route, the card's name and power limit, and every route's figures
under ``routes``. ``--k_chain``, ``--regions``, ``--iters`` and ``--world``
cut the run short for tests; ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import kernels
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu_torch.scripts import common, roofline
from dpgo_ros_tpu_torch.scripts.common import log
from dpgo_ros_tpu_torch.utils.config import AgentConfig, InitMethod, UpdateRule

BASELINE_ITERS_PER_SEC = 10.0
NUM_ITERS = 100
K_CHAIN = 24  # distinct-input chained solves per timed region
REGIONS = 3  # timed-region repeats; the MEDIAN is recorded
# label: (update rule, runner); the first is the headline
ROUTES = {
    "parallel": (UpdateRule.PARALLEL, "fused"),
    "roundrobin": (UpdateRule.ROUND_ROBIN, "fused"),
    "engine_roundrobin": (UpdateRule.ROUND_ROBIN, "engine"),
}


def make_perturb(r: int, dtype=torch.float32, device="cuda"):
    """Gauge perturbation: rotate the lifted rank space by an O(r) rotation
    in the (0, 1) plane with angle θ(prev_cost, i), computed on the device
    (``prev_cost`` a 0-d tensor, ``i`` a number). Cost is invariant and the
    solver equivariant under left gauge rotations, so the perturbed solve
    does the same work on other input bits. ``perturb.angle(prev_cost, i)``
    and ``perturb.rotate(X, θ)`` are its two halves."""
    I = torch.eye(r, dtype=dtype, device=device)
    P01 = torch.zeros((r, r), dtype=dtype, device=device)
    P01[0, 0] = P01[1, 1] = 1.0
    R90 = torch.zeros((r, r), dtype=dtype, device=device)
    R90[1, 0], R90[0, 1] = 1.0, -1.0

    def angle(prev_cost, i):
        return prev_cost.to(dtype) * 1e-3 + torch.tensor(i, dtype=dtype, device=device) * 0.7309

    def rotate(X, theta):
        G = I + (torch.cos(theta) - 1.0) * P01 + torch.sin(theta) * R90
        return torch.einsum("sr,nrk->nsk", G, X).contiguous()

    def perturb(X, prev_cost, i):
        return rotate(X, angle(prev_cost, i))

    perturb.angle, perturb.rotate = angle, rotate
    return perturb


def setup(rule, data, iters: int = NUM_ITERS, device="cuda", dtype=torch.float32,
          runner: str = "fused"):
    """(engine, initial state, run(state) → (state, tCG iterations), perturb)
    of the dpgo_demo configuration on ``data`` (its robot count)."""
    prob = LiftedProblem.from_data(data, r=5, dtype=dtype, device=device)
    cfg = AgentConfig(
        num_robots=data.num_robots,
        update_rule=rule,
        # chordal init = the reference demo config (dpgo_demo.launch:9)
        local_initialization_method=InitMethod.CHORDAL,
        relative_change_tolerance=0.0,  # fixed-length run: exact work
        max_iteration_number=iters,
        RTR_iterations=3,
        RTR_tCG_iterations=50,
        RTR_gradnorm_tol=0.5,
        dtype="float64" if dtype == torch.float64 else "float32",
    )
    eng = RBCDEngine(prob, cfg)
    st0 = eng.initialize()
    if runner == "fused":
        run = eng.make_fused_run(iters, return_stats=True)
    else:
        def run(st):
            out, info = eng.run(st, max_iters=iters)
            return out, info["tcg_iterations"]
    return eng, st0, run, make_perturb(prob.r, dtype, prob.device)


def chained_region(run, perturb, st0, k_chain: int, device):
    """ONE timed region: k_chain solves, each from a distinct gauge-rotated
    init chained through the previous solve's cost. Returns wall seconds
    and (cost tensor, iterations, tCG) per solve."""
    st = st0
    finals = []
    common.sync(device)
    t0 = time.perf_counter()
    for i in range(k_chain):
        out, tcg = run(st)
        finals.append((out.cost, out.iteration, tcg))
        if i < k_chain - 1:
            st = st0._replace(X=perturb(st0.X, out.cost, i + 1.0))
    common.sync(device)
    return time.perf_counter() - t0, finals


def measure(run, perturb, st0, k_chain: int, regions: int, device):
    """Two warm solves (from st0 and from a perturbed st0), then
    ``regions`` timed regions; returns (times, finals per region)."""
    out_w, _ = run(st0)
    run(st0._replace(X=perturb(st0.X, out_w.cost, 0.5)))
    common.sync(device)
    times, finals_all = [], []
    for _ in range(regions):
        dt, finals = chained_region(run, perturb, st0, k_chain, device)
        times.append(dt)
        finals_all.append(finals)
    return times, finals_all


def finish(eng, st0, times, finals_all, rule, k_chain: int, iters: int = NUM_ITERS) -> dict:
    """The route's figures, after its checks: every solve ran ``iters``
    updates and the final costs agree within 1e-2·|c| + 1e-3 (raises
    otherwise)."""
    f_init = float(st0.cost)
    costs, steps, tcgs = [], [], []
    for finals in finals_all:
        for c, it, tg in finals:
            costs.append(float(c))
            steps.append(int(it))
            tcgs.append(int(tg))
    # fixed-work guarantee: every solve ran the full schedule
    if not all(s == iters for s in steps):
        raise RuntimeError(f"bench: solves ran {sorted(set(steps))} updates, not {iters}")
    # gauge equivariance: every distinct-input solve lands at the same cost
    cmax, cmin = max(costs), min(costs)
    if not cmax - cmin < 1e-2 * abs(cmax) + 1e-3:
        raise RuntimeError(f"bench: final costs spread over [{cmin!r}, {cmax!r}]")
    if rule == UpdateRule.PARALLEL:
        sizes = np.bincount(eng.robot_colors, minlength=eng.num_colors)
        updates = int(sum(sizes[s % eng.num_colors] for s in range(iters)))
    else:
        updates = iters
    dt_med = statistics.median(times)
    per_solve = dt_med / k_chain
    tcg_per_solve = statistics.median(tcgs)
    return {
        "f_init": f_init,
        "f_final": costs[-1],
        "f_final_min": cmin,
        "f_final_max": cmax,
        "updates_per_solve": updates,
        "per_solve_s": per_solve,
        "region_times_s": times,
        "spread": (max(times) - min(times)) / dt_med,
        "tcg_per_solve": tcg_per_solve,
        "tcg_per_solve_min": min(tcgs),
        "tcg_per_solve_max": max(tcgs),
        "updates_per_sec": updates / per_solve,
        "tcg_iters_per_sec": tcg_per_solve / per_solve,
    }


def device_floor_check(res: dict, roof, world: str):
    """(floor s or None, ok, the roofline row's kernel it came from): the
    route's tCG per solve times the least valid per-tCG slope that the
    roofline measured on ``world`` (K1 under the all-ones mask, K4 on robot
    0's window); ok unless the per-solve wall is under 0.9 × the floor."""
    row = (roof or {}).get("rows", {}).get(world, {})
    slopes = {k: row[k]["per_tcg_iter_measured_s"] for k in ("k1", "k4")
              if k in row and row[k].get("slope_valid")
              and row[k]["per_tcg_iter_measured_s"] > 0}
    if not slopes:
        return None, True, None
    k = min(slopes, key=slopes.get)
    floor = res["tcg_per_solve"] * slopes[k]
    return floor, res["per_solve_s"] >= 0.9 * floor, k


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", default="sphere2500", choices=sorted(roofline.STAND_INS),
                   help="a world of roofline.STAND_INS (its file where it exists)")
    p.add_argument("--k_chain", type=int, default=K_CHAIN)
    p.add_argument("--regions", type=int, default=REGIONS)
    p.add_argument("--iters", type=int, default=NUM_ITERS)
    p.add_argument("--roofline", help="the JSON that scripts/roofline.py --out wrote")
    common.add_args(p)
    a = common.parse(p, argv, "bench")
    if min(a.k_chain, a.regions, a.iters) < 1:
        p.error("--k_chain, --regions and --iters must be positive")
    if a.roofline and common.is_root_record(a.roofline):
        p.error("--roofline must be the port's roofline output, not a root record "
                "(the root ROOFLINE.json is the TPU's)")
    roof = json.loads(Path(a.roofline).read_text()) if a.roofline else None
    device, dtype = torch.device(a.device), common.DTYPES[a.dtype]
    card = common.card(device)
    log(f"card {card}; world {a.world}, {a.k_chain} chained solves x {a.regions} "
        f"regions of {a.iters} updates, {a.dtype} on {device}")
    if device.type == "cuda":
        kernels.build_all([kernels.RUN_SOURCE, kernels.WINDOW_SOURCE])
    data, _, _, stand_in = roofline.load_world(a.world)
    routes = {}
    for label, (rule, runner) in ROUTES.items():
        before = common.counts()
        eng, st0, run, perturb = setup(rule, data, a.iters, device, dtype, runner)
        times, finals_all = measure(run, perturb, st0, a.k_chain, a.regions, device)
        reads = (common.host_reads(lambda: run(st0), device) if device.type == "cuda"
                 else None)  # the plain versions read values of their own
        res = finish(eng, st0, times, finals_all, rule, a.k_chain, a.iters)
        floor, ok, src = device_floor_check(res, roof, a.world)
        res.update(
            host_reads_per_solve=reads, device_floor_s=floor, device_floor_ok=ok,
            device_floor_from=src, rule=rule.value, runner=runner,
            num_colors=eng.num_colors,
            # every solve of the route: 2 warm, the timed ones, the read count
            solves=2 + a.k_chain * a.regions + 1, launches=common.launched(before))
        routes[label] = res
        log(f"{label}: {res['updates_per_sec']:.1f} updates/s "
            f"({res['tcg_iters_per_sec']:.1f} tCG-iters/s, {res['per_solve_s'] * 1e3:.3f} "
            f"ms/solve, spread {res['spread'] * 100:.1f}%, tCG/solve {res['tcg_per_solve']} "
            f"[{res['tcg_per_solve_min']}, {res['tcg_per_solve_max']}], {reads} host "
            "reads/solve, device floor "
            + (f"{floor * 1e3:.3f} ms ({src}) ok={ok})" if floor is not None else "none)")
            + f" cost {res['f_init']:.1f} -> {res['f_final']:.1f}; launches "
            f"{res['launches']}")
    res_p, res_s, res_e = (routes[k] for k in ROUTES)
    out = {
        "metric": f"{a.world}_{data.num_robots}robot_rbcd_block_updates_per_sec",
        "value": round(res_p["updates_per_sec"], 2),
        "unit": "iters/s",
        "vs_baseline": round(res_p["updates_per_sec"] / BASELINE_ITERS_PER_SEC, 2),
        "tcg_iters_per_sec": round(res_p["tcg_iters_per_sec"], 2),
        "tcg_iters_per_solve": res_p["tcg_per_solve"],
        "per_solve_ms": round(res_p["per_solve_s"] * 1e3, 4),
        "region_spread": round(res_p["spread"], 4),
        "chained_solves_per_region": a.k_chain,
        "regions": a.regions,
        "device_floor_ms": (round(res_p["device_floor_s"] * 1e3, 4)
                            if res_p["device_floor_s"] is not None else None),
        "device_floor_ok": res_p["device_floor_ok"],
        "roundrobin_updates_per_sec": round(res_s["updates_per_sec"], 2),
        "roundrobin_tcg_iters_per_sec": round(res_s["tcg_iters_per_sec"], 2),
        "engine_roundrobin_updates_per_sec": round(res_e["updates_per_sec"], 2),
        "engine_roundrobin_tcg_iters_per_sec": round(res_e["tcg_iters_per_sec"], 2),
        "host_reads_per_solve": {k: r["host_reads_per_solve"] for k, r in routes.items()},
        "card": card,
        "world": a.world,
        "stand_in": stand_in,
        "device": str(device),
        "dtype": a.dtype,
        "iters": a.iters,
        "roofline": a.roofline,
        "routes": routes,
    }
    return common.emit(out, a.out)


if __name__ == "__main__":
    main()
