"""ASAPP tick throughput on the card: the K3 tick against its plain version.

Port of ``scripts/bench_asapp.py``. Run from the repository root on a
machine with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.bench_asapp [--out PATH]

Configuration: the asapp_demo scale (``launch/asapp_demo.launch``): the
sphere2500 world (its file where it exists, else its stand-in of
``roofline.STAND_INS``), 5 robots, RGD stepsize 0.2 with the
preconditioner, a 100 Hz local loop (one step per tick), staleness K = 3,
Odometry init, fp32. The runner is ``ASAPPEngine.make_fused_run`` (no
stop: every tick runs), each tick one K3 launch
(``fused_asapp.asapp_tick_fused``) or, for the plain row, the same runner
with K3's plain version (``asapp_tick_fused_ref``) in the wrapper's place.
The time per tick is the slope between two tick counts (``--ticks``,
default the JAX script's 200 and 1,200), each the least of three runs
from the same state after a warm one, so fixed costs cancel.

Prints progress on stderr and one JSON line on stdout: per route the time
per tick, ticks per second, the final cost after the longer run and K3's
launches, and the plain/K3 time ratio. Never writes the root
``baseline_results.json`` (the TPU's record).
"""

from __future__ import annotations

import argparse
import contextlib
import time
from unittest import mock

import torch

from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import fused_asapp, quadratic
from dpgo_ros_tpu_torch.parallel.asapp import ASAPPEngine
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu_torch.scripts import common, roofline
from dpgo_ros_tpu_torch.scripts.common import log
from dpgo_ros_tpu_torch.utils.config import AgentConfig, InitMethod

TICKS = (200, 1200)
REPS = 3


def plain_tick(X, hist, masks, Pinv, edges, delays, gamma, steps, use_precond,
               offsets=None, windows=None, live=None, rel=None):
    """K3's plain version in the wrapper's signature (a run without a stop:
    ``live`` and ``rel`` are None)."""
    if live is not None:
        raise ValueError("plain_tick: the device-side stop is the kernel's")
    return fused_asapp.asapp_tick_fused_ref(X, hist, masks, Pinv, edges, delays, gamma,
                                            steps, use_precond, offsets)


def config(dtype: str) -> AgentConfig:
    return AgentConfig(
        num_robots=5, asynchronous=True, RGD_stepsize=0.2,
        max_delayed_iterations=3, asynchronous_rate=100.0,
        local_initialization_method=InitMethod.ODOMETRY, dtype=dtype,
    )


def measure(use_kernel: bool, ticks=TICKS, world: str = "sphere2500", device="cuda",
            dtype=torch.float32, reps: int = REPS) -> dict:
    data, _, _, _ = roofline.load_world(world, num_robots=5)
    prob = LiftedProblem.from_data(data, r=5, dtype=dtype, device=device)
    cfg = config("float64" if dtype == torch.float64 else "float32")
    st0 = RBCDEngine(prob, cfg).initialize()
    eng = ASAPPEngine(prob, cfg)
    runner = eng.make_fused_run()
    swap = (contextlib.nullcontext() if use_kernel
            else mock.patch.object(fused_asapp, "asapp_tick_fused", plain_tick))

    def timed(n: int):
        out = runner(eng.init_state(st0.X), n)
        common.sync(device)
        ts = []
        for _ in range(reps):
            st = eng.init_state(st0.X)
            common.sync(device)
            t0 = time.perf_counter()
            out = runner(st, n)
            common.sync(device)
            ts.append(time.perf_counter() - t0)
        return min(ts), out

    n1, n2 = ticks
    before = common.counts()
    with swap:
        t1, _ = timed(n1)
        t2, out = timed(n2)
    launches = common.launched(before)
    per_tick = (t2 - t1) / (n2 - n1)
    return {
        "per_tick_sec": per_tick,
        "ticks_per_sec": 1.0 / per_tick,
        "times_sec": {str(n1): t1, str(n2): t2},
        "final_cost": float(quadratic.cost(out.X, prob.edges)),
        "final_cost_ticks": n2,
        "launches": launches,
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", default="sphere2500", choices=sorted(roofline.STAND_INS))
    p.add_argument("--ticks", default=TICKS,
                   type=lambda s: tuple(int(v) for v in s.split(",")),
                   help="the two tick counts of the slope (default 200,1200)")
    p.add_argument("--reps", type=int, default=REPS)
    common.add_args(p)
    a = common.parse(p, argv, "bench_asapp")
    if len(a.ticks) != 2 or not 0 < a.ticks[0] < a.ticks[1]:
        p.error("--ticks: two increasing positive counts")
    device, dtype = a.device, common.DTYPES[a.dtype]
    card = common.card(device)
    log(f"card {card}; {a.world}, ticks {a.ticks}, {a.dtype} on {device}")
    rows = {}
    for use_kernel in (False, True):
        name = "k3" if use_kernel else "plain"
        rows[name] = measure(use_kernel, a.ticks, a.world, device, dtype, a.reps)
        log(f"{name}: {rows[name]['per_tick_sec'] * 1e6:.1f} us/tick = "
            f"{rows[name]['ticks_per_sec']:.1f} ticks/s (cost {rows[name]['final_cost']:.1f}, "
            f"launches {rows[name]['launches']})")
    rows["plain_over_k3"] = rows["plain"]["per_tick_sec"] / rows["k3"]["per_tick_sec"]
    log(f"plain / K3 per tick: {rows['plain_over_k3']:.2f}x")
    out = {
        "config": "asapp_demo: RGD 0.2 + precond, K=3, 1 step/tick (100 Hz), "
                  f"{a.world}, 5 robots, {a.dtype}",
        **rows,
        "card": card,
        "device": str(device),
        "world": a.world,
        "ticks": list(a.ticks),
    }
    return common.emit(out, a.out)


if __name__ == "__main__":
    main()
