"""The engine loop (the CLI's ``--mode engine``): ``RBCDEngine.run``, one
K4 launch (``ops/hbm_rtr.py::rtr_solve_hbm``, ``csrc/rtr_window.cu``) per
block update of the RoundRobin and Uniform rules, then ``finalize``."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np

from benchmark import work as wk
from benchmark.blocks import graph_blocks

SOURCES = ("WINDOW_SOURCE",)  # fused_rtr's constants: the kernels set-up builds
RECORDS_SCHEDULE = True  # a request's ``sched``: the loop's rel changes and weight rounds
# the kernel wrapper a step calls: its first argument and first output are X
STEP = "dpgo_ros_tpu_torch.ops.hbm_rtr:rtr_solve_hbm"


def solve(eng, st, spans):
    """(state, updates, cost, tCG, schedule): the engine's own record of
    the relative changes it read after each update and of the updates its
    weight rounds came before."""
    with spans("run"):
        st, info = eng.run(st)
    h = info["history"]
    sched = dict(rels=h["rel_change_robots"],
                 rounds_at=[it for it, ev in h["event"] if ev == "UPDATE_WEIGHT"])
    return st, info["iterations"], info["final_cost"], info["tcg_iterations"], sched


def finalize(eng, st):
    """(T on the host, the final state with its settled weights)."""
    return eng.finalize(st)


@contextlib.contextmanager
def captured(calls: List):
    """Records each K4 solve's (robot, stats) while the body runs: the
    kernel's own counters of TR and tCG iterations, read after the traced
    stretch."""
    from dpgo_ros_tpu_torch.ops import hbm_rtr

    k4 = hbm_rtr.rtr_solve_hbm

    def wrapped(X, robot, *a, **kw):
        out = k4(X, robot, *a, **kw)
        calls.append((int(robot), out[1]))
        return out

    hbm_rtr.rtr_solve_hbm = wrapped
    try:
        yield
    finally:
        hbm_rtr.rtr_solve_hbm = k4


def work(g: Dict, r: int, calls: List) -> Tuple[Dict, Dict]:
    """(work, launches): the least seconds the recorded K4 solves need at
    the published peaks, from the robot's block and the kernel's TR and tCG
    counters, with their tCG iterations; and the launches."""
    gb = graph_blocks(g)
    out = {"k4": 0.0, "k4_tcg": 0}
    for robot, stats in calls:
        s = stats.detach().cpu().numpy().astype(np.float64)
        nk, Ek, ns = gb.blocks[robot]
        tri, tcg = int(s[4]), int(s[5])
        t, _ = wk.least_seconds(wk.solve_bytes(nk, Ek, ns, r, gb.d, stats=7),
                                wk.rtr_flops(nk, Ek, r, gb.d, tri, tcg))
        out["k4"] += t
        out["k4_tcg"] += tcg
    return out, {"k4": len(calls)}
