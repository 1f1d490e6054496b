"""The fused runner (the CLI's ``--mode fused``): ``make_fused_run``, one
K2 launch (``ops/fused_rtr.py::rtr_run_fused``, ``csrc/rtr_run.cu``) per
stretch between GNC weight rounds, then ``finalize``."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np

from benchmark import work as wk
from benchmark.blocks import graph_blocks

SOURCES = ("RUN_SOURCE",)  # fused_rtr's constants: the kernels set-up builds
RECORDS_SCHEDULE = False  # the runner keeps no record of its rel changes
# the kernel wrapper a step calls: its first argument and first output are X
STEP = "dpgo_ros_tpu_torch.ops.fused_rtr:rtr_run_fused"


def solve(eng, st, spans):
    """(state, updates, cost, tCG, None)."""
    with spans("run"):
        run = eng.make_fused_run(eng.config.max_iteration_number, return_stats=True)
        st, tcg = run(st)
        cost = float(st.cost)
    return st, st.iteration, cost, tcg, None


def finalize(eng, st):
    """(T on the host, the final state with its settled weights)."""
    return eng.finalize(st)


@contextlib.contextmanager
def captured(calls: List):
    """Records each K2 launch's (it0, stats) while the body runs: the
    kernel's own counters of steps and tCG iterations, read after the
    traced stretch."""
    from dpgo_ros_tpu_torch.ops import fused_rtr

    k2 = fused_rtr.rtr_run_fused

    def wrapped(*a, **kw):
        out = k2(*a, **kw)
        calls.append((int(kw.get("it0", 0)), out[2]))
        return out

    fused_rtr.rtr_run_fused = wrapped
    try:
        yield
    finally:
        fused_rtr.rtr_run_fused = k2


def work(g: Dict, r: int, calls: List) -> Tuple[Dict, Dict]:
    """(work, launches): the least seconds the recorded K2 launches need at
    the published peaks (steps it0 .. it0 + steps − 1 on the robots in
    turn, their tCG iterations at the steps' mean; the TR work, which the
    kernel does not count, left out), with their tCG iterations; and the
    launches."""
    gb = graph_blocks(g)
    R = len(gb.blocks)
    out = {"k2": 0.0, "k2_tcg": 0}
    for it0, stats in calls:
        s = stats.detach().cpu().numpy().astype(np.float64)
        steps, tcg = int(s[2]), int(s[3])
        rob = [(it0 + j) % R for j in range(steps)]
        flops = sum(wk.rtr_flops(gb.blocks[k][0], gb.blocks[k][1], r, gb.d, 0, 0) for k in rob)
        if steps:
            flops += tcg * float(np.mean([wk.tcg_flops(gb.blocks[k][0], gb.blocks[k][1], r, gb.d)
                                          for k in rob]))
        C, D = r * (gb.d + 1), gb.d + 1
        nbytes = 4 * (2 * gb.n * C + gb.n * D * D + 4) + wk.edge_bytes(gb.edges, gb.d)
        t, _ = wk.least_seconds(nbytes, flops)
        out["k2"] += t
        out["k2_tcg"] += tcg
    return out, {"k2": len(calls)}
