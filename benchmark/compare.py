"""The comparison that decides ``correct``, against the configuration's
plain reference: the module ``harness.reference_of`` resolves
(``references/<name>.py``), handed in. A number is read only where the
module has the hook that gives it (``references/rbcd.py`` lists them).

For every request of the window whose graph the reference solved whole (a
sample of the graphs, drawn from the seed; L2 configurations):

* ``traj``: the largest entry of |T − T_ref| over the rounded, anchored
  trajectory (rotations and translations, in the graph's units);
* ``cost``: |f − f_ref| / f_ref, the final cost the program reported
  against the reference's;
* ``updates``: |block updates − the reference's|, a reading only: the
  control matches the program's count on some graphs, so no limit can
  separate them.

For a sample of the window's final states, drawn from the seed, the two
layers under the answer, read from the program's own state X:

* ``state_cost``: |f − f(X)| / f(X), the reported cost against the cost of
  X under the final weights, evaluated in float64;
* ``rounding``: the largest entry of |T − round(X)|, the rounding and
  anchoring of X redone in float64;

and for a robust configuration, whose whole path the reference cannot
reproduce, the stage-by-stage numbers of ``follow`` (``init``,
``round_weights``, ``stretch``, ``stretch_cost``) on the first of them, and
on each of them:

* ``settle``: the final loop-closure weights that differ from the last
  weight round's, settled by the reference's rule on the request's own
  trajectory (``settle_gaps``).

For every request of the window whose runner records its schedule:

* ``schedule``: how far its weight rounds and its stop depart from the
  reference's rule, replayed on the relative changes the program read after
  each of its updates (``Schedule.gaps``): a solve that skips a round,
  makes one early or late, or stops early or late reads 1 or more.

Each number compared has its own limit (``limits/<cell>.json``), and a
run compares only the numbers its cell's file names (all of them, each
failing, where the cell has no file: the readings that limits are set
from).
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict, List, Tuple

import numpy as np


def request_numbers(rec: Dict, ref: Dict) -> Dict[str, float]:
    return {
        "traj": float(np.max(np.abs(np.asarray(rec["T"], np.float64) - ref["T"]))),
        "cost": abs(rec["cost"] - ref["cost"]) / abs(ref["cost"]),
        "updates": float(abs(rec["iterations"] - ref["iterations"])),
    }


def state_numbers(st: Dict, g: Dict, cfg: Dict, plain: ModuleType) -> Dict[str, float]:
    nums = {}
    if hasattr(plain, "state_cost"):
        f64 = plain.state_cost(g, cfg["solver"], st["X"], st["w_pre"])
        nums["state_cost"] = abs(st["cost"] - f64) / abs(f64)
    if hasattr(plain, "rounded"):
        nums["rounding"] = float(np.max(np.abs(np.asarray(st["T"], np.float64)
                                               - plain.rounded(st["X"]))))
    return nums


def _worst(acc: Dict[str, float], nums: Dict[str, float]) -> None:
    for k, v in nums.items():
        v = float(v) if np.isfinite(v) else float("inf")
        acc[k] = max(acc.get(k, 0.0), v)


def compare(records: List[Dict], states: List[Dict], refs: Dict[int, Dict],
            graphs: List[Dict], cfg: Dict, limits: Dict,
            plain: ModuleType) -> Tuple[Dict, int]:
    """(checks {name: {"value", "limit"}}, answers that failed a check)."""
    worst: Dict[str, float] = {}
    failed = set()

    def judge(i, nums):
        if limits:  # a run compares the numbers its cell has limits for
            nums = {k: v for k, v in nums.items() if k in limits}
        else:  # readings: every number, no detail
            nums = {k: v for k, v in nums.items() if not k.startswith("_")}
        _worst(worst, nums)
        if any(not (np.isfinite(v) and v <= limits.get(k, -1.0)) for k, v in nums.items()):
            failed.add(i)

    rule = None
    for i, rec in enumerate(records):
        nums = {}
        if rec["graph"] in refs:
            nums.update(request_numbers(rec, refs[rec["graph"]]))
        if rec.get("sched") is not None and hasattr(plain, "Schedule"):
            if rule is None:
                g = graphs[rec["graph"]]
                rule = plain.Schedule(cfg["solver"], len(g["num_poses"]))
            s = rec["sched"]
            nums["schedule"] = float(rule.gaps(s["rels"], s["rounds_at"], rec["iterations"]))
        if nums:
            judge(i, nums)
    for st in states:
        g = graphs[st["graph"]]
        nums = state_numbers(st, g, cfg, plain)
        if st.get("stages") is not None and hasattr(plain, "settle_gaps"):
            rounds = st["stages"]["rounds"]
            w_round = (rounds[-1] if rounds else st["stages"]["start"])["weights"]
            nums["settle"] = float(plain.settle_gaps(g, cfg["solver"], st["T"], w_round,
                                                     st["w_final"]))
        nums.update(st.get("follow", {}))
        judge(st["index"], nums)
    checks = {k: {"value": v, "limit": float(limits.get(k, -1.0))} for k, v in worst.items()}
    return checks, len(failed)
