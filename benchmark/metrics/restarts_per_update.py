"""Accelerated updates that restarted, per update: the program's
``rbcd.restart`` spans (a restarted step's second solve, its cost and its
read) over its ``rbcd.step`` calls, 0 where the traced requests extrapolated
and none restarted. Read from the program's span registry
(``dpgo_ros_tpu_torch/utils/profiling.py``), which records only inside a
profiler session: the traced stretch's requests alone. Silent where the
registry holds no ``rbcd.extrapolate`` span (no accelerated step, or a
program without these spans)."""

from dpgo_ros_tpu_torch.utils import profiling


def read(run):
    summary = getattr(profiling, "summary", None)
    s = summary() if summary else {}
    step = s.get("rbcd.step")
    if not step or not step["calls"] or "rbcd.extrapolate" not in s:
        return None
    return s.get("rbcd.restart", {"calls": 0})["calls"] / step["calls"]
