"""Milliseconds per GNC weight round (the program's ``rbcd.weight_round``
spans: the round, its reset where one follows, and the new preconditioner),
over their calls. Read from the program's span registry
(``dpgo_ros_tpu_torch/utils/profiling.py``), which records only inside a
profiler session: the traced stretch's requests alone. Silent where the
registry holds no ``rbcd.weight_round`` span."""

from dpgo_ros_tpu_torch.utils import profiling


def read(run):
    summary = getattr(profiling, "summary", None)
    rounds = summary().get("rbcd.weight_round") if summary else None
    if not rounds or not rounds["calls"]:
        return None
    return rounds["total_s"] / rounds["calls"] * 1e3
