"""Milliseconds per build of the K4/K2 window tables (the program's
``k4.windows`` spans around ``hbm_rtr.prepare_row_windows``: one build per
cold request, on its first windowed solve), over their calls. Read from
the program's span registry (``dpgo_ros_tpu_torch/utils/profiling.py``),
which records only inside a profiler session: the traced stretch's
requests alone. Silent where the registry holds no ``k4.windows`` span."""

from dpgo_ros_tpu_torch.utils import profiling


def read(run):
    summary = getattr(profiling, "summary", None)
    builds = summary().get("k4.windows") if summary else None
    if not builds or not builds["calls"]:
        return None
    return builds["total_s"] / builds["calls"] * 1e3
