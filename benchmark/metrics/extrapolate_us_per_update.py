"""Host microseconds per block update in the accelerated step's
extrapolation (the program's ``rbcd.extrapolate`` spans: the tangent
projection, the Newton–Schulz retraction over every pose and the ``where``
that builds V), over the ``rbcd.step`` calls. Read from the program's span
registry (``dpgo_ros_tpu_torch/utils/profiling.py``), which records only
inside a profiler session: the traced stretch's requests alone. Silent
where the registry holds no ``rbcd.extrapolate`` span."""

from dpgo_ros_tpu_torch.utils import profiling


def read(run):
    summary = getattr(profiling, "summary", None)
    s = summary() if summary else {}
    step, span = s.get("rbcd.step"), s.get("rbcd.extrapolate")
    if not step or not step["calls"] or not span:
        return None
    return span["total_s"] / step["calls"] * 1e6
