"""Host microseconds per call of K4's wrapper (the program's ``k4.launch``
spans around ``hbm_rtr.rtr_solve_hbm``: its operand checks, window views,
allocations and the launch), over their calls. Read from the program's
span registry (``dpgo_ros_tpu_torch/utils/profiling.py``), which records
only inside a profiler session: the traced stretch's requests alone.
Silent where the registry holds no ``k4.launch`` span."""

from dpgo_ros_tpu_torch.utils import profiling


def read(run):
    summary = getattr(profiling, "summary", None)
    k4 = summary().get("k4.launch") if summary else None
    if not k4 or not k4["calls"]:
        return None
    return k4["total_s"] / k4["calls"] * 1e6
