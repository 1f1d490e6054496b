"""The engine loop's microseconds per block update spent in its host read
(the program's ``rbcd.read`` spans inside its ``rbcd.step`` spans: the
copy of the step's rel changes and cost, which waits for the update's
kernels), over the ``rbcd.step`` calls. Read from the program's span
registry (``dpgo_ros_tpu_torch/utils/profiling.py``), which records only
inside a profiler session: the traced stretch's requests alone. Silent
where the registry holds no ``rbcd.step`` span."""

from dpgo_ros_tpu_torch.utils import profiling


def read(run):
    summary = getattr(profiling, "summary", None)
    step = summary().get("rbcd.step") if summary else None
    if run.cell.traffic["runner"] != "engine" or not step or not step["calls"]:
        return None
    return step["within_s"].get("rbcd.read", 0.0) / step["calls"] * 1e6
