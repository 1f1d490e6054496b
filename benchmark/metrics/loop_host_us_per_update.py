"""The engine loop's host microseconds per block update: the time of the
program's ``rbcd.step`` spans outside the ``rbcd.read`` spans inside them
(the update's one host read) and outside a window build (``k4.windows``,
the first update of a cold request; ``windows_ms`` has it), over the
``rbcd.step`` calls. Read from the program's span registry
(``dpgo_ros_tpu_torch/utils/profiling.py``), which records only inside a
profiler session: the traced stretch's requests alone. Silent where the
registry holds no ``rbcd.step`` span."""

from dpgo_ros_tpu_torch.utils import profiling


def read(run):
    summary = getattr(profiling, "summary", None)
    step = summary().get("rbcd.step") if summary else None
    if run.cell.traffic["runner"] != "engine" or not step or not step["calls"]:
        return None
    inner = step["within_s"]
    host = step["total_s"] - inner.get("rbcd.read", 0.0) - inner.get("k4.windows", 0.0)
    return host / step["calls"] * 1e6
