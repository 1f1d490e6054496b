"""Host microseconds per block update in the accelerated step's safeguard
(the program's ``rbcd.safeguard`` spans: the launch of the world's cost of
X_acc and of the test's flag; the read that carries the flag is the step's
``rbcd.read``, which ``read_wait_us_per_update`` reads), over the
``rbcd.step`` calls. Read from the program's span registry
(``dpgo_ros_tpu_torch/utils/profiling.py``), which records only inside a
profiler session: the traced stretch's requests alone. Silent where the
registry holds no ``rbcd.safeguard`` span."""

from dpgo_ros_tpu_torch.utils import profiling


def read(run):
    summary = getattr(profiling, "summary", None)
    s = summary() if summary else {}
    step, span = s.get("rbcd.step"), s.get("rbcd.safeguard")
    if not step or not step["calls"] or not span:
        return None
    return span["total_s"] / step["calls"] * 1e6
