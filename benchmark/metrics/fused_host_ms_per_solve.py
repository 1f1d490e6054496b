"""The fused runner's host milliseconds per solve: the program's
``rbcd.fused_prepare`` spans (``make_fused_run``: the schedule, the mask
bank, the row windows) and its ``rbcd.fused_run`` spans (the runner's
call) outside the ``rbcd.read`` spans inside them (the reads that wait
for the card), over the ``rbcd.fused_run`` calls. Read from the program's
span registry (``dpgo_ros_tpu_torch/utils/profiling.py``), which records
only inside a profiler session: the traced stretch's requests alone.
Silent where the registry holds no ``rbcd.fused_run`` span."""

from dpgo_ros_tpu_torch.utils import profiling


def read(run):
    summary = getattr(profiling, "summary", None)
    spans = summary() if summary else {}
    fused = spans.get("rbcd.fused_run")
    if not fused or not fused["calls"]:
        return None
    prepare = spans.get("rbcd.fused_prepare", {}).get("total_s", 0.0)
    host = prepare + fused["total_s"] - fused["within_s"].get("rbcd.read", 0.0)
    return host / fused["calls"] * 1e3
