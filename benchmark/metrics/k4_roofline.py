"""K4's share of its roofline, %: the least time its traced solves'
work needs at the H100's published peaks (benchmark/work.py, from the
windows' poses, edges and separators and the kernel's TR and tCG counters)
over its device time by kernel name ('rtr_window_kernel'). Silent unless the trace
holds one kernel per launch the requests made."""

from benchmark.trace import kernel_seconds


def read(run):
    t = run.trace
    if not t or not t["work"]["k4"]:
        return None
    s = kernel_seconds(t, "rtr_window_kernel", t["launches"]["k4"])
    return t["work"]["k4"] / s * 100.0 if s else None
