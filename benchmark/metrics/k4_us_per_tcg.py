"""K4's (ops/hbm_rtr.py, csrc/rtr_window.cu) device time per tCG iteration:
its kernels ('rtr_window_kernel') by name in the traced requests' trace, over the
tCG iterations those requests needed as the engine reports them (``info["tcg_iterations"]``).
Silent unless the trace holds one kernel per launch the requests made."""

from benchmark.trace import kernel_seconds


def read(run):
    t = run.trace
    if not t or run.cell.traffic["runner"] != "engine" or not t["tcg"]:
        return None
    s = kernel_seconds(t, "rtr_window_kernel", t["launches"]["k4"])
    return s / t["tcg"] * 1e6 if s else None
