"""K2's (ops/fused_rtr.py, csrc/rtr_run.cu) device time per tCG iteration:
its kernels ('rtr_run_kernel') by name in the traced requests' trace, over the
tCG iterations those requests needed as the fused runner reports them (its stats).
Silent unless the trace holds one kernel per launch the requests made."""

from benchmark.trace import kernel_seconds


def read(run):
    t = run.trace
    if not t or run.cell.traffic["runner"] != "fused" or not t["tcg"]:
        return None
    s = kernel_seconds(t, "rtr_run_kernel", t["launches"]["k2"])
    return s / t["tcg"] * 1e6 if s else None
