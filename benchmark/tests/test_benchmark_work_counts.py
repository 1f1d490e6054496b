"""The frozen work counts against a count by hand on a small graph."""

import numpy as np
import pytest

from benchmark import work


def test_block_work_by_hand():
    # poses 0-1-2-3-4 in a chain, plus 0-3 and 1-4; the block is {0, 1}
    src = np.array([0, 1, 2, 3, 0, 1])
    dst = np.array([1, 2, 3, 4, 3, 4])
    mask = np.zeros(5, bool)
    mask[:2] = True
    # edges touching the block: 0-1, 1-2, 0-3, 1-4; separators 2, 3, 4
    assert work.block_work(src, dst, mask) == (2, 4, 3)


def test_bytes_by_hand():
    d, r = 3, 5
    assert work.edge_bytes(1, d) == 8 + 36 + 12 + 8
    # 2 block poses read and written (20 floats each), 3 separators read,
    # 2 P⁻¹ blocks (16 floats), 7 stats floats; 4 edges
    assert work.solve_bytes(2, 4, 3, r, d, 7) == 4 * (2 * 2 * 20 + 3 * 20 + 2 * 16 + 7) + 4 * 64


def test_operations_by_hand():
    r, d = 5, 3
    edge = r * (4 * 9 + 12 + 6 + 8)  # per edge: residuals, both rows, two row sums
    proj = 4 * r * 9
    prec = 2 * r * 16 + proj + r * 4
    assert work.tcg_flops(2, 4, r, d) == 4 * edge + 2 * (1.5 * proj + prec + 23 * 20)
    retract = 3 * r * d + 20 * (2 * r * 9 + r * d * 7)
    tr = 4 * edge + 2 * (3 * proj + prec + 13 * 20 + retract)
    assert work.tr_flops(2, 4, r, d) == tr
    assert work.rtr_flops(2, 4, r, d, 2, 10) == pytest.approx(
        4 * edge + 2 * (proj + 40) + 2 * tr + 10 * work.tcg_flops(2, 4, r, d))


def test_least_time_takes_the_larger_bound():
    t, by = work.least_seconds(3.35e12, 1.0)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = work.least_seconds(1.0, 67e12 * 2)
    assert t == pytest.approx(2.0) and by == "operations"


def test_trace_summary_by_hand():
    from benchmark import trace

    ann = lambda name, ts, dur: {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur}
    kern = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}
    events = [ann("bench.request", 0, 100), ann("bench.run", 10, 50), ann("bench.request", 200, 100),
              kern("rtr_window_kernel<3, 5>", 20, 10), kern("rtr_window_kernel<3, 5>", 25, 10),
              kern("other", 110, 10), kern("other", 250, 10), kern("late", 400, 10)]
    s = trace.summarize(events)
    # busy: [20, 35], [110, 120], [250, 260] inside the window [0, 300] µs
    assert s["busy_s"] == pytest.approx(35e-6) and s["window_s"] == pytest.approx(300e-6)
    assert trace.kernel_seconds(s, "rtr_window_kernel", 2) == pytest.approx(20e-6)
    # a trace short of (or beyond) the launches the requests made reads nothing
    assert trace.kernel_seconds(s, "rtr_window_kernel", 3) is None
    assert trace.kernel_seconds(s, "rtr_window_kernel", 1) is None
    assert trace.kernel_seconds(s, "rtr_run_kernel", 0) is None
    gaps = {round(v * 1e6): k for k, v in s["idle_gaps"]}
    assert gaps == {20: "run", 75: "request", 130: "between_requests", 40: "request"}
    assert trace.summarize([kern("k", 0, 1)]) is None
