#!/usr/bin/env python3
"""How the cluster kernels' times follow the pose weight of their slices.

The host cuts each window of K2 and K4 into one slice of local poses per
CTA, balanced by work: a pose weighs its incident edges plus
``hbm_rtr.POSE_WORK`` edges' worth of pose-local passes. This script times
K4 per solve (the 16 blocks of the 50,000-pose world, the 5 of the
dpgo_demo world) and K2 per step (10 RoundRobin steps on the dpgo_demo
world) with the windows rebuilt under each weight of ``SLICE_WEIGHTS``, on
chip_smoke's inputs. It is the measurement behind ``POSE_WORK``; rerun it
when the solve's passes change. Run from the repository root on a machine
with one CUDA GPU:

    python3 slice_sweep.py

Prints one line per weight and, last, one JSON object {weight: [K4 ms per
50k solve, K4 ms per 2,500-pose solve, K2 ms per step]} with the card's
name and power limit. Exits nonzero without a card.
"""

from __future__ import annotations

import json
import sys
from unittest import mock

import chip_smoke as cs
from dpgo_ros_tpu_torch.ops import fused_rtr, hbm_rtr, kernels
from dpgo_ros_tpu_torch.scripts import measure_peaks

# 128 cuts the 50k windows nearly by pose count
SLICE_WEIGHTS = (2, 8, 32, 128)


def sweep() -> dict:
    _, p50, X50, P50, _, _ = cs.large_cases()[0]
    run = next(c for c in cs.run_cases() if c[0] == "sphere2500/r5/roundrobin")
    _, p25, X25, bank, sched, P25, adj, offs, _, rc = run
    out = {}
    for wt in SLICE_WEIGHTS:
        with mock.patch.object(hbm_rtr, "POSE_WORK", wt):
            w50, w25 = hbm_rtr.prepare_windows(p50), hbm_rtr.prepare_windows(p25)
        k4 = lambda prob, X, Pinv, w: (lambda: [
            hbm_rtr.rtr_solve_hbm(X, k, Pinv, prob.edges, cs.DEMO_PARAMS, w)
            for k in range(prob.num_robots)])
        t50 = min(cs._time(k4(p50, X50, P50, w50), 3), cs._time(k4(p50, X50, P50, w50), 3))
        t25 = min(cs._time(k4(p25, X25, P25, w25), 3), cs._time(k4(p25, X25, P25, w25), 3))
        k2 = lambda: cs._run_pair(p25, X25, bank, sched, P25, adj, offs, w25, rc,
                                  fused_rtr.rtr_run_fused)
        t2 = min(cs._time(k2, 3), cs._time(k2, 3)) / rc["it_cap"]
        out[wt] = (t50 / p50.num_robots, t25 / p25.num_robots, t2)
        print(f"slices at pose work {wt}: K4 {out[wt][0]:.4f} ms per 50k solve (largest "
              f"slice {w50.slice_max}), {out[wt][1]:.4f} ms per 2,500-pose solve "
              f"(largest slice {w25.slice_max}); K2 {t2:.4f} ms per step", flush=True)
    return out


def main() -> int:
    measure_peaks.require_cuda("slice_sweep")
    card = measure_peaks.card_line()
    print(f"card: {card}", flush=True)
    kernels.build_all([kernels.RUN_SOURCE, kernels.WINDOW_SOURCE])
    out = sweep()
    print(json.dumps({"card": card, "pose_work": hbm_rtr.POSE_WORK,
                      "ms_by_slice_weight": {str(k): list(v) for k, v in out.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
