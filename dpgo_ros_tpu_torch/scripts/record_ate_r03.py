"""The ATE record of the third round on the card: the sphere2500 demo
against the tight centralized solve, and the tunnels GNC cross-schedule
block of the sweep's ``final`` configuration.

Port of ``scripts/record_ate_r03.py``. Run from the repository root on a
machine with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.record_ate_r03 --schedule PATH [--out PATH]

* ``--world`` (default the sphere2500 stand-in): the JAX script's two
  configurations through ``RBCDEngine.run`` (K4, one launch per update),
  as ``record_ate.py`` runs them: the 5-robot RoundRobin demo (Chordal
  init, rel tol 0.2, gradnorm 0.5, ≤ 1,000 updates) against the tight
  centralized solve (one robot, rel tol 1e-3, gradnorm 1e-2, ≤ 300
  updates); ATE over the span, and on a stand-in both against the ground
  truth.
* ``--schedule PATH``: the JSON line of a run of this port's
  ``exp_tunnels_schedule`` that holds the ``final`` configuration; its
  agreement, flips, ATE, refit ATE and runs are copied into the tunnels
  block, with the world and the card of that run. Without it the block
  is left out. The root ``exp_tunnels_schedule.json`` is the TPU's record
  and is refused.

Default fp32 on the card; ``--device cpu --dtype float64`` gives the JAX
script's fp64 CPU numbers. Prints progress on stderr and one JSON line on
stdout; never writes the root ``ATE_r03.json`` (the TPU's record).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from dpgo_ros_tpu_torch.scripts import common, record_ate, roofline
from dpgo_ros_tpu_torch.scripts.common import log


def tunnels_block(path: str) -> dict:
    """The tunnels block from the ``final`` entry of a port sweep's JSON
    line at ``path``."""
    if common.is_root_record(path):
        raise SystemExit(f"--schedule {path}: the repository's root records are the "
                         "TPU's; pass the JSON of a run of "
                         "dpgo_ros_tpu_torch.scripts.exp_tunnels_schedule")
    sweep = json.loads(Path(path).read_text().strip().splitlines()[-1])
    fin = sweep.get("configs", {}).get("final")
    if fin is None:
        raise SystemExit(f"--schedule {path}: no 'final' configuration in the sweep")
    return {
        "config": fin["config"],
        "accept_reject_agreement": fin["agreement"],
        "num_flipped": fin["num_flipped"],
        "ate_rmse": fin["ate_rmse"],
        "trajectory_span": fin["span"],
        "ate_over_span": fin["ate_over_span"],
        "common_accept_set_refit_ate": fin.get("common_set_refit_ate"),
        "common_accept_set_refit_ate_over_span": fin.get("common_set_refit_ate_over_span"),
        "flip_resid_over_barc": fin["flip_resid_over_barc"],
        "runs": fin["runs"],
        "world": sweep.get("world"),
        "stand_in": sweep.get("stand_in"),
        "sweep_card": sweep.get("card"),
        "sweep_dtype": sweep.get("dtype"),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", default="sphere2500", choices=sorted(roofline.STAND_INS))
    p.add_argument("--schedule", help="JSON of a run of this port's exp_tunnels_schedule "
                                      "(its 'final' configuration)")
    common.add_args(p)
    a = common.parse(p, argv, "record_ate_r03")
    card = common.card(a.device)
    log(f"card {card}; {a.dtype} on {a.device}")
    tunnels = tunnels_block(a.schedule) if a.schedule else None
    out = {f"{a.world}_5robot_vs_centralized": record_ate.sphere_record(
        a.world, a.device, a.dtype)}
    if tunnels is not None:
        out["tunnels_8robot_gnc_schedule_independence"] = tunnels
        log(f"tunnels (final): agreement {tunnels['accept_reject_agreement']:.4f}, "
            f"ATE over span {tunnels['ate_over_span']:.5f}")
    out.update(card=card, device=a.device, dtype=a.dtype)
    return common.emit(out, a.out)


if __name__ == "__main__":
    main()
