"""The card-only measurement scripts of the cluster kernels (K2, K4).

``dpgo_ros_tpu_torch.scripts.cluster_barrier`` times the cluster solve's
barriers and reductions alone (``csrc/cluster_barrier.cu``),
``slice_sweep.py`` the kernels under several slice weights and
``dpgo_ros_tpu_torch.scripts.trace_pad`` counts the profiler traces of short
K4 solves that lose kernels, with and without the timer's pad. Here (no
card) each must exit nonzero with no result; their probe kernel is built by the
same nvcc route as the kernels of the paths, from the shared cluster header.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dpgo_ros_tpu_torch.ops import fused_rtr, hbm_rtr
from dpgo_ros_tpu_torch.scripts import cluster_barrier

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("cmd", [["-m", "dpgo_ros_tpu_torch.scripts.cluster_barrier"],
                                 ["slice_sweep.py"],
                                 ["-m", "dpgo_ros_tpu_torch.scripts.trace_pad"]])
def test_probe_exits_nonzero_without_a_card(cmd):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, *cmd], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "CUDA" in p.stderr


def test_barrier_probe_runs_the_solves_reductions():
    src = cluster_barrier.SOURCE.read_text()
    assert '#include "rtr_cluster.cuh"' in src
    assert "cluster_sum<1>" in src and "cluster_sum<4>" in src and "cluster_sum<2>" in src
    assert re.search(r"int dpgo_cluster_barrier\(int nc, int iters, int mode", src)
    assert cluster_barrier.SOURCE not in fused_rtr.ALL_SOURCES  # no path launches it
    assert set(cluster_barrier.MODES.values()) == {0, 1, 2}
    # the clusters chip_smoke's worlds take are among those measured
    assert {2, 3, 7, 14, 15} <= set(cluster_barrier.CLUSTERS)
    assert max(cluster_barrier.CLUSTERS) == hbm_rtr.cluster_size(10 ** 6)


def test_slice_sweep_measures_the_chosen_weight():
    text = (REPO / "slice_sweep.py").read_text()
    weights = re.search(r"SLICE_WEIGHTS = \(([\d, ]+)\)", text)[1]
    assert hbm_rtr.POSE_WORK in [int(w) for w in weights.split(",")]
    assert "phase_slice_sweep" not in (REPO / "chip_smoke.py").read_text()
