"""Port parity: mid-run trajectory snapshots (``utils/snapshots.py``) and
the CLI's ``--viz_interval`` / ``--viz_interval_iters`` / ``--viz_dir``.

1. The port's ``SnapshotWriter`` and the JAX package's on the same rounded
   state: the TUM file bit-equal, the manifest rows equal but for
   ``wall_sec``, the HTML frame's SVG panels equal (the page too). A lifted
   state is rounded on its device: the trajectory agrees with JAX's
   rounding to 1e-9 (fp64).
2. The cadence: a snapshot on the first iteration asked, then every
   ``interval_iters``; an interval in seconds too.
3. The CLI writes snapshots at the JAX CLI's iterations in the engine,
   spmd, async and fleet modes (small fp64 runs, tolerances 0 so that both
   run to the same cap), the files named in its manifest present.
"""

import csv
import os
import re
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_ros_tpu import cli as jax_cli
from dpgo_ros_tpu.ops import rounding as j_rounding
from dpgo_ros_tpu.utils.snapshots import SnapshotWriter as JaxWriter
from dpgo_ros_tpu_torch import cli
from dpgo_ros_tpu_torch.io.synthetic import generate_world
from dpgo_ros_tpu_torch.utils.snapshots import SnapshotWriter
from torch_parity import noisy_lifted_gt


@pytest.fixture(scope="module")
def world():
    data, gt, _ = generate_world("sphere", n=200, num_robots=3, seed=2, outlier_ratio=0.2)
    return data, gt


def _rows(directory):
    with open(os.path.join(directory, "snapshots.csv")) as f:
        return list(csv.DictReader(f))


def _svg(path):
    return re.findall(r"<svg.*?</svg>", open(path).read(), flags=re.S)


def test_files_match_jax_on_the_same_state(tmp_path, world):
    data, gt = world
    rng = np.random.default_rng(0)
    T = gt + 0.01 * rng.standard_normal(gt.shape)
    w = rng.uniform(0.0, 1.0, len(data.measurements))
    jd, td = tmp_path / "jax", tmp_path / "port"
    jw, tw = JaxWriter(str(jd), data), SnapshotWriter(str(td), data)
    for it, cost in [(3, 1234.5678901234), (7, None)]:
        assert jw.snapshot(it, T, weights=w, cost=cost) == tw.snapshot(
            it, torch.as_tensor(T), weights=torch.as_tensor(w), cost=cost)
        name = f"snap_iter{it:06d}.tum"
        assert (td / name).read_bytes() == (jd / name).read_bytes()
        svg = _svg(jd / "latest.html")
        assert len(svg) == 3 and svg == _svg(td / "latest.html")
        assert (td / "latest.html").read_bytes() == (jd / "latest.html").read_bytes()
    jr, tr = _rows(jd), _rows(td)
    assert len(tr) == 2 and tw.count == 2
    for a, b in zip(jr, tr):
        assert {k: v for k, v in a.items() if k != "wall_sec"} == {
            k: v for k, v in b.items() if k != "wall_sec"}
    assert not (td / ".latest.html.tmp").exists()


def test_lifted_state_is_rounded_as_jax_does(tmp_path, world):
    data, gt = world
    X = noisy_lifted_gt(gt, 5, seed=1, noise=0.02)
    tw = SnapshotWriter(str(tmp_path / "port"), data, html=False)
    name = tw.snapshot(4, torch.as_tensor(X))
    T_j = np.asarray(j_rounding.anchor_to_first_pose(
        j_rounding.round_solution(jnp.asarray(X))))
    tum = np.loadtxt(tmp_path / "port" / name)
    np.testing.assert_allclose(tum[:, 1:4], T_j[:, :, 3], atol=1e-9)
    assert not (tmp_path / "port" / "latest.html").exists()


def test_cadence(tmp_path, world):
    data, gt = world
    tw = SnapshotWriter(str(tmp_path / "a"), data, interval_sec=0.0, interval_iters=5)
    assert [it for it in range(1, 23) if tw.maybe_snapshot(it, gt)] == [1, 6, 11, 16, 21]
    tw = SnapshotWriter(str(tmp_path / "b"), data, interval_sec=0.05)
    assert not tw._due(1)
    time.sleep(0.06)
    assert tw.maybe_snapshot(2, gt) and not tw.maybe_snapshot(3, gt)


BASE = ["--synthetic", "grid3d", "--synthetic_n", "64", "--num_robots", "2",
        "--dtype", "float64", "--update_rule", "RoundRobin"]
MODES = {
    "engine": ["--max_iteration_number", "14", "--relative_change_tolerance", "0",
               "--viz_interval_iters", "4"],
    "spmd": ["--mode", "spmd", "--max_iteration_number", "10",
             "--relative_change_tolerance", "0", "--viz_interval_iters", "3"],
    "async": ["--mode", "async", "--max_iteration_number", "450", "--asapp_tolerance", "0",
              "--RGD_stepsize", "0.2", "--asynchronous_rate", "100",
              "--viz_interval_iters", "100"],
    "fleet": ["--mode", "fleet", "--max_iteration_number", "12",
              "--relative_change_tolerance", "0", "--viz_interval_iters", "5"],
}


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_snapshots_at_the_jax_iterations(tmp_path, capsys, mode):
    flags = BASE + MODES[mode]
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_cli.main(flags + ["--platform", "cpu", "--viz_dir", jd]) == 0
    capsys.readouterr()
    cli.run(flags + ["--device", "cpu", "--viz_dir", td])
    j_its = [int(r["iteration"]) for r in _rows(jd)]
    t_its = [int(r["iteration"]) for r in _rows(td)]
    assert len(t_its) >= 2 and t_its == j_its
    for r in _rows(td):
        assert os.path.exists(os.path.join(td, r["file"]))
    assert os.path.exists(os.path.join(td, "latest.html"))
