"""Checkpoints of the port (``dpgo_ros_tpu_torch/utils/checkpoint.py``)
against the JAX package's ``utils/checkpoint.py`` (CPU).

1. A save/load round trip is exact (every field, dtypes, the lifting
   matrix, the metadata); the port writes JAX's on-disk format, so the JAX
   package loads the port's ``RBCDState`` and ``SpmdState`` checkpoints and
   the port loads JAX's, field for field.
2. ``CheckpointManager``: cadence, ``latest()`` and retention; the orbax
   backend raises; a checkpoint short of a field raises.
3. The CLI's ``--checkpoint_dir`` / ``--checkpoint_every`` / ``--resume``:
   an engine run interrupted at iteration 7 and resumed for 5 more equals
   the uninterrupted 12-iteration run (final cost and iterations exactly);
   so do an async run (6 + 6 ticks, the delay generator in the state) and
   an spmd run (12 + 12 launches); the fleet saves its warm-start caches
   and a resumed fleet restores them.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_ros_tpu.parallel import spmd as j_spmd
from dpgo_ros_tpu.parallel.rbcd import RBCDState as JaxRBCDState
from dpgo_ros_tpu.utils import checkpoint as j_ckpt
from dpgo_ros_tpu_torch import cli
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.parallel import multihost, spmd
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine, RBCDState
from dpgo_ros_tpu_torch.utils import checkpoint as ckpt
from dpgo_ros_tpu_torch.utils.config import AgentConfig, InitMethod, UpdateRule
from torch_parity import world


def _engine():
    data, _ = world("grid3d4")
    prob = LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu")
    cfg = AgentConfig(num_robots=2, update_rule=UpdateRule.ROUND_ROBIN,
                      local_initialization_method=InitMethod.ODOMETRY,
                      max_iteration_number=6, relative_change_tolerance=0.0,
                      dtype="float64")
    return RBCDEngine(prob, cfg)


def _host(v):
    """A state field as JAX's RBCDState holds it: int32 counters."""
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.int32)


def test_roundtrip_exact(tmp_path):
    eng = _engine()
    st, _ = eng.run(eng.initialize())
    p = ckpt.save_state(str(tmp_path / "c0"), st, eng.Ylift, meta={"note": "t"})
    st2, ylift, meta = ckpt.load_state(p, device="cpu")
    assert meta == {"note": "t"} and isinstance(st2, RBCDState)
    np.testing.assert_array_equal(ylift, eng.Ylift.numpy())
    for f in RBCDState._fields:
        a, b = getattr(st, f), getattr(st2, f)
        assert type(a) is type(b), f
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype, f
            assert torch.equal(a, b), f
        else:
            assert a == b, f
    # host load: the saved arrays, JAX's int32 counters
    host, _, _ = ckpt.load_state(p)
    assert host.iteration.dtype == np.int32 and int(host.iteration) == st.iteration


def test_each_package_reads_the_others_rbcd_checkpoint(tmp_path):
    eng = _engine()
    st, _ = eng.run(eng.initialize())
    ckpt.save_state(str(tmp_path / "port"), st, eng.Ylift, meta={"cost": 1.5})
    jst, jylift, jmeta = j_ckpt.load_state(str(tmp_path / "port"))
    assert isinstance(jst, JaxRBCDState) and jmeta == {"cost": 1.5}
    np.testing.assert_array_equal(np.asarray(jylift), eng.Ylift.numpy())
    for f in RBCDState._fields:
        a, b = np.asarray(getattr(jst, f)), _host(getattr(st, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    # the reverse: JAX writes, the port reads
    jax_st = JaxRBCDState(**{f: jnp.asarray(_host(getattr(st, f)))
                             for f in RBCDState._fields})
    j_ckpt.save_state(str(tmp_path / "jax"), jax_st, jnp.asarray(eng.Ylift.numpy()))
    pst, pylift, _ = ckpt.load_state(str(tmp_path / "jax"), device="cpu")
    np.testing.assert_array_equal(pylift, eng.Ylift.numpy())
    for f in RBCDState._fields:
        a, b = getattr(pst, f), getattr(st, f)
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b), f
        else:
            assert a == b, f


def test_each_package_reads_the_others_spmd_checkpoint(tmp_path):
    eng = _engine()
    st0 = eng.initialize()
    sp = spmd.ShardedProblem.build(eng.problem, st0.X.numpy(), eng.robot_colors,
                                   num_devices=2, dtype=np.float64)
    st, step = spmd.build_spmd_step(sp, eng.config, multihost.local_mesh(2, "cpu"))
    for it in range(3):
        st = step(it, 0, st)
    host = spmd.gather_state(st, sp.M)
    ckpt.save_state(str(tmp_path / "port"), host, meta={"it": 3})
    jst, _, meta = j_ckpt.load_state(str(tmp_path / "port"), j_spmd.SpmdState)
    assert meta == {"it": 3}
    for f in spmd.SpmdState._fields:
        a, b = np.asarray(getattr(jst, f)), getattr(host, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    # JAX writes its state, the port places it and steps on bit-identically
    j_ckpt.save_state(str(tmp_path / "jax"), jst, meta={"it": 3})
    loaded, _, _ = ckpt.load_state(str(tmp_path / "jax"), spmd.SpmdState)
    st2 = spmd.place_state(loaded, st)
    a, b = step(3, 0, st), step(3, 0, st2)
    assert torch.equal(a.X, b.X) and a.iteration == b.iteration == 4


def test_manager_cadence_latest_retention(tmp_path):
    eng = _engine()
    mgr = ckpt.CheckpointManager(str(tmp_path / "m"), every=2, max_to_keep=2)
    assert mgr.latest() is None
    st, _ = eng.run(eng.initialize(),
                    callback=lambda _, s: mgr.maybe_save(s.iteration, s, eng.Ylift))
    assert mgr.steps() == [4, 6]  # 2 retired
    step, path = mgr.latest()
    assert step == 6 and path == mgr.step_path(6)
    loaded, _, meta = ckpt.load_state(path, device="cpu")
    assert meta["step"] == 6 and torch.equal(loaded.X, st.X)
    assert mgr.maybe_save(5, st) is None and mgr.steps() == [4, 6]
    # JAX's manager finds the port's steps
    assert j_ckpt.CheckpointManager(str(tmp_path / "m")).steps() == [4, 6]


def test_orbax_and_missing_fields_raise(tmp_path):
    eng = _engine()
    st = eng.initialize()
    with pytest.raises(NotImplementedError, match="orbax"):
        ckpt.save_state(str(tmp_path / "o"), st, backend="orbax")
    with pytest.raises(NotImplementedError, match="orbax"):
        ckpt.CheckpointManager(str(tmp_path / "m"), backend="orbax")
    p = ckpt.save_state(str(tmp_path / "c"), st)
    from typing import NamedTuple

    class Other(NamedTuple):
        X: np.ndarray
        nope: np.ndarray

    with pytest.raises(ValueError, match="missing fields"):
        ckpt.load_state(p, Other)


BASE = ["--synthetic", "grid3d", "--synthetic_n", "64", "--num_robots", "2",
        "--device", "cpu", "--relative_change_tolerance", "0",
        "--local_initialization_method", "Odometry"]


def _cli(argv):
    summary, extras = cli.run(BASE + argv)
    return summary


@pytest.mark.parametrize("mode,first,total", [
    ("engine", 7, 12), ("fused", 7, 12), ("async", 6, 12), ("spmd", 12, 24)])
def test_cli_resume_equals_uninterrupted(tmp_path, mode, first, total):
    """Engine mode runs ``--max_iteration_number`` more updates after a
    resume (JAX's engine counts from the resumed state); the fused, async
    and spmd loops count to an absolute cap."""
    extra = ["--mode", mode, "--update_rule", "RoundRobin"]
    if mode == "async":
        extra += ["--RGD_stepsize", "0.2", "--asapp_tolerance", "0"]
    full = _cli(extra + ["--max_iteration_number", str(total)])
    cdir = str(tmp_path / "ck")
    _cli(extra + ["--max_iteration_number", str(first), "--checkpoint_dir", cdir,
                  "--checkpoint_every", "3"])
    mgr = ckpt.CheckpointManager(cdir)
    assert mgr.latest()[0] == first
    rest = total - first if mode == "engine" else total
    resumed = _cli(extra + ["--max_iteration_number", str(rest), "--checkpoint_dir",
                            cdir, "--checkpoint_every", "3", "--resume", "latest"])
    assert resumed["final_cost"] == full["final_cost"]
    key = "ticks" if mode == "async" else "iterations"
    if mode == "engine":
        assert first + resumed[key] == full[key]
    else:
        assert resumed[key] == full[key]
    assert mgr.latest()[0] == total
    if mode == "engine":  # the cadence continued on the global iteration
        assert 9 in mgr.steps()


def test_cli_fleet_checkpoint_and_resume(tmp_path):
    cdir = str(tmp_path / "fleet")
    argv = ["--mode", "fleet", "--update_rule", "RoundRobin",
            "--relative_change_tolerance", "0.1", "--checkpoint_dir", cdir]
    cold, _ = cli.run(BASE + argv)
    with open(os.path.join(cdir, "fleet_meta.json")) as f:
        assert json.load(f)["meta"]["ticks"] == cold["ticks"]
    warm, _ = cli.run(BASE + argv + ["--resume", "latest"])
    assert sum(warm["iterations"].values()) <= sum(cold["iterations"].values()) + 1


def test_cli_resume_latest_without_checkpoints_exits_2(tmp_path):
    with pytest.raises(SystemExit) as e:
        _cli(["--checkpoint_dir", str(tmp_path / "none"), "--resume", "latest"])
    assert e.value.code == 2
