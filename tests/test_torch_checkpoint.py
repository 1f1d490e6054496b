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
4. The ``dcp`` backend (``torch.distributed.checkpoint``): an exact round
   trip of ``RBCDState``, ``SpmdState`` and ``ASAPPState`` (its generator
   state too) that gives what the npz backend gives; its ``meta.json``
   is the npz one but for ``backend``; the same arrays as the JAX
   package's ``orbax`` backend on the same state (JAX in a subprocess),
   each package refusing the other's sharded checkpoint; the manager on
   it; an engine run resumed from it equal to the uninterrupted run; a
   collective save and load by two gloo processes.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

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
from dpgo_ros_tpu_torch.parallel.asapp import ASAPPEngine
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine, RBCDState
from dpgo_ros_tpu_torch.scripts import dcp_check
from dpgo_ros_tpu_torch.utils import checkpoint as ckpt
from dpgo_ros_tpu_torch.utils.config import AgentConfig, InitMethod, UpdateRule
from torch_parity import world


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _states():
    """(name, state, ylift) of each state class a checkpoint holds: the
    engine's after 6 updates (fp64 tensors, host ints), the spmd mesh's
    gathered host state after 3 steps (numpy, (M, 1) int32 counters) and
    the ASAPP engine's after 4 ticks (with the delay generator's uint8
    state)."""
    eng = _engine()
    st0 = eng.initialize()
    st, _ = eng.run(st0)
    yield "rbcd", st, eng.Ylift
    sp = spmd.ShardedProblem.build(eng.problem, st0.X.numpy(), eng.robot_colors,
                                   num_devices=2, dtype=np.float64)
    sst, step = spmd.build_spmd_step(sp, eng.config, multihost.local_mesh(2, "cpu"))
    for it in range(3):
        sst = step(it, 0, sst)
    yield "spmd", spmd.gather_state(sst, sp.M), None
    aeng = ASAPPEngine(eng.problem, dataclasses.replace(eng.config, RGD_stepsize=0.2))
    ast, _ = aeng.run(st0.X, num_ticks=4)
    assert ast.rng.dtype == torch.uint8 and ast.tick == 4
    yield "asapp", ast, None


STATES = ["rbcd", "spmd", "asapp"]


def _state(name):
    return next((st, yl) for n, st, yl in _states() if n == name)


def _same(a, b) -> None:
    """``a`` and ``b`` the same type, dtype and values."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("name", STATES)
def test_dcp_roundtrip_exact(tmp_path, name):
    """Saved as tensors, loaded on the CPU and as host arrays: the saved
    values exactly, and exactly what the npz backend gives."""
    st, ylift = _state(name)
    cls = type(st)
    d = ckpt.save_state(str(tmp_path / "d"), st, ylift, {"n": name}, backend="dcp")
    z = ckpt.save_state(str(tmp_path / "z"), st, ylift, {"n": name})
    assert sorted(os.listdir(d)) == ["dcp", "meta.json"]
    assert not os.path.exists(d + ".tmp")
    for device in ("cpu", None):
        got, gy, meta = ckpt.load_state(d, cls, device=device)
        want, wy, wmeta = ckpt.load_state(z, cls, device=device)
        assert isinstance(got, cls) and meta == wmeta == {"n": name}
        if ylift is None:
            assert gy is None and wy is None
        else:
            _same(gy, wy)
            np.testing.assert_array_equal(gy, ylift.numpy())
        for f in cls._fields:
            _same(getattr(got, f), getattr(want, f))
            a, b = getattr(got, f), getattr(st, f)
            if device is None or isinstance(b, np.ndarray):  # host arrays
                a, b = np.asarray(a), (b if isinstance(b, np.ndarray) else _host(b))
                assert a.dtype == b.dtype, f
                np.testing.assert_array_equal(a, b, err_msg=f)
            else:
                _same(a, b)


@pytest.mark.parametrize("name", STATES)
def test_dcp_meta_equals_npz_but_backend(tmp_path, name):
    st, ylift = _state(name)
    docs = []
    for backend in ("npz", "dcp"):
        p = ckpt.save_state(str(tmp_path / backend), st, ylift, {"k": [1, 2]},
                            backend=backend)
        with open(os.path.join(p, "meta.json")) as f:
            docs.append(json.load(f))
    npz, dcp = docs
    assert npz.pop("backend") == "npz" and dcp.pop("backend") == "dcp"
    assert dcp == npz


# JAX's side of the orbax comparison, in a subprocess so that an Orbax
# import can never stall the suite: save the input state through the
# orbax backend, load it back, and try to load the port's dcp checkpoint
_JAX_ORBAX = """
import json, sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from dpgo_ros_tpu.parallel.rbcd import RBCDState
from dpgo_ros_tpu.utils import checkpoint as c
inp, out, port, result = sys.argv[1:5]
with np.load(inp) as z:
    arrays = {k: z[k] for k in z.files}
ylift = arrays.pop("__ylift__")
st = RBCDState(**{k: jnp.asarray(arrays[k]) for k in RBCDState._fields})
c.save_state(out, st, ylift, meta={"m": 1}, backend="orbax")
back, yl, meta = c.load_state(out)
np.savez(result, __ylift__=np.asarray(yl),
         **{k: np.asarray(v) for k, v in back._asdict().items()})
try:
    c.load_state(port)
    refused = None
except Exception as e:
    refused = type(e).__name__
print("JAX_ORBAX " + json.dumps({"meta": meta, "refused": refused}))
"""


@pytest.mark.skipif(importlib.util.find_spec("orbax") is None,
                    reason="orbax-checkpoint is not installed")
def test_dcp_matches_jax_orbax_and_each_refuses_the_other(tmp_path):
    st, ylift = _state("rbcd")
    host = {f: _host(getattr(st, f)) for f in RBCDState._fields}
    np.savez(tmp_path / "in.npz", __ylift__=ylift.numpy(), **host)
    port = ckpt.save_state(str(tmp_path / "port"), RBCDState(**host), ylift.numpy(),
                           {"m": 1}, backend="dcp")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", _JAX_ORBAX, str(tmp_path / "in.npz"),
         str(tmp_path / "orbax"), port, str(tmp_path / "out.npz")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads([l for l in r.stdout.splitlines() if l.startswith("JAX_ORBAX")][0]
                     .split(" ", 1)[1])
    assert res["meta"] == {"m": 1} and res["refused"] is not None
    assert os.path.isdir(tmp_path / "orbax" / "orbax")
    mine, my_ylift, _ = ckpt.load_state(port)
    with np.load(tmp_path / "out.npz") as z:
        theirs = {k: z[k] for k in z.files}
    for f in RBCDState._fields:
        a, b = getattr(mine, f), theirs[f]
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(my_ylift, theirs["__ylift__"])
    docs = []
    for p in (port, str(tmp_path / "orbax")):
        with open(os.path.join(p, "meta.json")) as f:
            docs.append(json.load(f))
    assert docs[0].pop("backend") == "dcp" and docs[1].pop("backend") == "orbax"
    assert docs[0] == docs[1]
    with pytest.raises(NotImplementedError, match="orbax"):
        ckpt.load_state(str(tmp_path / "orbax"))


def test_foreign_and_unknown_backends_raise(tmp_path):
    p = ckpt.save_state(str(tmp_path / "c"), _engine().initialize(), backend="dcp")
    meta = os.path.join(p, "meta.json")
    with open(meta) as f:
        doc = json.load(f)
    for backend, err in (("orbax", NotImplementedError), ("zip", ValueError)):
        with open(meta, "w") as f:
            json.dump(dict(doc, backend=backend), f)
        with pytest.raises(err, match=backend):
            ckpt.load_state(p)
    with pytest.raises(ValueError, match="zip"):
        ckpt.save_state(str(tmp_path / "z"), _engine().initialize(), backend="zip")
    with pytest.raises(NotImplementedError, match='backend="dcp"'):
        ckpt.CheckpointManager(str(tmp_path / "m"), backend="orbax")


def test_dcp_manager_cadence_latest_retention(tmp_path):
    eng = _engine()
    mgr = ckpt.CheckpointManager(str(tmp_path / "m"), every=2, max_to_keep=2,
                                 backend="dcp")
    assert mgr.latest() is None
    st, _ = eng.run(eng.initialize(),
                    callback=lambda _, s: mgr.maybe_save(s.iteration, s, eng.Ylift))
    assert mgr.steps() == [4, 6]  # 2 retired
    step, path = mgr.latest()
    assert step == 6 and path == mgr.step_path(6)
    loaded, _, meta = ckpt.load_state(path, device="cpu")
    assert meta["step"] == 6 and torch.equal(loaded.X, st.X)
    assert mgr.maybe_save(5, st) is None and mgr.steps() == [4, 6]
    assert sorted(os.listdir(path)) == ["dcp", "meta.json"]
    # JAX's manager finds the port's steps
    assert j_ckpt.CheckpointManager(str(tmp_path / "m")).steps() == [4, 6]


def test_dcp_resume_equals_uninterrupted(tmp_path):
    """7 updates checkpointed through dcp and resumed (the CLI's resume)
    for 5 more: the uninterrupted 12-update run's cost and X exactly."""
    full_eng = _engine()
    full, _ = full_eng.run(full_eng.initialize(), max_iters=12)
    eng = _engine()
    mgr = ckpt.CheckpointManager(str(tmp_path / "m"), every=7, backend="dcp")
    eng.run(eng.initialize(), max_iters=7,
            callback=lambda _, s: mgr.maybe_save(s.iteration, s, eng.Ylift))
    step, path = mgr.latest()
    assert step == 7
    fresh = _engine()
    st = cli._resume_rbcd(fresh, path)
    assert st.iteration == 7 and st.X.dtype == torch.float64
    done, _ = fresh.run(st, max_iters=5)
    assert done.iteration == full.iteration == 12
    assert torch.equal(done.X, full.X) and torch.equal(done.cost, full.cost)


def test_dcp_collective_save_load_two_processes(tmp_path):
    """Two gloo processes save one replicated state collectively and load
    it back (``scripts/dcp_check.py``): both read it bit for bit, one
    checkpoint exists, and its entries are written once (the files hold
    what one process's save holds)."""
    port, n = multihost.free_port(), 200
    path = str(tmp_path / "shared" / "ck")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dpgo_ros_tpu_torch.scripts.dcp_check",
         "--num_processes", "2", "--process_id", str(pid),
         "--coordinator", f"localhost:{port}", "--path", path, "--device", "cpu",
         "--n", str(n), "--dtype", "float64"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    out = []
    for pid, p in enumerate(procs):
        try:
            so, se = p.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"proc {pid} failed:\n{se[-3000:]}"
        line = [l for l in so.splitlines() if l.startswith("DCP_RESULT")]
        out.append(json.loads(line[0].split(" ", 1)[1]))
    assert [r["process_id"] for r in out] == [0, 1]
    assert [r["backend"] for r in out] == ["gloo", "gloo"]
    assert out[0]["files"] == out[1]["files"] == ["ck"]
    assert sorted(os.listdir(path)) == ["dcp", "meta.json"]
    # this process (no group) reads what the pair wrote
    st, ylift = dcp_check.random_state(n, torch.float64, "cpu")
    got, gy, meta = ckpt.load_state(path, device="cpu")
    assert meta == {"n": n}
    np.testing.assert_array_equal(gy, ylift.numpy())
    for f in RBCDState._fields:
        _same(getattr(got, f), getattr(st, f))
    one = ckpt.save_state(str(tmp_path / "one"), st, ylift, backend="dcp")

    def distcp_bytes(p):
        d = os.path.join(p, "dcp")
        return sum(os.path.getsize(os.path.join(d, x)) for x in os.listdir(d)
                   if x.endswith(".distcp"))

    assert distcp_bytes(path) <= 1.1 * distcp_bytes(one)


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
