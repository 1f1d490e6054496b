"""The port's own copies of the JAX package's numpy-only modules.

``dpgo_ros_tpu_torch`` imports nothing of the JAX package; it carries copies
of ``types``, ``io`` (g2o, partition, synthetic, csv_loader, datasets) and
``utils`` (config, export, viz, telemetry). Each copy must give the same
result as its JAX twin: ``generate_world`` bit-identical arrays over kinds
and seeds, g2o write→read, ``partition_g2o``, the CSV loader,
``AgentConfig.resolve``, the exported files and the telemetry CSVs byte for
byte. An AST scan holds the import boundary.
"""

import ast
import dataclasses
import enum
from pathlib import Path

import numpy as np
import pytest
import torch

from dpgo_ros_tpu.io import csv_loader as j_csv
from dpgo_ros_tpu.io import g2o as j_g2o
from dpgo_ros_tpu.io import partition as j_partition
from dpgo_ros_tpu.io import synthetic as j_synthetic
from dpgo_ros_tpu.models.problem import LiftedProblem as JaxProblem
from dpgo_ros_tpu.utils import config as j_config
from dpgo_ros_tpu.utils import export as j_export
from dpgo_ros_tpu.utils import telemetry as j_telemetry
from dpgo_ros_tpu_torch.io import csv_loader, g2o, partition, synthetic
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.utils import config, export, telemetry
from torch_parity import port_config

REPO = Path(__file__).resolve().parent.parent


def _same_data(a, b):
    """Two PoseGraphData (or MeasurementBatch) hold identical arrays."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _same_data(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_data(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=True)
    else:
        assert a == b


@pytest.mark.parametrize("kw", [
    dict(kind="sphere", n=256, num_robots=3, seed=0),
    dict(kind="sphere", n=500, num_robots=5, seed=42, outlier_ratio=0.1),
    dict(kind="grid3d", grid_shape=(4, 4, 4), num_robots=2, seed=1),
    dict(kind="grid3d", grid_shape=(5, 4, 3), num_robots=4, seed=7,
         loop_radius=2.5, balance="work"),
], ids=["sphere256", "sphere500-outliers", "grid3d4", "grid3d-work"])
def test_generate_world_is_bit_identical(kw):
    data, gt, planted = synthetic.generate_world(**kw)
    jdata, jgt, jplanted = j_synthetic.generate_world(**kw)
    _same_data(data, jdata)
    _same_data(gt, jgt)
    _same_data(np.asarray(planted), np.asarray(jplanted))


def _g2o_file(tmp_path, d3=True):
    data, gt, _ = synthetic.generate_world("sphere", n=120, num_robots=1, seed=3)
    m = data.measurements
    path = tmp_path / "world.g2o"
    g2o.write_g2o(str(path), gt, m)
    return path, gt, m


def test_g2o_round_trip_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("DPGO_TPU_NO_NATIVE", "1")  # the JAX twin's Python parser
    path, gt, m = _g2o_file(tmp_path)
    jpath = tmp_path / "world_jax.g2o"
    j_g2o.write_g2o(str(jpath), gt, m)
    assert path.read_bytes() == jpath.read_bytes()
    mb, n, verts = g2o.read_g2o(str(path))
    jmb, jn, jverts = j_g2o.read_g2o(str(path))
    assert n == jn == gt.shape[0]
    _same_data(mb, jmb)
    _same_data(verts, jverts)
    np.testing.assert_allclose(mb.t, m.t, atol=1e-8)


@pytest.mark.parametrize("balance", ["poses", "work"])
def test_partition_g2o_matches_jax(tmp_path, monkeypatch, balance):
    monkeypatch.setenv("DPGO_TPU_NO_NATIVE", "1")
    path, _, _ = _g2o_file(tmp_path)
    _same_data(partition.partition_g2o(str(path), 4, balance=balance),
               j_partition.partition_g2o(str(path), 4, balance=balance))


def test_csv_loader_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("DPGO_TPU_NO_NATIVE", "1")
    data, _, _ = synthetic.generate_world("grid3d", grid_shape=(3, 3, 3),
                                          num_robots=2, seed=5)
    m = data.measurements
    q = np.stack([g2o.rot_to_quat(R) for R in m.R])
    paths = []
    for k in range(2):
        path = tmp_path / f"robot{k}.csv"
        rows = np.flatnonzero(m.src_robot == k)
        lines = ["robot_src,pose_src,robot_dst,pose_dst,qx,qy,qz,qw,tx,ty,tz,"
                 "kappa,tau,is_known_inlier,weight"]
        for e in rows:
            lines.append(",".join(str(v) for v in [
                m.src_robot[e], m.src_frame[e], m.dst_robot[e], m.dst_frame[e],
                *q[e], *m.t[e], m.kappa[e], m.tau[e], int(m.fixed_weight[e]),
                m.weight[e]]))
        path.write_text("\n".join(lines) + "\n")
        paths.append(str(path))
    _same_data(csv_loader.load_multi_robot_csv(paths),
               j_csv.load_multi_robot_csv(paths))


def _fields(cfg):
    return {k: (v.value if isinstance(v, enum.Enum) else v)
            for k, v in dataclasses.asdict(cfg).items()}


@pytest.mark.parametrize("kw", [
    {},
    dict(asynchronous=True),
    dict(robust_cost_type="GNC_TLS", GNC_use_probability=True, num_robots=8,
         robust_opt_inner_iters_per_robot=50),
    dict(robust_cost_type="GNC_TLS", GNC_use_probability=False, GNC_barc=3.0),
], ids=["default", "async", "gnc-probability", "gnc-barc"])
def test_config_resolve_matches_jax(kw):
    def make(mod):
        k = dict(kw)
        if "robust_cost_type" in k:
            k["robust_cost_type"] = mod.RobustCostType(k["robust_cost_type"])
        return mod.AgentConfig(**k)

    ours, theirs = make(config).resolve(), make(j_config).resolve()
    assert _fields(ours) == _fields(theirs)
    # the parity tests' translation of a JAX config gives the port's
    assert _fields(port_config(make(j_config))) == _fields(make(config))
    assert isinstance(port_config(make(j_config)), config.AgentConfig)


def test_export_files_are_byte_equal(tmp_path):
    data, gt, _ = synthetic.generate_world("sphere", n=200, num_robots=3, seed=4,
                                           outlier_ratio=0.1)
    m = data.measurements
    w = np.where(np.arange(len(m)) % 7 == 0, 0.0, 1.0)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    for mod, sub in ((export, "port"), (j_export, "jax")):
        mod.export_solution(str(tmp_path / sub / "sol"), gt, data.num_poses, m, w)
    ours = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert ours == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert {"sol_global.g2o", "sol.html", "sol_robot0.tum"} <= set(ours)
    for name in ours:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_telemetry_csvs_match_jax(tmp_path):
    data, _, _ = synthetic.generate_world("grid3d", grid_shape=(4, 4, 4),
                                          num_robots=2, seed=1)
    rows = np.abs(np.random.default_rng(0).standard_normal((6, 2)))
    rows[3] = np.nan
    kw = dict(rel_change_rows=rows, iter_times=np.full(6, 0.25),
              events=[(2, "UPDATE_WEIGHT")])
    ours = telemetry.write_run_logs(
        str(tmp_path / "port"),
        problem=LiftedProblem.from_data(data, r=5, device="cpu"), **kw)
    theirs = j_telemetry.write_run_logs(
        str(tmp_path / "jax"), problem=JaxProblem.from_data(data, r=5), **kw)
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert Path(a).read_text() == Path(b).read_text()


def _imports(path: Path):
    """Every module name an import statement of ``path`` names, at any
    depth (function-level imports included)."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("where", [
    "dpgo_ros_tpu_torch", "chip_smoke.py",
    "dpgo_ros_tpu_torch/parallel/spmd.py", "dpgo_ros_tpu_torch/parallel/multihost.py",
    "dpgo_ros_tpu_torch/utils/checkpoint.py",
    "dpgo_ros_tpu_torch/scripts/multihost_demo.py",
    "dpgo_ros_tpu_torch/scripts/multicard_check.py",
    "dpgo_ros_tpu_torch/io/native.py", "dpgo_ros_tpu_torch/utils/snapshots.py",
    "dpgo_ros_tpu_torch/utils/profiling.py",
])
def test_port_imports_nothing_of_the_jax_package(where):
    root = REPO / where
    files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
    assert files
    bad = [
        f"{f.relative_to(REPO)}: {name}"
        for f in files for name in _imports(f)
        if name.split(".")[0] in ("dpgo_ros_tpu", "jax", "jaxlib")
    ]
    assert not bad, bad


def test_from_data_defaults_to_the_card():
    import inspect

    sig = inspect.signature(LiftedProblem.from_data)
    assert sig.parameters["device"].default == "cuda"
    data, _, _ = synthetic.generate_world("grid3d", grid_shape=(2, 2, 2), seed=0)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            LiftedProblem.from_data(data, r=3)
