"""The port's native C++ ingestion (``io/native.py``) against its Python
parsers, on files written here.

1. The library is built from the checkout's ``native/g2o_parser.cpp`` into
   ``build/`` (a port-owned, git-ignored path) and nothing under
   ``native/`` is written; a build that fails leaves ``available()`` false
   with the reason kept, and the loaders take the Python path.
2. ``io/g2o.read_g2o`` and ``io/csv_loader.load_measurements_csv`` take
   the native path (3D g2o, CSV) unless ``DPGO_TPU_NO_NATIVE=1``; a 2D file
   falls through to Python. The two agree bit for bit on ids, counts,
   translations, κ, τ, weights, flags and edge types. Rotations agree to
   8 eps absolute: the C source sums the quaternion's squares left to
   right, ``np.linalg.norm`` in another order, so about one norm in eight
   differs in its last bit, and an entry 1 − 2s (2s up to 2, whose unit in
   the last place is 2 eps) moves by a few units of that (the JAX package's
   own parity test holds them to 1e-12).
"""

import os

import numpy as np
import pytest

from dpgo_ros_tpu_torch.io import csv_loader, g2o, native, synthetic

ROT_TOL = 8 * np.finfo(np.float64).eps


def _g2o_3d(tmp_path):
    data, gt, _ = synthetic.generate_world("sphere", n=300, num_robots=1, seed=6)
    path = tmp_path / "world3d.g2o"
    g2o.write_g2o(str(path), gt, data.measurements)
    return str(path)


def _g2o_2d(tmp_path):
    rng = np.random.default_rng(2)
    lines = [f"VERTEX_SE2 {i} {x:.9f} {y:.9f} {th:.9f}"
             for i, (x, y, th) in enumerate(rng.uniform(-5, 5, (40, 3)))]
    for i in range(40):
        j = (i + 1) % 40
        dx, dy, dth = rng.normal(0, 1, 3)
        lines.append(f"EDGE_SE2 {i} {j} {dx:.9f} {dy:.9f} {dth:.9f} "
                     f"{rng.uniform(50, 100):.6f} 0 0 {rng.uniform(50, 100):.6f} 0 "
                     f"{rng.uniform(100, 500):.6f}")
    path = tmp_path / "world2d.g2o"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _csv(tmp_path):
    data, _, _ = synthetic.generate_world("grid3d", grid_shape=(4, 4, 3),
                                          num_robots=2, seed=8, outlier_ratio=0.1)
    m = data.measurements
    q = np.stack([g2o.rot_to_quat(R) for R in m.R])
    rows = ["robot_src,pose_src,robot_dst,pose_dst,qx,qy,qz,qw,tx,ty,tz,"
            "kappa,tau,is_known_inlier,weight"]
    for e in range(len(m)):
        rows.append(",".join(str(v) for v in [
            int(m.src_robot[e]), int(m.src_frame[e]), int(m.dst_robot[e]),
            int(m.dst_frame[e]), *q[e], *m.t[e], m.kappa[e], m.tau[e],
            int(e % 3 == 0), m.weight[e]]))
    path = tmp_path / "measurements.csv"
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def _same_but_rotations(a, b):
    for f in ("src_robot", "src_frame", "dst_robot", "dst_frame", "t", "kappa",
              "tau", "weight", "fixed_weight", "edge_type"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.R.shape == b.R.shape and np.max(np.abs(a.R - b.R)) <= ROT_TOL


def _python(monkeypatch, fn, path):
    monkeypatch.setenv("DPGO_TPU_NO_NATIVE", "1")
    out = fn(path)
    monkeypatch.delenv("DPGO_TPU_NO_NATIVE")
    return out


def _spy(monkeypatch, name):
    calls = []
    real = getattr(native, name)
    monkeypatch.setattr(native, name, lambda p: calls.append(p) or real(p))
    return calls


def test_library_is_built_under_build(tmp_path, monkeypatch):
    native_dir = native.SOURCE.parent
    before = {p: os.stat(native_dir / p).st_mtime_ns for p in os.listdir(native_dir)}
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert native.available(), native.build_error()
    assert native.lib_path().parent == tmp_path / "build" and native.lib_path().exists()
    after = {p: os.stat(native_dir / p).st_mtime_ns for p in os.listdir(native_dir)}
    assert after == before


def test_default_library_path_is_in_build():
    assert native.available(), native.build_error()
    root = native.SOURCE.parent.parent
    assert native.lib_path().parent == root / "build" / "dpgo_ros_tpu_torch"


def test_failed_build_is_visible(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not native.available()
    assert "no-such-compiler" in native.build_error()
    path = _g2o_3d(tmp_path)
    m, n, v = g2o.read_g2o(path)  # the Python parser
    mp, npy, vp = _python(monkeypatch, g2o.read_g2o, path)
    assert n == npy and np.array_equal(m.R, mp.R) and np.array_equal(m.t, mp.t)


def test_g2o_3d_native_matches_python(tmp_path, monkeypatch):
    path = _g2o_3d(tmp_path)
    calls = _spy(monkeypatch, "read_g2o_native")
    mn, nn, vn = g2o.read_g2o(path)
    assert calls == [path]
    mp, npy, vp = _python(monkeypatch, g2o.read_g2o, path)
    assert calls == [path]  # DPGO_TPU_NO_NATIVE=1: the Python path only
    assert nn == npy == 300 and len(mn) == len(mp) > 300
    _same_but_rotations(mn, mp)
    assert vn.keys() == vp.keys()
    for k in vp:
        assert np.array_equal(vn[k][:, 3], vp[k][:, 3])
        assert np.max(np.abs(vn[k][:, :3] - vp[k][:, :3])) <= ROT_TOL


def test_g2o_2d_falls_through_to_python(tmp_path, monkeypatch):
    path = _g2o_2d(tmp_path)
    mn, nn, vn = g2o.read_g2o(path)
    mp, npy, vp = _python(monkeypatch, g2o.read_g2o, path)
    assert nn == npy == 40 and mn.R.shape == (40, 2, 2)
    for f in ("src_frame", "dst_frame", "R", "t", "kappa", "tau", "weight"):
        assert np.array_equal(getattr(mn, f), getattr(mp, f)), f
    assert vn.keys() == vp.keys() and all(np.array_equal(vn[k], vp[k]) for k in vp)


def test_csv_native_matches_python(tmp_path, monkeypatch):
    path = _csv(tmp_path)
    calls = _spy(monkeypatch, "read_csv_native")
    mn = csv_loader.load_measurements_csv(path)
    assert calls == [path]
    mp = _python(monkeypatch, csv_loader.load_measurements_csv, path)
    assert len(mn) == len(mp) > 50 and mn.fixed_weight.any()
    _same_but_rotations(mn, mp)


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.read_g2o_native(str(tmp_path / "absent.g2o"))
    with pytest.raises(FileNotFoundError):
        native.read_csv_native(str(tmp_path / "absent.csv"))
