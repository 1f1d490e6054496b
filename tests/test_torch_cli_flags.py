"""The port's CLI against the JAX CLI on the flags it used to reject.

1. Parser coverage: every ``dest`` of the JAX parser is in the port's,
   less exactly ``platform`` and ``cpu_devices`` (the JAX CLI's TPU-host
   switches; the port's ``--device`` replaces them).
2. ``--version`` prints ``dpgo_ros_tpu_torch 0.1.0`` and exits 0.
3. ``--verbose true`` on a small fp64 L2 engine run: stderr holds the JAX
   CLI's ``resolved config`` line (the fields both configs share, as
   parsed JSON) and its per-update ``max_rel_change`` values, line for
   line, to 1e-9 relative (RoundRobin: the two CLIs draw YLift from
   different generators, and RBCD's iterates are equivariant under it).
4. ``--verbose true`` with GNC: the port tags an update ``[UPDATE_WEIGHT]``
   where a weight round fired before it, every tag on an iteration of the
   engine's event list; the JAX CLI on the same command line raises
   IndexError (ROADMAP, reference caveats).
5. ``--csv`` on per-robot CSVs written here: the JAX summary's
   ``final_cost`` and ``iterations`` on the port (fp64, rel 1e-7).
"""

import json
import re

import numpy as np
import pytest

from dpgo_ros_tpu import cli as jax_cli
from dpgo_ros_tpu_torch import cli
from dpgo_ros_tpu_torch.io import g2o, synthetic
from dpgo_ros_tpu_torch.parallel import rbcd


def _dests(parser):
    return {a.dest for a in parser._actions if a.dest != "help"}


def test_every_jax_flag_is_a_port_flag():
    missing = _dests(jax_cli.build_parser()) - _dests(cli.build_parser())
    assert missing == {"platform", "cpu_devices"}


def test_version(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.build_parser().parse_args(["--version"])
    assert exc.value.code == 0
    assert re.fullmatch(r"dpgo_ros_tpu_torch 0\.1\.0", capsys.readouterr().out.strip())


SMALL = ["--synthetic", "grid3d", "--synthetic_n", "64", "--num_robots", "2",
         "--max_iteration_number", "12", "--relative_change_tolerance", "0",
         "--update_rule", "RoundRobin", "--dtype", "float64", "--verbose", "true"]


def _config_line(err: str) -> dict:
    line = next(ln for ln in err.splitlines() if ln.startswith("resolved config: "))
    return json.loads(line[len("resolved config: "):])


def _update_lines(err: str):
    pat = re.compile(r"^iter (\d+): max_rel_change (\S+) iter_time \S+s( \[.*\])?$")
    return [pat.match(ln).groups() for ln in err.splitlines() if pat.match(ln)]


def test_verbose_prints_the_jax_lines(capsys):
    assert jax_cli.main(SMALL + ["--platform", "cpu"]) == 0
    jerr = capsys.readouterr().err
    assert cli.main(SMALL + ["--device", "cpu"]) == 0
    terr = capsys.readouterr().err
    jcfg, tcfg = _config_line(jerr), _config_line(terr)
    shared = jcfg.keys() & tcfg.keys()
    assert len(shared) >= 50 and tcfg["verbose"] is True
    assert {k: tcfg[k] for k in shared} == {k: jcfg[k] for k in shared}
    jl, tl = _update_lines(jerr), _update_lines(terr)
    assert len(tl) == len(jl) == 12
    assert [int(i) for i, _, _ in tl] == list(range(12))
    assert all(tag is None for *_, tag in tl + jl)  # L2: no weight rounds
    jv = np.array([float(v) for _, v, _ in jl])
    tv = np.array([float(v) for _, v, _ in tl])
    assert np.isinf(jv[0]) and np.isinf(tv[0])
    np.testing.assert_allclose(tv[1:], jv[1:], rtol=1e-9)


GNC = ["--synthetic", "grid3d", "--synthetic_n", "64", "--num_robots", "2",
       "--synthetic_outlier_ratio", "0.1", "--robust_cost_type", "GNC_TLS",
       "--max_iteration_number", "30", "--verbose", "true"]


def test_verbose_tags_weight_rounds(capsys, monkeypatch):
    with pytest.raises(IndexError):  # the JAX CLI's fault
        jax_cli.main(GNC + ["--platform", "cpu"])
    capsys.readouterr()
    events = []
    run = rbcd.RBCDEngine.run

    def spy(self, *args, **kw):
        st, info = run(self, *args, **kw)
        events.extend(info["history"]["event"])
        return st, info

    monkeypatch.setattr(rbcd.RBCDEngine, "run", spy)
    assert cli.main(GNC + ["--device", "cpu"]) == 0
    lines = _update_lines(capsys.readouterr().err)
    tagged = [int(i) for i, _, tag in lines if tag is not None]
    assert all(tag == " [UPDATE_WEIGHT]" for *_, tag in lines if tag is not None)
    assert len(events) >= 2 and tagged == [i for i, _ in events]
    assert max(tagged) > len(events)  # JAX's indexing would have failed here


def _write_csvs(tmp_path, data) -> list:
    """Per-robot ``measurements.csv`` files of ``data`` (each robot's file
    holds the measurements whose source it owns)."""
    m = data.measurements
    q = np.stack([g2o.rot_to_quat(R) for R in m.R])
    paths = []
    for k in range(data.num_robots):
        lines = ["robot_src,pose_src,robot_dst,pose_dst,qx,qy,qz,qw,tx,ty,tz,"
                 "kappa,tau,is_known_inlier,weight"]
        for e in np.flatnonzero(m.src_robot == k):
            lines.append(",".join(repr(float(v)) if isinstance(v, float) else str(v)
                                  for v in [
                int(m.src_robot[e]), int(m.src_frame[e]), int(m.dst_robot[e]),
                int(m.dst_frame[e]), *map(float, q[e]), *map(float, m.t[e]),
                float(m.kappa[e]), float(m.tau[e]), int(m.fixed_weight[e]),
                float(m.weight[e])]))
        path = tmp_path / f"robot{k}" / "measurements.csv"
        path.parent.mkdir()
        path.write_text("\n".join(lines) + "\n")
        paths.append(str(path))
    return paths


def test_csv_gives_the_jax_final_cost(tmp_path, capsys):
    data, _, _ = synthetic.generate_world("sphere", n=150, num_robots=3, seed=4)
    paths = _write_csvs(tmp_path, data)
    flags = ["--csv", *paths, "--max_iteration_number", "8",
             "--relative_change_tolerance", "0", "--update_rule", "RoundRobin",
             "--dtype", "float64", "--local_initialization_method", "Chordal"]
    assert jax_cli.main(flags + ["--platform", "cpu"]) == 0
    jsum = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tsum, _ = cli.run(flags + ["--device", "cpu"])
    assert tsum["iterations"] == jsum["iterations"] == 8
    assert tsum["final_cost"] == pytest.approx(jsum["final_cost"], rel=1e-7)


def test_no_source_names_csv(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.run(["--device", "cpu"])
    assert exc.value.code == 2
    assert "--csv" in capsys.readouterr().err
