"""The port's profiling hooks (``utils/profiling.py``) and ``--profile_dir``.

1. ``PhaseTimer`` gives the JAX package's summary: the same phases, keys
   and call counts.
2. ``device_trace(None)`` is a no-op; with a directory it writes one
   Chrome trace of the body, ``annotate`` regions included. On the CPU it
   traces the host only and never touches CUDA (the padded session's
   synchronize is the card's alone).
3. ``--profile_dir`` on the CPU writes a trace of the solve in the engine,
   fused and async modes, and the run's summary is the one without it.
"""

import json
import os

import pytest
import torch

from dpgo_ros_tpu.utils.profiling import PhaseTimer as JaxTimer
from dpgo_ros_tpu_torch import cli
from dpgo_ros_tpu_torch.scripts import roofline
from dpgo_ros_tpu_torch.utils import profiling


def test_phase_timer_matches_jax(tmp_path):
    timers = JaxTimer(), profiling.PhaseTimer()
    for pt in timers:
        for name in ("initialize", "solve", "solve", "export"):
            with pt.phase(name):
                sum(range(1000))
        with pytest.raises(KeyError):
            with pt.phase("raises"):
                {}["x"]
    js, ts = (pt.summary() for pt in timers)
    assert list(ts) == list(js) == ["initialize", "solve", "export", "raises"]
    for k in js:
        assert ts[k].keys() == js[k].keys() == {"calls", "total_sec", "max_sec"}
        assert ts[k]["calls"] == js[k]["calls"]
    assert ts["solve"]["calls"] == 2
    path = tmp_path / "phases.json"
    timers[1].dump(str(path))
    assert json.loads(path.read_text()) == ts


def _no_cuda(monkeypatch):
    def refuse(*_, **__):
        raise AssertionError("the CPU trace touched CUDA")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)


def test_device_trace_none_is_a_noop(tmp_path, monkeypatch):
    _no_cuda(monkeypatch)
    monkeypatch.chdir(tmp_path)
    with profiling.device_trace(None):
        x = torch.ones(3) * 2
    with profiling.device_trace(""):
        pass
    assert float(x.sum()) == 6.0 and os.listdir(tmp_path) == []


def test_device_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    _no_cuda(monkeypatch)
    with profiling.device_trace(str(tmp_path / "prof"), "cpu"):
        with profiling.annotate("dpgo_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((tmp_path / "prof" / files[0]).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "dpgo_region" in names and "aten::mm" in names
    assert roofline.padded_profile is profiling.padded_profile


SMALL = ["--synthetic", "grid3d", "--synthetic_n", "64", "--num_robots", "2",
         "--update_rule", "RoundRobin", "--max_iteration_number", "6",
         "--relative_change_tolerance", "0", "--device", "cpu"]


@pytest.mark.parametrize("mode", ["engine", "fused", "async"])
def test_profile_dir_writes_a_trace(tmp_path, monkeypatch, mode):
    _no_cuda(monkeypatch)
    flags = SMALL + ["--mode", mode]
    base, _ = cli.run(flags)
    traced, _ = cli.run(flags + ["--profile_dir", str(tmp_path / "prof")])
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1
    events = json.loads((tmp_path / "prof" / files[0]).read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    drop = {"wall_time_sec"}
    assert {k: v for k, v in traced.items() if k not in drop} == {
        k: v for k, v in base.items() if k not in drop}
