"""The port's profiling hooks (``utils/profiling.py``) and ``--profile_dir``.

1. ``PhaseTimer`` gives the JAX package's summary: the same phases, keys
   and call counts.
2. ``device_trace(None)`` is a no-op; with a directory it writes one
   Chrome trace of the body, ``span`` regions included. On the CPU it
   traces the host only and never touches CUDA (the padded session's
   synchronize is the card's alone).
3. ``--profile_dir`` on the CPU writes a trace of the solve in the engine,
   fused and async modes, and the span table beside it, and the run's
   summary is the one without it.
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
        with profiling.span("dpgo_region"):
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
    traces = [f for f in files if f.startswith("trace_")]
    # one Chrome trace, and the span table beside it
    assert len(traces) == 1 and sorted(files) == sorted(traces + [f"spans_{os.getpid()}.json"])
    events = json.loads((tmp_path / "prof" / traces[0]).read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    drop = {"wall_time_sec"}
    assert {k: v for k, v in traced.items() if k not in drop} == {
        k: v for k, v in base.items() if k not in drop}


# ---- the padded session's warm-up and its long-session guard (the
# roofline's lost first trace; PERF.md §7). CUDA is stubbed: these run
# the session's bookkeeping on the CPU.


@pytest.fixture
def cuda_stubbed(monkeypatch):
    """A fresh process's profiling state, CUDA's synchronize and spin
    kernel stubbed, and the kernel build counted."""
    from dpgo_ros_tpu_torch.ops import fused_rtr

    calls = {"build": 0, "check": 0}
    monkeypatch.setattr(profiling, "_warmed_up", False)
    monkeypatch.setattr(profiling, "longest_session_s", 0.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(fused_rtr, "build_all", lambda: calls.__setitem__(
        "build", calls["build"] + 1))
    monkeypatch.setattr(profiling, "check_warm_up", lambda events: calls.__setitem__(
        "check", calls["check"] + 1))
    return calls


def test_warm_up_runs_once_per_process(cuda_stubbed):
    with profiling.padded_profile(pad=0.0):
        pass
    assert cuda_stubbed == {"build": 1, "check": 1}
    for _ in range(2):
        with profiling.padded_profile(pad=0.0):
            torch.ones(3).sum()
    assert cuda_stubbed == {"build": 1, "check": 1}
    assert 0.0 < profiling.longest_session_s < profiling.LONG_SESSION_S


def test_a_host_only_session_neither_warms_up_nor_counts(cuda_stubbed, monkeypatch):
    _no_cuda(monkeypatch)
    with profiling.padded_profile([profiling.ProfilerActivity.CPU], pad=0.0):
        pass
    assert cuda_stubbed == {"build": 0, "check": 0} and profiling.longest_session_s == 0.0


def test_no_cuda_session_opens_after_a_long_one(cuda_stubbed, monkeypatch):
    monkeypatch.setattr(profiling, "longest_session_s", profiling.LONG_SESSION_S + 1.0)
    with pytest.raises(RuntimeError, match="stayed open"):
        with profiling.padded_profile(pad=0.0):
            pass
    with pytest.raises(RuntimeError, match="stayed open"):
        roofline._device_ms(lambda: None)
    with profiling.padded_profile([profiling.ProfilerActivity.CPU], pad=0.0):
        pass  # a host-only trace loses no device interval


def test_warm_up_check_needs_its_known_launch():
    spin = {"ph": "X", "cat": "kernel", "name": "at::cuda::(anonymous namespace)::spin_kernel"}
    profiling.check_warm_up([spin])
    for events in ([], [dict(spin, cat="cuda_runtime")],
                   [dict(spin, name="void at::native::vectorized_elementwise_kernel")]):
        with pytest.raises(RuntimeError, match="known launch"):
            profiling.check_warm_up(events)


def test_device_ms_still_raises_on_a_trace_short_of_its_launches(cuda_stubbed, monkeypatch):
    from dpgo_ros_tpu_torch.ops import hbm_rtr

    def launch_without_a_trace():  # a K4 launch whose interval the trace lost
        profiling.count("k4.launches")

    monkeypatch.setattr(profiling, "_counts", profiling.counters())
    with pytest.raises(RuntimeError, match="0 kernel intervals for 1 kernel launches"):
        roofline._device_ms(launch_without_a_trace)
    assert roofline._device_ms(lambda: None) == 0.0
