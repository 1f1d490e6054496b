"""A run without a card, or without the program beside the benchmark, fails
and prints no result; on a card (the ``cuda`` marker) a short run of a
cell is correct."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT

ARGS = ["--workload", "dpgo_demo.warm", "--seed", str(2**31 + 9), "--seconds", "1",
        "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, **(env or {})))


def test_no_card_no_result():
    r = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run these tests on the card)")


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    r = _run(ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"
