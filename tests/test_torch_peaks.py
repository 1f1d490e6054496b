"""Port parity: the calibration chains (K5, K6) and ``measure_peaks``.

1. The plain versions ``chain_ref`` / ``chain_cml_ref`` against the JAX
   Pallas kernels ``_chain`` / ``_chain_cml`` of ``scripts/measure_peaks.py``
   in interpret mode, on the JAX script's inputs. K5 to 1e-5 (observed
   1.9e-6 after one step, 0 after more). K6 to 1e-4 over 1, 2 and 4 steps
   (observed ≤ 9.5e-6); the map is chaotic and folds at floor(v/4), so a
   flip shows first at 8 steps and every element differs by 50: there the
   output's mean, a sample over 131,072 elements whose standard error is
   about 5e-4 relative, is held to 2e-3.
2. The wrappers: operand checks, CPU tensors through the plain versions
   with no launch counted, the source in the build.
3. ``measure_peaks``: the validity rule and the rate on synthetic timings,
   and no run without a card.
The CUDA kernels themselves run only on the card (``python3 chip_smoke.py``,
and the ``cuda``-marked test here).
"""

import functools
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_ros_tpu_torch.ops import fused_rtr, peak_chains
from dpgo_ros_tpu_torch.ops.peak_chains import LANES, NCHAIN, ROWS
from dpgo_ros_tpu_torch.scripts import measure_peaks
from dpgo_ros_tpu_torch.utils import profiling
from torch_parity import load_jax_script

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_peaks():
    return load_jax_script("measure_peaks")


def _inputs(kind: str) -> np.ndarray:
    """The JAX script's slabs: seed 7 in [0.2, 0.8) for K5, seed 11 in
    [0.1, 3.9) for K6 (measure_peaks' inputs on the card)."""
    seed, lo, hi = (7, 0.2, 0.8) if kind == "chain" else (11, 0.1, 3.9)
    x = np.random.default_rng(seed).uniform(lo, hi, (NCHAIN * ROWS, LANES))
    assert (seed, lo, hi) == (measure_peaks.K5_INPUT if kind == "chain"
                              else measure_peaks.K6_INPUT)
    assert torch.equal(measure_peaks.slabs(seed, lo, hi, device="cpu"),
                       torch.as_tensor(x, dtype=torch.float32))
    return x.astype(np.float32)


def _jax_chain(jax_peaks, kind: str, n: int) -> np.ndarray:
    """The JAX kernel, run in interpret mode on the CPU."""
    from jax.experimental import pallas as pl

    make = jax_peaks._chain if kind == "chain" else jax_peaks._chain_cml
    with mock.patch.object(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)):
        return np.asarray(make(n)(jnp.asarray(_inputs(kind))))


@pytest.mark.parametrize("n", [1, 2, 8, 50])
def test_plain_k5_matches_jax_chain(jax_peaks, n):
    ours = peak_chains.chain_ref(torch.as_tensor(_inputs("chain")), n).numpy()
    theirs = _jax_chain(jax_peaks, "chain", n)
    assert ours.shape == theirs.shape == (ROWS, LANES)
    assert np.abs(ours - theirs).max() <= 1e-5


@pytest.mark.parametrize("n", [1, 2, 4])
def test_plain_k6_matches_jax_chain_cml(jax_peaks, n):
    ours = peak_chains.chain_cml_ref(torch.as_tensor(_inputs("cml")), n).numpy()
    theirs = _jax_chain(jax_peaks, "cml", n)
    assert ours.shape == theirs.shape == (ROWS, LANES)
    assert np.abs(ours - theirs).max() <= 1e-4


def test_plain_k6_mean_matches_jax_after_50_steps(jax_peaks):
    ours = peak_chains.chain_cml_ref(torch.as_tensor(_inputs("cml")), 50).numpy()
    theirs = _jax_chain(jax_peaks, "cml", 50)
    assert np.all((ours >= 0) & (ours < 4 * NCHAIN))
    assert abs(ours.mean() - theirs.mean()) <= 2e-3 * abs(theirs.mean())


@pytest.mark.parametrize("kind", ["chain", "cml"])
def test_wrapper_runs_plain_version_on_cpu_and_counts_no_launch(kind):
    x = torch.as_tensor(_inputs(kind))
    fused = peak_chains.chain_fused if kind == "chain" else peak_chains.chain_cml_fused
    ref = peak_chains.chain_ref if kind == "chain" else peak_chains.chain_cml_ref
    before = profiling.launches()["k5"], profiling.launches()["k6"]
    out = fused(x, 7)
    assert (profiling.launches()["k5"], profiling.launches()["k6"]) == before
    assert out.shape == (ROWS, LANES) and out.dtype == torch.float32
    assert torch.equal(out, ref(x, 7))
    assert torch.equal(fused(x, 0), x.reshape(NCHAIN, ROWS, LANES).sum(0))


@pytest.mark.parametrize("bad", ["shape", "dtype", "contiguous", "device", "negative",
                                 "float_iters", "bool_iters"])
def test_wrapper_rejects_operands_the_kernel_cannot_take(bad):
    x, n, err = torch.as_tensor(_inputs("chain")), 3, ValueError
    if bad == "shape":
        x = x[:ROWS]
    elif bad == "dtype":
        x, err = x.double(), TypeError
    elif bad == "contiguous":
        x = x.T.contiguous().T  # the right shape, column-major
    elif bad == "device":
        x = x.to("meta")
    elif bad == "negative":
        n = -1
    elif bad == "float_iters":
        n = 3.0
    else:
        n = True
    for fused in (peak_chains.chain_fused, peak_chains.chain_cml_fused):
        with pytest.raises(err):
            fused(x, n)


def test_build_all_lists_the_chains(tmp_path, monkeypatch):
    """build_all() compiles K5/K6 with the other kernels; a failing nvcc
    names the source and raises."""
    monkeypatch.setattr(fused_rtr, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(fused_rtr, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed") as err:
        fused_rtr.build_all()
    assert "peak_chains.cu" in str(err.value)
    src = fused_rtr.PEAK_SOURCE.read_text()
    assert "dpgo_peak_chain(" in src and "dpgo_peak_chain_cml(" in src


@pytest.mark.parametrize("case,valid", [
    ("linear", True),
    ("first_slope_negative", False),
    ("slopes_disagree", False),
    ("equal_checksums", False),
    ("second_slope_zero", False),
])
def test_calibration_validity_rule(case, valid):
    iters = peak_chains.ITERS
    times = {it: 2e-6 + it * 1e-7 for it in iters}
    sums = {it: 100.0 + i for i, it in enumerate(iters)}
    if case == "first_slope_negative":
        times[iters[1]] = times[iters[0]] - 1e-6
    elif case == "slopes_disagree":
        times[iters[2]] = times[iters[1]] + 3 * (iters[2] - iters[1]) * 1e-7
    elif case == "equal_checksums":
        sums = {it: 100.00001 for it in iters}
    elif case == "second_slope_zero":
        times[iters[2]] = times[iters[1]]
    s1, s2 = measure_peaks.slopes(times, iters)
    assert measure_peaks.calibration_valid(s1, s2, sums) is valid


def test_measure_takes_the_rate_from_the_second_slope(monkeypatch):
    """measure() on synthetic launch times 1 µs + 0.1 µs per step: each
    trip count timed once, the rate one step's flops over 0.1 µs."""
    calls = []

    def fake_launch_s(fn, x, n_iter):
        calls.append(n_iter)
        return 1e-6 + n_iter * 1e-7

    monkeypatch.setattr(measure_peaks, "_launch_s", fake_launch_s)
    x = torch.zeros(1)
    r = measure_peaks.measure(lambda x, n: torch.full((2,), float(n)), x,
                              peak_chains.CHAIN_FLOPS, "synthetic")
    assert calls == list(peak_chains.ITERS)
    assert r["valid"] and r["iters"] == list(peak_chains.ITERS)
    want = peak_chains.CHAIN_FLOPS * NCHAIN * ROWS * LANES / 1e-7
    assert r["fp32_attainable_flops"] == pytest.approx(want, rel=1e-9)
    assert r["slope_us_per_iter"] == pytest.approx([0.1, 0.1], rel=1e-9)
    assert set(r) >= {"fp32_attainable_flops", "slope_us_per_iter", "times_ms",
                      "checksums", "valid", "method"}
    ratio, ok = measure_peaks.agreement(r, dict(r, fp32_attainable_flops=want * 2.5))
    assert ratio == pytest.approx(2.5) and not ok
    assert measure_peaks.agreement(r, dict(r, valid=False)) == (None, False)


def test_measure_peaks_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "dpgo_ros_tpu_torch.scripts.measure_peaks"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "CUDA" in p.stderr


@pytest.mark.cuda
def test_kernels_bit_identical_to_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python3 chip_smoke.py)")
    for kind in ("chain", "cml"):
        x = torch.as_tensor(_inputs(kind), device="cuda")
        fused = peak_chains.chain_fused if kind == "chain" else peak_chains.chain_cml_fused
        ref = peak_chains.chain_ref if kind == "chain" else peak_chains.chain_cml_ref
        for n in (1, 7, 500):
            assert torch.equal(fused(x, n), ref(x, n)), (kind, n)
