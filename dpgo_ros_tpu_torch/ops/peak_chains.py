"""The roofline's calibration chains (K5, K6) as hand-written CUDA kernels,
and their plain versions.

K5 ports ``scripts/measure_peaks.py::_chain``: 8 slabs of (ROWS, LANES)
fp32, each element stepped ``n_iter`` times through the logistic map
x ← (3.9·x)·(1 − x), then the slabs summed in order. K6 ports
``_chain_cml``: the coupled-map lattice v = 0.99·x[c] + 0.51·x[(c+1) % 8],
x[c] ← v − floor(0.25·v)·4, every chain from the old values, then the same
sum. ``scripts/measure_peaks.py`` of this package times them over trip
counts for an attainable fp32 rate.

:func:`chain_fused` and :func:`chain_cml_fused` launch their kernel
(``csrc/peak_chains.cu``) for CUDA tensors and raise if it cannot be built
or launched; for CPU tensors they run the plain versions :func:`chain_ref`
and :func:`chain_cml_ref`, which take the kernels' operations in the same
order, one torch op over all 8 slabs at a time, so on the card kernel and
plain version agree bit for bit at every trip count. No path falls back
from one to the other.
"""

from __future__ import annotations

from ctypes import c_int, c_void_p

import torch

from dpgo_ros_tpu_torch.ops import kernels
from dpgo_ros_tpu_torch.utils import profiling

NCHAIN = 8
ROWS = 256
LANES = 512
ITERS = (500, 2000, 10000)
# operations per element and step, as the JAX package counts them
CHAIN_FLOPS = 3  # mul, sub, mul
CML_FLOPS = 6  # mul, mul, add, mul, floor, sub-mul counted as 2


def _check(who: str, x: torch.Tensor, n_iter: int) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {x.device}")
    if tuple(x.shape) != (NCHAIN * ROWS, LANES):
        raise ValueError(f"{who}: x shape {tuple(x.shape)}, expected "
                         f"{(NCHAIN * ROWS, LANES)}")
    kernels.check_tensors(who, x, {"x": x}, torch.float32)
    if isinstance(n_iter, bool) or not isinstance(n_iter, int) or n_iter < 0:
        raise ValueError(f"{who}: n_iter must be an int >= 0, got {n_iter!r}")


# K5's and K6's C entries (csrc/peak_chains.cu), as kernels.load declares them
ENTRIES = dict.fromkeys(("dpgo_peak_chain", "dpgo_peak_chain_cml"),
                        ([c_void_p, c_void_p, c_int, c_int, c_void_p], c_int))


def _launch(entry: str, x: torch.Tensor, n_iter: int) -> torch.Tensor:
    out = torch.empty((ROWS, LANES), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):  # launch on x's card, in its stream
        rc = getattr(kernels.load(kernels.PEAK_SOURCE, ENTRIES), entry)(
            x.data_ptr(), out.data_ptr(), ROWS * LANES, n_iter,
            kernels.stream(x.device.index))
    kernels.check_launch(entry, rc)
    return out


def chain_fused(x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """K5: ``n_iter`` logistic-map steps on each of the 8 slabs of ``x``
    (NCHAIN·ROWS, LANES) fp32, then their sum (ROWS, LANES)."""
    _check("chain_fused", x, n_iter)
    if x.device.type == "cpu":
        return chain_ref(x, n_iter)
    out = _launch("dpgo_peak_chain", x, n_iter)
    profiling.count("k5.launches")  # the CUDA kernel's (not the plain version's)
    return out


def chain_cml_fused(x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """K6: ``n_iter`` coupled-map-lattice steps over the 8 slabs of ``x``,
    then their sum (ROWS, LANES)."""
    _check("chain_cml_fused", x, n_iter)
    if x.device.type == "cpu":
        return chain_cml_ref(x, n_iter)
    out = _launch("dpgo_peak_chain_cml", x, n_iter)
    profiling.count("k6.launches")  # the CUDA kernel's (not the plain version's)
    return out


def _slab_sum(v: torch.Tensor) -> torch.Tensor:
    acc = v[0]
    for c in range(1, NCHAIN):
        acc = acc + v[c]
    return acc


def chain_ref(x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """Plain version of K5 on any device."""
    v = x.reshape(NCHAIN, ROWS, LANES)
    for _ in range(n_iter):
        v = (3.9 * v) * (1.0 - v)
    return _slab_sum(v)


def chain_cml_ref(x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """Plain version of K6 on any device."""
    v = x.reshape(NCHAIN, ROWS, LANES)
    for _ in range(n_iter):
        s = v * 0.99 + torch.roll(v, -1, 0) * 0.51  # roll(-1)[c] = v[(c+1) % 8]
        v = s - torch.floor(s * 0.25) * 4.0
    return _slab_sum(v)
