"""The N-card efficiency model that ``record_scaling.py``,
``record_scaling_r03.py`` and ``record_scaling_r05.py`` share.

eff(N) = t_mean / (t_mean·skew + V/BW + (N − 1)·τ), with t_mean the
anchor step over N (the measured one-card step's work split evenly), skew
the largest block's work over the mean, V the separator set's bytes per
step (an upper bound: an all-gather delivers (N − 1)/N of it to each
card), BW a link's rate in one direction and τ its latency per hop. The
anchor is the M = 1 spmd step measured on the card in the same run
(:func:`anchor`); the links are the H100's own (:data:`LINKS`).
"""

from __future__ import annotations

from dpgo_ros_tpu_torch.scripts import scaling_bench

# the JAX scripts' benchmark partitions: (world, robots, kind); "csv" is
# tunnels, whose per-robot split the dataset fixes (no work-balanced cut)
BENCHES = (
    ("tinyGrid3D", 2, "g2o"),
    ("smallGrid3D", 2, "g2o"),
    ("cubicle", 2, "g2o"),
    ("sphere2500", 5, "g2o"),
    ("parking-garage", 5, "g2o"),
    ("torus3D", 5, "g2o"),
    ("tunnels", 8, "csv"),
)
SEP_BYTES_PER_POSE = 80  # an r = 5 lifted pose in fp32: 5 x 4 floats

# the H100's links: bytes per second in one direction and seconds per hop.
# The rates are NVIDIA's H100 SXM5 datasheet figures, halved from the
# datasheet's two-direction totals; the per-hop latencies are the model's
# assumptions (pessimistic, not measured).
LINKS = (
    {"link": "nvlink4_450GBps", "bytes_per_s": 450e9, "tau_s": 1e-6,
     "source": "NVIDIA H100 Tensor Core GPU datasheet: NVLink 900 GB/s (4th gen, 18 "
               "links), 450 GB/s each way; 1 us per hop assumed"},
    {"link": "pcie5_x16_64GBps", "bytes_per_s": 64e9, "tau_s": 10e-6,
     "source": "NVIDIA H100 Tensor Core GPU datasheet: PCIe Gen5 128 GB/s (x16), 64 GB/s "
               "each way; 10 us per hop assumed (through the host)"},
)

MODEL = ("eff(N) = t_mean / (t_mean*skew + V/BW + (N-1)*tau); t_mean = the M = 1 spmd "
         "step measured on the card in this run / N; skew = max_k(poses_k + edges_k) / "
         "mean_k; V = the full separator set per step (upper bound); BW one direction "
         "of an H100 link (datasheet), tau per hop (assumed).")


def benches_arg(text: str) -> tuple:
    """The entries of :data:`BENCHES` named in a comma-separated list."""
    names = [s for s in text.split(",") if s]
    return tuple(b for b in BENCHES if b[0] in names)


def efficiency(skew: float, V: int, N: int, t_step: float) -> dict:
    """eff(N) on every link of :data:`LINKS`."""
    t_mean = t_step / N
    return {ln["link"]: t_mean / (t_mean * skew + V / ln["bytes_per_s"] + (N - 1) * ln["tau_s"])
            for ln in LINKS}


def anchor(world: str, iters: int, device) -> dict:
    """The one-card anchor: the spmd step of ``world`` as 5 robots grouped
    into one slot (``scaling_bench.measure``), K1 per step on the card."""
    r = scaling_bench.measure(world, 5, 1, iters, device)
    return dict(r, world=world, step_s=r["ms_per_step"] / 1e3,
                block_updates_per_s=5 / (r["ms_per_sweep"] / 1e3))
