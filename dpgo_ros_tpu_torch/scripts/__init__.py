"""Measurement scripts of the port, run on the card with ``python -m``:
``measure_peaks`` (the attainable fp32 rate, K5 and K6), ``roofline`` (the
block-solve kernels' per-tCG cost against floors), and the ports of the
JAX package's measurement entry points: ``bench`` (the headline harness),
``golden_solves``, ``record_ate``, ``run_baselines``, ``bench_scale``,
``bench_scale_hbm``, ``bench_asapp``, ``bench_spmd_stretch`` and
``record_staircase`` (their shared flags and output in ``common``)."""
