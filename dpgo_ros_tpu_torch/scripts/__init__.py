"""Measurement scripts of the port, run on the card with ``python -m``:
``measure_peaks`` (the attainable fp32 rate, K5 and K6) and ``roofline``
(the block-solve kernels' per-tCG cost against floors)."""
