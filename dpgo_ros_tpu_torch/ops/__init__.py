"""Tensor operators: SE(d)/Stiefel algebra, the PGO quadratic, chordal
initialization, rounding, and the CUDA kernels' wrappers: the RTR block
solve and multi-step runner (``fused_rtr``), the ASAPP tick
(``fused_asapp``), the windowed block solve (``hbm_rtr``) and the
calibration chains (``peak_chains``)."""
