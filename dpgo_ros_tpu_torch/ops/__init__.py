"""Tensor operators: SE(d)/Stiefel algebra, the PGO quadratic, chordal
initialization, rounding, and the CUDA kernels' wrappers: the RTR block
solve and multi-step runner (``fused_rtr``) and the ASAPP tick
(``fused_asapp``)."""
