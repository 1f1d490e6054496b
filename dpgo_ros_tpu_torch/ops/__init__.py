"""Tensor operators: SE(d)/Stiefel algebra, the PGO quadratic, chordal
initialization, rounding and the fused RTR block-solve kernel."""
