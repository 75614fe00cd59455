"""Step ops: lattice constants, the plain torch reference, the fused kernel."""
