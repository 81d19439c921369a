"""Device ops: stock resizes, morphology and the hand-written kernels."""
