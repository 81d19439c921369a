"""Device ops: stock resizes and the hand-written kernels."""
