"""Training and inference (inference only so far)."""
