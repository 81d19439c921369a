"""Utilities (the GAN sample strip)."""
