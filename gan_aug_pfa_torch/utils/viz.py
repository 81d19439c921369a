"""The GAN sample strip (the JAX package's ``utils/viz.py``
``save_gan_sample_strip``, reference train_gan.py:78-92), written through
the port's PNG writer: the card's machine has no PIL."""

from __future__ import annotations

import os

import numpy as np

from ..data.loader import float_to_uint8
from ..data.png import write_png


def save_gan_sample_strip(real_a: np.ndarray, fake_b: np.ndarray,
                          real_b: np.ndarray, city: str, epoch: int,
                          output_dir: str) -> str:
    """Save the [real_A | fake_B | real_B] strip of HWC [0,1] images as
    ``sample_{city}_epoch_{epoch:03d}.png``; returns its path."""
    os.makedirs(output_dir, exist_ok=True)
    strip = np.concatenate([real_a, fake_b, real_b], axis=1)
    path = os.path.join(output_dir, f"sample_{city}_epoch_{epoch:03d}.png")
    write_png(path, float_to_uint8(strip))
    return path
