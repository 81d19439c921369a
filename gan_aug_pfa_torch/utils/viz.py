"""Visualization: the evaluation panels (the JAX package's ``utils/viz.py``
``visualize_sample``, reference evaluate.py:67-126) and the GAN sample
strip (``save_gan_sample_strip``, reference train_gan.py:78-92).

The panels are matplotlib figures (Agg).  matplotlib is imported inside
``visualize_sample`` only, and is optional: where it is not installed the
pipelines print ``skip_message`` and draw nothing.  The strip goes through
the port's PNG writer (no PIL)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..data.loader import float_to_uint8
from ..data.png import write_png

# Sentinel-2 13-band ordering: display uses B4/B3/B2 (R/G/B) for images of
# more than 3 channels (the reference's dead branch, evaluate.py:73-75).
_S2_RGB_BANDS = (3, 2, 1)


def have_matplotlib() -> bool:
    """Whether matplotlib can be imported."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def skip_message(count: int) -> str:
    """The line printed instead of ``count`` panels without matplotlib."""
    return f"Skipping {count} visualizations: matplotlib is not installed"


def _displayable_rgb(img: np.ndarray) -> np.ndarray:
    """HWC float image -> displayable [0,1] RGB (band-select if >3ch)."""
    if img.ndim == 3 and img.shape[-1] > 3:
        img = img[..., list(_S2_RGB_BANDS)]
    return np.clip(img, 0.0, 1.0)


def visualize_sample(img1: np.ndarray, img2: np.ndarray,
                     label: Optional[np.ndarray], pred: np.ndarray,
                     city_name: str, index, output_dir: str) -> str:
    """Save a 1x4 panel PNG named validation_sample_{city}_{index}.png
    (reference evaluate.py:103-126): img1 and img2 HWC in [0,1] (clipped
    for display), label HW {0,1} or None (a black map), pred HW
    probabilities (thresholded at 0.5).  Returns its path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    img1 = _displayable_rgb(np.asarray(img1))
    img2 = _displayable_rgb(np.asarray(img2))
    h, w = pred.shape[-2], pred.shape[-1]
    if label is None:
        label_np = np.zeros((h, w), dtype=np.uint8)
    else:
        label_np = np.asarray(label).reshape(h, w)
    pred_np = (np.asarray(pred).reshape(h, w) > 0.5).astype(np.uint8)

    fig, axes = plt.subplots(1, 4, figsize=(20, 5))
    fig.suptitle(f"Validation Sample {index} - City: {city_name}")
    for ax, (im, title, kw) in zip(
        axes,
        [
            (img1, "Image 1 (RGB)", {}),
            (img2, "Image 2 (RGB)", {}),
            (label_np, "Ground Truth Change", {"cmap": "gray"}),
            (pred_np, "Predicted Change", {"cmap": "gray"}),
        ],
    ):
        ax.imshow(im, **kw)
        ax.set_title(title)
        ax.axis("off")
    plt.tight_layout(rect=[0, 0.03, 1, 0.95])
    save_path = os.path.join(output_dir,
                             f"validation_sample_{city_name}_{index}.png")
    plt.savefig(save_path)
    plt.close(fig)
    return save_path


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
