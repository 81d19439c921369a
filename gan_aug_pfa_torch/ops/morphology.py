"""Morphological post-processing of change masks (the JAX package's
``ops/morphology.py``).

Binary dilation and erosion over a square structuring element of side
``kernel_size`` on the trailing two dims of (..., H, W) float masks in
{0, 1}, as ``F.max_pool2d`` windows; erosion is ``-max_pool2d(-x)``.  The
JAX ops pad "SAME" with the reduction's identity (-inf for the max, +inf
for the min), (k-1)//2 before and k//2 after, which is asymmetric for an
even k; ``max_pool2d``'s own padding is symmetric, so each op pads
explicitly with -inf and pools without padding.  Out-of-bounds pixels are
background to a dilation and foreground to an erosion, as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _max_window(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """The k x k window maximum with JAX's SAME padding of -inf."""
    if kernel_size < 1:
        raise ValueError(f"kernel_size must be >= 1, got {kernel_size}")
    shape = x.shape
    lo, hi = (kernel_size - 1) // 2, kernel_size // 2
    x = x.reshape(-1, 1, shape[-2], shape[-1])
    x = F.pad(x, (lo, hi, lo, hi), value=float("-inf"))
    return F.max_pool2d(x, kernel_size, stride=1).reshape(shape)


def dilate(mask: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """Binary dilation: max over the structuring element."""
    return _max_window(mask, kernel_size)


def erode(mask: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """Binary erosion: min over the structuring element."""
    return -_max_window(-mask, kernel_size)


def opening(mask: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """Erosion then dilation: removes specks smaller than the kernel."""
    return dilate(erode(mask, kernel_size), kernel_size)


def closing(mask: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """Dilation then erosion: fills holes smaller than the kernel."""
    return erode(dilate(mask, kernel_size), kernel_size)


def postprocess_prediction(probs: torch.Tensor, threshold: float = 0.5,
                           kernel_size: int = 3) -> torch.Tensor:
    """Threshold, opening, closing: a {0, 1} mask of ``probs``'s shape and
    dtype.  The evaluation calls it at its own default threshold of 0.5,
    not at ``--threshold``, as the JAX pipeline does."""
    mask = (probs > threshold).to(probs.dtype)
    return closing(opening(mask, kernel_size), kernel_size)
