"""Image transforms.  Only the [-1, 1] normalize is ported so far."""

from __future__ import annotations

import torch


def normalize(img: torch.Tensor) -> torch.Tensor:
    """[0,1] -> [-1,1] (reference dataset.py:155-159)."""
    return img * 2.0 - 1.0
