"""Resizes on the device.  Only the decoder's 2x upsample is ported so far."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample with align_corners=True on NCHW (reference
    models.py:64)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)
