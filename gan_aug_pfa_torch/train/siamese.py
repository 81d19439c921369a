"""Siamese inference (the JAX package's ``SiameseTrainer.predict``,
train/siamese.py:259-267).  Training comes with the next slice."""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..data.transforms import normalize

COMPUTE_DTYPES = ("float32", "bfloat16")


@contextlib.contextmanager
def compute_precision(compute_dtype: str, device_type: str):
    """``"float32"``: full float32, TF32 off for convolutions (cuDNN) and
    matrix products.  ``"bfloat16"``: autocast to bf16 (the JAX eval
    default, config.py:265)."""
    if compute_dtype == "float32":
        prev = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = prev
    elif compute_dtype == "bfloat16":
        with torch.autocast(device_type, dtype=torch.bfloat16):
            yield
    else:
        raise ValueError(
            f"compute_dtype must be one of {COMPUTE_DTYPES}, got "
            f"{compute_dtype!r}"
        )


@torch.no_grad()
def predict(model: nn.Module, img1: torch.Tensor, img2: torch.Tensor,
            compute_dtype: str = "bfloat16") -> torch.Tensor:
    """Sigmoid probabilities for [0,1]-range NHWC images: normalize, eval
    forward, sigmoid.  Returns (B, H, W, n_classes) float32.

    The permutes to and from NCHW are views: an NHWC view of an NCHW
    tensor (as the pipeline passes its device cache) reaches the model
    without a copy."""
    model.eval()
    x1 = normalize(img1.permute(0, 3, 1, 2))
    x2 = normalize(img2.permute(0, 3, 1, 2))
    with compute_precision(compute_dtype, img1.device.type):
        logits = model(x1, x2)
    return torch.sigmoid(logits.float()).permute(0, 2, 3, 1)
