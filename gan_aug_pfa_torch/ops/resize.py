"""The decoder's 2x upsample (the JAX package's ``ops/resize.py``:
``_linear_coeffs``, ``_upsample_matrix`` and ``upsample2x_align_corners``,
``:27-48`` and ``:103-138``), on NCHW.

The upsample is two small dense products, one for each spatial axis, with
the JAX package's (2h, h) align-corners interpolation matrix: float32
weights, cast to the input's dtype at the call (float64 under float64, so
the weights stay the JAX package's float32 ones), H first, then W.  Its
backward is the two transposed products: no scatter, no atomics, and a
deterministic CUDA algorithm (cuBLAS) where the gather-lerp form's backward
(``upsample_bilinear2d_backward``) has none.  Under autocast the products
take autocast's matmul dtype (bf16 in, bf16 out), as JAX's bf16 einsum.

The matrices are plain tensors, neither parameters nor buffers: the
``state_dict`` keeps the reference's keys, and ``torch.export`` takes a
matrix as a lifted constant of the program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils._python_dispatch import _disable_current_modes


def _linear_coeffs(in_size: int, out_size: int):
    """Source indices and float32 weights for 1-D align-corners linear
    interpolation to ``out_size`` >= 2: src = i * (in-1)/(out-1) in
    float64."""
    src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (
        out_size - 1)
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int32)
    hi = np.minimum(lo + 1, in_size - 1).astype(np.int32)
    w = (src - lo).astype(np.float32)
    return lo, hi, w


@functools.lru_cache(maxsize=None)
def _upsample_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out, in) float32 interpolation matrix for align-corners
    linear upsampling: two nonzeros a row, the lerp weights."""
    lo, hi, w = _linear_coeffs(in_size, out_size)
    m = np.zeros((out_size, in_size), np.float32)
    np.add.at(m, (np.arange(out_size), lo), 1.0 - w)
    np.add.at(m, (np.arange(out_size), hi), w)
    return m


_MATRICES: dict = {}


def upsample_matrix(h: int, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """``_upsample_matrix(h, 2h)`` as a ``dtype`` tensor on ``device``,
    made once for each (h, dtype, device).  It is made outside any
    dispatch mode, so a first call inside ``torch.export``'s trace keeps a
    real tensor (the program's lifted constant), not a fake one, and
    outside inference mode, so that a backward may save it."""
    key = (h, dtype, device)
    m = _MATRICES.get(key)
    if m is None:
        with _disable_current_modes(), torch.inference_mode(False):
            m = torch.from_numpy(_upsample_matrix(h, 2 * h)).to(device, dtype)
        _MATRICES[key] = m
    return m


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample with align_corners=True of the (H, W) axes of
    an NCHW tensor (reference models.py:64): ``mh @ x`` over H, then
    ``@ mw.T`` over W."""
    if torch.compiler.is_exporting():
        # A program views the products' input as its trace laid it out;
        # on the card the input may come in another layout (channels-last,
        # after a cat of NHWC views), so the program copies it first.
        x = x.clone(memory_format=torch.contiguous_format)
    mh = upsample_matrix(x.shape[-2], x.dtype, x.device)
    mw = upsample_matrix(x.shape[-1], x.dtype, x.device)
    return torch.matmul(torch.matmul(mh, x), mw.t())
