"""Pillow's ``Image.resize`` for 8-bit images, in numpy, byte for byte.

The JAX package's single-pair evaluation (pipelines.py:994-1103) resizes
its inputs with Pillow; the card's machine has no PIL, so the port
computes the same bytes here (held against Pillow 12.1.0 in
``tests/test_torch_single_pair.py``):

* ``resize_bicubic_rgb``: ``Image.resize(size, BICUBIC)`` on an RGB image,
  Pillow's ``ImagingResample`` (libImaging/Resample.c): per output
  coordinate, a window of the cubic filter (a = -0.5) widened by the
  downscale factor, its weights normalised in double and turned into
  22-bit fixed point; a horizontal pass over only the rows the vertical
  pass reads, into a uint8-clipped intermediate, then the vertical pass.
  Each pass starts its integer sums at 1 << 21 and shifts by 22.
* ``resize_nearest``: ``Image.resize(size, NEAREST)`` on an L (or any
  8-bit) image, Pillow's affine nearest (libImaging/Geometry.c
  ``ImagingScaleAffine``): the source coordinate of output x starts at
  ``scale / 2`` and grows by ``scale`` per pixel, accumulated in double,
  and is truncated to an index; an index outside the source leaves the
  pixel 0.

Sizes are (width, height), as Pillow takes them.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2
BICUBIC_SUPPORT = 2.0


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's ``bicubic_filter`` with a = -0.5, in double."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _trunc(v: np.ndarray) -> np.ndarray:
    """C's double -> int conversion (toward zero)."""
    return np.trunc(v).astype(np.int64)


def precompute_coeffs(in_size: int, out_size: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for the
    bicubic filter over the whole input: (xmin, count, weights) with
    weights (out_size, ksize) int64 in 22-bit fixed point, 0 past count."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = BICUBIC_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum(_trunc(center - support + 0.5), 0)
    xmax = np.minimum(_trunc(center + support + 0.5), in_size) - xmin
    taps = np.arange(ksize)
    live = taps[None, :] < xmax[:, None]
    w = _bicubic((taps[None, :] + xmin[:, None] - center[:, None] + 0.5)
                 * ss)
    w = np.where(live, w, 0.0)
    # Pillow adds the weights one at a time, in tap order.
    ww = np.zeros(out_size)
    for x in range(ksize):
        ww = ww + w[:, x]
    safe = np.where(ww == 0.0, 1.0, ww)[:, None]
    w = np.where(ww[:, None] != 0.0, w / safe, w)
    fixed = w * (1 << PRECISION_BITS)
    k = np.where(w < 0, _trunc(-0.5 + fixed), _trunc(0.5 + fixed))
    return xmin, xmax, np.where(live, k, 0)


def _clip8(acc: np.ndarray) -> np.ndarray:
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _pass(img: np.ndarray, axis: int, xmin: np.ndarray,
          k: np.ndarray) -> np.ndarray:
    """One resample pass along ``axis`` (0 rows, 1 columns) of an (H, W, C)
    uint8 image: integer sums of taps times fixed-point weights, rounded
    and clipped to uint8."""
    n = img.shape[axis]
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None, :], n - 1)
    src = np.take(img.astype(np.int64), idx, axis=axis)
    if axis == 0:  # (out, taps, W, C)
        acc = np.einsum("otwc,ot->owc", src, k)
    else:  # (H, out, taps, C)
        acc = np.einsum("hotc,ot->hoc", src, k)
    return _clip8(acc + (1 << (PRECISION_BITS - 1)))


def resize_bicubic_rgb(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(img).resize(size, Image.BICUBIC)`` for (H, W, 3)
    uint8 ``img`` and ``size`` = (width, height): (height, width, 3)
    uint8."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize_bicubic_rgb takes (H, W, C) uint8, got "
                         f"{img.dtype} {img.shape}")
    out_w, out_h = size
    in_h, in_w = img.shape[:2]
    if out_w < 1 or out_h < 1:
        raise ValueError(f"bad target size {size}")
    if (in_w, in_h) == (out_w, out_h):
        return img.copy()
    xmin_h, _, k_h = precompute_coeffs(in_w, out_w)
    ymin, ycount, k_v = precompute_coeffs(in_h, out_h)
    if out_w != in_w:
        # Only the rows the vertical pass reads: [first, last).
        first = int(ymin[0])
        last = int(ymin[-1] + ycount[-1])
        img = _pass(img[first:last], 1, xmin_h, k_h)
        ymin = ymin - first
    if out_h != in_h:
        img = _pass(img, 0, ymin, k_v)
    return np.ascontiguousarray(img)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's pretabulated source coordinates: -1 where outside."""
    scale = float(in_size) / out_size
    pos = 0.0 + scale * 0.5
    idx = np.empty(out_size, np.int64)
    for x in range(out_size):
        i = -1 if pos < 0.0 else int(pos)
        idx[x] = i if i < in_size else -1
        pos += scale
    return idx


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(img).resize(size, Image.NEAREST)`` for an (H, W)
    or (H, W, C) uint8 ``img`` and ``size`` = (width, height)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize_nearest takes (H, W) or (H, W, C) uint8, "
                         f"got {img.dtype} {img.shape}")
    out_w, out_h = size
    in_h, in_w = img.shape[:2]
    if out_w < 1 or out_h < 1:
        raise ValueError(f"bad target size {size}")
    if (in_w, in_h) == (out_w, out_h):
        return img.copy()
    xs = _nearest_index(in_w, out_w)
    ys = _nearest_index(in_h, out_h)
    out = img[np.maximum(ys, 0)][:, np.maximum(xs, 0)]
    out[ys < 0] = 0
    out[:, xs < 0] = 0
    return np.ascontiguousarray(out)
