"""Host-side decode and one-time resize into a fixed-size cache (own copy
of the JAX package's ``data/loader.py`` numerics).

Each PNG is decoded once (``data/native_loader.py``: the C unfilter) and
resized on the host with the reference's numerics: bilinear,
align_corners=False, coefficients in float64 and the lerp in float32 for
images after /255; legacy nearest for labels, which are binarized at >128
before the resize (reference dataset.py:31-33 then 146).  The pipeline
moves the cache to the device once.  For native-resolution augmentation,
``build_padded_native_dataset`` keeps each sample at its decoded size in a
zero-padded buffer instead.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from . import native_loader
from .scanner import Sample


def _resize_bilinear_np(x: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear align_corners=False resize on host (float32 HWC)."""

    def coeffs(in_size, out_size):
        scale = in_size / out_size
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
        src = np.clip(src, 0, in_size - 1)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, in_size - 1)
        w = (src - lo).astype(np.float32)
        return lo, hi, w

    for axis, out_size in ((0, size[0]), (1, size[1])):
        if x.shape[axis] == out_size:
            continue
        lo, hi, w = coeffs(x.shape[axis], out_size)
        x_lo = np.take(x, lo, axis=axis)
        x_hi = np.take(x, hi, axis=axis)
        shape = [1, 1, 1]
        shape[axis] = out_size
        wb = w.reshape(shape)
        x = x_lo * (1 - wb) + x_hi * wb
    return x


def _resize_nearest_np(x: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Legacy-nearest resize on host (HW arrays)."""
    for axis, out_size in ((0, size[0]), (1, size[1])):
        if x.shape[axis] == out_size:
            continue
        idx = np.floor(
            np.arange(out_size, dtype=np.float64) * x.shape[axis] / out_size
        ).astype(np.int64)
        idx = np.minimum(idx, x.shape[axis] - 1)
        x = np.take(x, idx, axis=axis)
    return x


def load_sample_arrays(
    sample: Sample, target_size: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Decode one triplet and resize it to the target size.

    Returns (img1, img2, label): float32 HWC in [0,1] for images, int32 HW
    in {0,1} for the label.
    """
    img1 = native_loader.decode_rgb(sample.img1).astype(np.float32) / 255.0
    img2 = native_loader.decode_rgb(sample.img2).astype(np.float32) / 255.0
    img1 = _resize_bilinear_np(img1, target_size)
    img2 = _resize_bilinear_np(img2, target_size)
    label = None
    if sample.label is not None:
        label = (native_loader.decode_gray(sample.label) > 128).astype(
            np.int32)
        label = _resize_nearest_np(label, target_size)
    return img1, img2, label


@dataclasses.dataclass
class CachedDataset:
    """A fully decoded, fixed-size dataset (host arrays)."""

    img1: np.ndarray  # (N, H, W, 3) float32 in [0, 1]
    img2: np.ndarray  # (N, H, W, 3) float32 in [0, 1]
    labels: Optional[np.ndarray]  # (N, H, W) int32 in {0, 1}, or None
    cities: List[str]

    def __len__(self) -> int:
        return self.img1.shape[0]


def build_cached_dataset(
    samples: List[Sample], target_size: Tuple[int, int], verbose: bool = True
) -> CachedDataset:
    """Decode and resize every sample once; skip unreadable ones with a
    warning (the reference's None-sample skipping, dataset.py:235-237)."""
    img1s, img2s, labels, cities = [], [], [], []
    has_labels = all(s.label is not None for s in samples)

    def load_one(s):
        try:
            return load_sample_arrays(s, target_size)
        except Exception as e:  # noqa: BLE001 — parity with reference skip
            print(f"Failed to load sample for city {s.city}: {e}. Skipping.")
            return None

    # The decoder is built (or its build error raised) here, not skipped
    # per sample; zlib, the C unfilter and numpy release the GIL for most
    # of each decode.
    native_loader.get_lib()
    with ThreadPoolExecutor(max_workers=min(8, max(1, len(samples)))) as ex:
        results = list(ex.map(load_one, samples))
    for s, res in zip(samples, results):
        if res is None:
            continue
        i1, i2, lb = res
        img1s.append(i1)
        img2s.append(i2)
        if has_labels:
            labels.append(lb)
        cities.append(s.city)
    if not img1s:
        return CachedDataset(
            np.zeros((0, *target_size, 3), np.float32),
            np.zeros((0, *target_size, 3), np.float32),
            np.zeros((0, *target_size), np.int32) if has_labels else None,
            [],
        )
    ds = CachedDataset(
        np.stack(img1s),
        np.stack(img2s),
        np.stack(labels) if has_labels else None,
        cities,
    )
    if verbose:
        print(
            f"Cached {len(ds)} samples at {target_size[0]}x{target_size[1]} "
            f"({ds.img1.nbytes * 2 / 1e6:.1f} MB of image data)."
        )
    return ds


@dataclasses.dataclass
class PaddedNativeDataset:
    """A native-resolution dataset: each sample decoded at its original
    size into the top-left corner of a zero-padded (Hmax, Wmax) buffer,
    with its true size.  Feeds the native-resolution augmentation chain
    (``data/transforms.augment_batch_native``)."""

    img1: np.ndarray  # (N, Hmax, Wmax, 3) float32 in [0, 1], zero-padded
    img2: np.ndarray  # (N, Hmax, Wmax, 3)
    labels: Optional[np.ndarray]  # (N, Hmax, Wmax) int32 in {0, 1}
    sizes: np.ndarray  # (N, 2) int32 native (h, w)
    cities: List[str]

    def __len__(self) -> int:
        return self.img1.shape[0]


def _load_native(s: Sample):
    """One triplet at native size.  img2 and the label are brought to
    img1's extent when they differ, with a printed warning each."""
    i1 = native_loader.decode_rgb(s.img1).astype(np.float32) / 255.0
    i2 = native_loader.decode_rgb(s.img2).astype(np.float32) / 255.0
    if i1.shape != i2.shape:
        # Joint augmentation needs one canvas per pair: keep the pair and
        # resize img2 with the cache's bilinear resize.
        print(f"img1/img2 native sizes differ for {s.city} ({i1.shape} vs "
              f"{i2.shape}); resizing img2 to img1's extent for "
              "native-resolution augmentation.")
        i2 = _resize_bilinear_np(i2, (i1.shape[0], i1.shape[1]))
    lb = None
    if s.label is not None:
        lb = (native_loader.decode_gray(s.label) > 128).astype(np.int32)
        if lb.shape != i1.shape[:2]:
            print(f"label native size differs for {s.city} ({lb.shape} vs "
                  f"{i1.shape[:2]}); nearest-resizing the label to img1's "
                  "extent.")
            lb = _resize_nearest_np(lb, (i1.shape[0], i1.shape[1]))
    return i1, i2, lb


def build_padded_native_dataset(
    samples: List[Sample], pad_multiple: int = 8, verbose: bool = True
) -> PaddedNativeDataset:
    """Decode every sample once at native size into a padded dense cache
    whose extent is the largest native one rounded up to ``pad_multiple``.
    Unreadable samples are skipped with a warning, as in
    ``build_cached_dataset``."""

    def load_one(s):
        try:
            return _load_native(s)
        except Exception as e:  # noqa: BLE001 — parity with reference skip
            print(f"Failed to load sample for city {s.city}: {e}. Skipping.")
            return None

    native_loader.get_lib()
    with ThreadPoolExecutor(max_workers=min(8, max(1, len(samples)))) as ex:
        results = list(ex.map(load_one, samples))
    loaded = [(s, r) for s, r in zip(samples, results) if r is not None]
    if not loaded:
        return PaddedNativeDataset(
            np.zeros((0, 0, 0, 3), np.float32),
            np.zeros((0, 0, 0, 3), np.float32),
            None, np.zeros((0, 2), np.int32), [],
        )
    has_labels = all(r[2] is not None for _, r in loaded)

    def up(n):
        return -(-n // pad_multiple) * pad_multiple

    hmax = up(max(r[0].shape[0] for _, r in loaded))
    wmax = up(max(r[0].shape[1] for _, r in loaded))
    n = len(loaded)
    img1 = np.zeros((n, hmax, wmax, 3), np.float32)
    img2 = np.zeros((n, hmax, wmax, 3), np.float32)
    labels = np.zeros((n, hmax, wmax), np.int32) if has_labels else None
    sizes = np.zeros((n, 2), np.int32)
    for i, (_, (i1, i2, lb)) in enumerate(loaded):
        h, w = i1.shape[:2]
        img1[i, :h, :w] = i1
        img2[i, :h, :w] = i2
        if has_labels:
            labels[i, :h, :w] = lb
        sizes[i] = (h, w)
    ds = PaddedNativeDataset(img1, img2, labels, sizes,
                             [s.city for s, _ in loaded])
    if verbose:
        print(f"Cached {n} samples at native size (padded to {hmax}x{wmax}, "
              f"{img1.nbytes * 2 / 1e6:.1f} MB of image data).")
    return ds


def float_to_uint8(x: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8 with truncation, as torchvision
    ``to_pil_image``'s ``mul(255).byte()`` (reference
    generate_synthetic_data.py:83-85; the JAX package's
    data/loader.py:270-274)."""
    return (np.clip(x, 0.0, 1.0) * 255.0).astype(np.uint8)
