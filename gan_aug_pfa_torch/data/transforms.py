"""Joint augmentation (own copy of the JAX package's ``data/transforms.py``,
written as batched tensor code: a batch dimension throughout and the
per-sample parameters as (B,) tensors).

The chain, in the reference's order (dataset.py:172-193), with parameters
drawn apart from their application (``sample_augment_params``) so that
both frameworks can apply the same draws:

  1. affine: rotation +-15 deg, translation +-5%, scale 0.95-1.05, x-shear
     +-5 deg, shared by the pair and the label; bilinear images, nearest
     label, 0 outside;
  2. ColorJitter (brightness/contrast/saturation 0.3, one of six orders)
     and 3. a 3x3 Gaussian blur (sigma 0.1-1.0), each image its own draw:
     the photometric kernels (``ops/kernels/photometric.py``);
  4. horizontal and vertical flips, p = 0.5, shared;
  5. rotation +-30 deg, shared, nearest for images and label;
  6. [-1, 1] normalize.

``augment_batch`` runs it on a target-size batch.  ``augment_batch_native``
runs it on padded native-size buffers, each sample in the top-left (h, w)
corner, and resizes to the target size after the rotation (the reference
resizes at step 5); every op there honours the sample's extent.

Public functions take and return NHWC tensors, as the JAX package's do; an
NHWC view of NCHW storage costs no copy, and the chain works in NCHW.
Labels are (B, H, W) of any dtype and come back in it.  Coordinates are
float32 in the JAX package's order of operations, except that cos, sin and
tan are evaluated in float64 and rounded, so that the card and the CPU
compute the same coordinates bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ..ops.kernels.photometric import (
    photometric_flip_chw,
    photometric_native_chw,
    take_along,
)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    degrees: float = 15.0
    translate: float = 0.05
    scale_min: float = 0.95
    scale_max: float = 1.05
    shear: float = 5.0
    jitter: float = 0.3
    blur_sigma_min: float = 0.1
    blur_sigma_max: float = 1.0
    rotation_degrees: float = 30.0
    flip_prob: float = 0.5


def normalize(img: torch.Tensor) -> torch.Tensor:
    """[0,1] -> [-1,1] (reference dataset.py:155-159)."""
    return img * 2.0 - 1.0


def _col(v):
    """(B,) tensor -> (B, 1, 1) for per-sample broadcasting; numbers pass."""
    return v.view(-1, 1, 1) if isinstance(v, torch.Tensor) else v


def _trig(fn, a):
    if not isinstance(a, torch.Tensor):
        return fn(torch.tensor(float(a), dtype=torch.float64)).item()
    return fn(a.double()).to(a.dtype)


# -- sampling -------------------------------------------------------------


def sample_augment_params(generator: torch.Generator, sizes: torch.Tensor,
                          cfg: AugmentConfig = AugmentConfig()
                          ) -> Dict[str, torch.Tensor]:
    """Every random parameter of the chain for each sample, as (B,) tensors
    ((B, 3) for the factors) on ``sizes``' device, drawn from
    ``generator`` (on that device).  ``sizes`` (B, 2) holds each sample's
    native (h, w): translations are rounded and scale with it.  The keys
    and ranges are the JAX package's (transforms.py:251-297)."""
    dev = sizes.device
    b = sizes.shape[0]

    def uniform(lo, hi, shape=(b,)):
        u = torch.rand(shape, generator=generator, device=dev)
        return lo + (hi - lo) * u

    hw = sizes.to(torch.float32)
    max_dy, max_dx = cfg.translate * hw[:, 0], cfg.translate * hw[:, 1]
    lo = max(0.0, 1.0 - cfg.jitter)

    def jitter():
        return (uniform(lo, 1.0 + cfg.jitter, (b, 3)),
                torch.randint(0, 6, (b,), generator=generator, device=dev))

    factors1, order1 = jitter()
    factors2, order2 = jitter()
    return {
        "angle": uniform(-cfg.degrees, cfg.degrees),
        "tx": torch.round(uniform(-max_dx, max_dx)),
        "ty": torch.round(uniform(-max_dy, max_dy)),
        "scale": uniform(cfg.scale_min, cfg.scale_max),
        "shear": uniform(-cfg.shear, cfg.shear),
        "factors1": factors1,
        "order1": order1,
        "factors2": factors2,
        "order2": order2,
        "sigma1": uniform(cfg.blur_sigma_min, cfg.blur_sigma_max),
        "sigma2": uniform(cfg.blur_sigma_min, cfg.blur_sigma_max),
        "do_h": uniform(0.0, 1.0) < cfg.flip_prob,
        "do_v": uniform(0.0, 1.0) < cfg.flip_prob,
        "rot": uniform(-cfg.rotation_degrees, cfg.rotation_degrees),
    }


# -- geometric warps (inverse-mapped, constant-0 fill) --------------------


def _inverse_affine_coords(h: int, w: int, angle_deg, translate_xy, scale,
                           shear_x_deg, hw=None):
    """Output-pixel -> input-pixel coordinates of the torchvision affine
    (rotation + x-shear + scale about the centre, then translation) on an
    (h, w) buffer: (ys, xs), each (B, h, w).  Parameters are (B,) tensors
    or numbers; ``hw`` = (h, w) (B,) integer tensors puts the centre in
    each sample's native extent."""
    a = angle_deg * (math.pi / 180.0)
    sx = shear_x_deg * (math.pi / 180.0)
    ch, cw = (_col(hw[0]), _col(hw[1])) if hw is not None else (h, w)
    cx, cy = (cw - 1) * 0.5, (ch - 1) * 0.5
    cos_a, sin_a = _col(_trig(torch.cos, a)), _col(_trig(torch.sin, a))
    tan_sx = _col(_trig(torch.tan, sx))
    scale = _col(scale)
    m00 = scale * cos_a
    m01 = scale * (cos_a * tan_sx - sin_a)
    m10 = scale * sin_a
    m11 = scale * (sin_a * tan_sx + cos_a)
    tx, ty = _col(translate_xy[0]), _col(translate_xy[1])
    det = m00 * m11 - m01 * m10
    i00, i01 = m11 / det, -m01 / det
    i10, i11 = -m10 / det, m00 / det
    dev = angle_deg.device
    yy = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)
    dx = xx - cx - tx
    dy = yy - cy - ty
    xs = i00 * dx + i01 * dy + cx
    ys = i10 * dx + i11 * dy + cy
    return ys, xs


def _gather(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """img (B, C, Hs, Ws) at flat pixel indices idx (B, H, W) -> (B, C, H, W)."""
    b, c = img.shape[:2]
    flat = idx.reshape(b, 1, -1).expand(b, c, -1)
    return img.reshape(b, c, -1).gather(2, flat).view(b, c, *idx.shape[1:])


def _bilinear_taps(ys, xs, h, w, row: int):
    """Corner indices, weights and validity of a bilinear sample at (ys, xs)
    from an (h, w) extent of a buffer with ``row`` pixels a row.  Valid is
    inclusive at h-1 and w-1 (transforms.py:100-126)."""
    valid = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    ysc = torch.minimum(ys.clamp(min=0.0), torch.as_tensor(h - 1).to(ys))
    xsc = torch.minimum(xs.clamp(min=0.0), torch.as_tensor(w - 1).to(xs))
    y0, x0 = torch.floor(ysc).long(), torch.floor(xsc).long()
    y1 = torch.minimum(y0 + 1, torch.as_tensor(h - 1, device=y0.device))
    x1 = torch.minimum(x0 + 1, torch.as_tensor(w - 1, device=x0.device))
    wy = (ysc - y0.to(ysc.dtype))[:, None]
    wx = (xsc - x0.to(xsc.dtype))[:, None]
    return ((y0 * row + x0, y0 * row + x1, y1 * row + x0, y1 * row + x1),
            wy, wx, valid[:, None])


def _sample_bilinear(img: torch.Tensor, taps) -> torch.Tensor:
    (i00, i01, i10, i11), wy, wx, valid = taps
    out = (_gather(img, i00) * (1 - wy) * (1 - wx)
           + _gather(img, i01) * (1 - wy) * wx
           + _gather(img, i10) * wy * (1 - wx)
           + _gather(img, i11) * wy * wx)
    return torch.where(valid, out, 0.0)


def _nearest_taps(ys, xs, h, w, row: int):
    """Index and validity of a nearest sample: round half to even (as
    jnp.round), valid in [-0.5, n-0.5) (transforms.py:129-139)."""
    valid = (ys >= -0.5) & (ys < h - 0.5) & (xs >= -0.5) & (xs < w - 0.5)
    yi = torch.minimum(torch.round(ys).long().clamp(min=0),
                       torch.as_tensor(h - 1, device=ys.device))
    xi = torch.minimum(torch.round(xs).long().clamp(min=0),
                       torch.as_tensor(w - 1, device=xs.device))
    return yi * row + xi, valid[:, None]


def _sample_nearest(img: torch.Tensor, taps) -> torch.Tensor:
    idx, valid = taps
    return torch.where(valid, _gather(img, idx), 0.0)


def _flip_indices(n_buf: int, n: torch.Tensor, do_flip) -> torch.Tensor:
    """(B, n_buf) indices flipping the first n (B,) entries where do_flip."""
    i = torch.arange(n_buf, device=do_flip.device)
    n = n.view(-1, 1)
    flipped = torch.where(i < n, n - 1 - i, i).clamp(0, n_buf - 1)
    return torch.where(do_flip[:, None], flipped, i)


def _apply_flips_dyn(x: torch.Tensor, do_h, do_v, h, w) -> torch.Tensor:
    """H/V flips within each sample's (h, w) extent of (B, C, Hp, Wp)."""
    b, c, hp, wp = x.shape
    xi = _flip_indices(wp, w, do_h)
    x = x.gather(3, xi.view(b, 1, 1, wp).expand(b, c, hp, wp))
    yi = _flip_indices(hp, h, do_v)
    return x.gather(2, yi.view(b, 1, hp, 1).expand(b, c, hp, wp))


# -- native -> target resize ----------------------------------------------


def _bilinear_coeffs(n: torch.Tensor, out_n: int):
    """lo, hi (B, out_n) and the weight t of the align_corners=False resize
    from n (B,) to out_n.  src = (q - out_n) / (2 out_n) with q = (2i+1) n:
    floor and remainder in exact integer arithmetic, so lo and hi equal the
    host cache's float64 coordinates even where n/out_n is not a float32
    (290 -> 96, say); t pays one float32 rounding (transforms.py:563-587)."""
    n = n.long().view(-1, 1)
    i = torch.arange(out_n, device=n.device)
    num = (2 * i + 1) * n - out_n
    den = 2 * out_n
    lo = torch.div(num, den, rounding_mode="floor")
    t = (num - lo * den).to(torch.float32) / den
    t = torch.where((lo < 0) | (lo >= n - 1), 0.0, t)
    lo = torch.minimum(lo.clamp(min=0), n - 1)
    hi = torch.minimum(lo + 1, n - 1)
    return lo, hi, t


def _resize_bilinear(x: torch.Tensor, h, w, out_size) -> torch.Tensor:
    """(B, C, Hp, Wp) with extents (h, w) -> (B, C, *out_size)."""
    lo, hi, t = _bilinear_coeffs(h, out_size[0])
    t = t[:, None, :, None]
    x = take_along(x, lo, 2) * (1 - t) + take_along(x, hi, 2) * t
    lo, hi, t = _bilinear_coeffs(w, out_size[1])
    t = t[:, None, None, :]
    return take_along(x, lo, 3) * (1 - t) + take_along(x, hi, 3) * t


def _nearest_index(n: torch.Tensor, out_n: int) -> torch.Tensor:
    """Legacy-nearest source indices floor(i * n / out_n), multiplied first
    (exact in float32 below 2^24, transforms.py:597-606)."""
    n = n.view(-1, 1)
    i = torch.arange(out_n, dtype=torch.float32, device=n.device)
    idx = torch.floor((i * n) / out_n).long()
    return torch.minimum(idx, n.long() - 1)


def _resize_nearest(x: torch.Tensor, h, w, out_size) -> torch.Tensor:
    x = take_along(x, _nearest_index(h, out_size[0]), 2)
    return take_along(x, _nearest_index(w, out_size[1]), 3)


def resize_from_native_bilinear(img: torch.Tensor, h: torch.Tensor,
                                w: torch.Tensor, out_size) -> torch.Tensor:
    """Bilinear align_corners=False resize of each (B, Hp, Wp, C) sample's
    (h, w) corner to out_size (the device twin of the cache's host
    resize).  Returns NHWC."""
    x = _resize_bilinear(img.permute(0, 3, 1, 2), h, w, out_size)
    return x.permute(0, 2, 3, 1)


def resize_from_native_nearest(label: torch.Tensor, h: torch.Tensor,
                               w: torch.Tensor, out_size) -> torch.Tensor:
    """Legacy-nearest resize of each (B, Hp, Wp) label's (h, w) corner."""
    return _resize_nearest(label[:, None], h, w, out_size)[:, 0]


# -- the chains -------------------------------------------------------------


def _pack_flip_rows(factors, order, sigma, do_h, do_v) -> torch.Tensor:
    """(B, 8) float32 rows [b, c, s, order, sigma, flip_h, flip_v, 0]."""
    f32 = torch.float32
    return torch.cat([factors.to(f32), order.to(f32)[:, None],
                      sigma.to(f32)[:, None], do_h.to(f32)[:, None],
                      do_v.to(f32)[:, None],
                      torch.zeros_like(sigma, dtype=f32)[:, None]], dim=1)


def _pack_native_rows(factors, order, sigma, sizes) -> torch.Tensor:
    """(B, 8) float32 rows [b, c, s, order, sigma, h, w, h*w]."""
    f32 = torch.float32
    count = (sizes[:, 0] * sizes[:, 1]).to(f32)[:, None]
    return torch.cat([factors.to(f32), order.to(f32)[:, None],
                      sigma.to(f32)[:, None], sizes.to(f32), count], dim=1)


def _labels_in(labels, like):
    return None if labels is None else labels[:, None].to(like.dtype)


def _labels_out(lab, labels):
    return None if labels is None else lab[:, 0].to(labels.dtype)


def augment_batch(img1: torch.Tensor, img2: torch.Tensor,
                  labels: Optional[torch.Tensor], p: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             Optional[torch.Tensor]]:
    """The chain on a target-size batch: (B, H, W, 3) images in [0, 1] and
    (B, H, W) labels (or None), with the parameters ``p`` of
    ``sample_augment_params``.  Returns images in [-1, 1] and labels."""
    x1, x2 = img1.permute(0, 3, 1, 2), img2.permute(0, 3, 1, 2)
    lab = _labels_in(labels, x1)
    _, _, h, w = x1.shape
    # 1. shared affine.
    ys, xs = _inverse_affine_coords(h, w, p["angle"], (p["tx"], p["ty"]),
                                    p["scale"], p["shear"])
    taps = _bilinear_taps(ys, xs, h, w, w)
    x1, x2 = _sample_bilinear(x1, taps), _sample_bilinear(x2, taps)
    if lab is not None:
        lab = _sample_nearest(lab, _nearest_taps(ys, xs, h, w, w))
    # 2-4. jitter + blur per image, shared flips (in the kernel's store).
    x1 = photometric_flip_chw(x1, _pack_flip_rows(
        p["factors1"], p["order1"], p["sigma1"], p["do_h"], p["do_v"]))
    x2 = photometric_flip_chw(x2, _pack_flip_rows(
        p["factors2"], p["order2"], p["sigma2"], p["do_h"], p["do_v"]))
    if lab is not None:
        b = lab.shape[0]
        lab = torch.where(p["do_h"].view(b, 1, 1, 1), lab.flip(3), lab)
        lab = torch.where(p["do_v"].view(b, 1, 1, 1), lab.flip(2), lab)
    # 5. shared rotation, nearest for all three; 6. normalize.
    zero = torch.zeros_like(p["rot"])
    ys, xs = _inverse_affine_coords(h, w, p["rot"], (zero, zero), 1.0, 0.0)
    taps = _nearest_taps(ys, xs, h, w, w)
    x1, x2 = _sample_nearest(x1, taps), _sample_nearest(x2, taps)
    if lab is not None:
        lab = _sample_nearest(lab, taps)
    return (normalize(x1).permute(0, 2, 3, 1),
            normalize(x2).permute(0, 2, 3, 1), _labels_out(lab, labels))


def augment_batch_native(img1: torch.Tensor, img2: torch.Tensor,
                         labels: Optional[torch.Tensor], sizes: torch.Tensor,
                         out_size: Tuple[int, int],
                         p: Dict[str, torch.Tensor]
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    Optional[torch.Tensor]]:
    """The chain on padded native-size buffers: (B, Hp, Wp, 3) images,
    (B, Hp, Wp) labels (or None), (B, 2) native sizes -> target-size
    (B, *out_size, 3) images in [-1, 1] and labels."""
    x1, x2 = img1.permute(0, 3, 1, 2), img2.permute(0, 3, 1, 2)
    lab = _labels_in(labels, x1)
    _, _, hp, wp = x1.shape
    h, w = sizes[:, 0].long(), sizes[:, 1].long()
    ext = (_col(h), _col(w))
    # 1. shared affine at native extent.
    ys, xs = _inverse_affine_coords(hp, wp, p["angle"], (p["tx"], p["ty"]),
                                    p["scale"], p["shear"], hw=(h, w))
    taps = _bilinear_taps(ys, xs, *ext, wp)
    x1, x2 = _sample_bilinear(x1, taps), _sample_bilinear(x2, taps)
    if lab is not None:
        lab = _sample_nearest(lab, _nearest_taps(ys, xs, *ext, wp))
    # 2-3. masked jitter + dynamic-extent blur per image.
    x1 = photometric_native_chw(x1, _pack_native_rows(
        p["factors1"], p["order1"], p["sigma1"], sizes))
    x2 = photometric_native_chw(x2, _pack_native_rows(
        p["factors2"], p["order2"], p["sigma2"], sizes))
    # 4. shared flips within the extent.
    x1 = _apply_flips_dyn(x1, p["do_h"], p["do_v"], h, w)
    x2 = _apply_flips_dyn(x2, p["do_h"], p["do_v"], h, w)
    if lab is not None:
        lab = _apply_flips_dyn(lab, p["do_h"], p["do_v"], h, w)
    # 5a. shared rotation at native extent, nearest for all three.
    zero = torch.zeros_like(p["rot"])
    ys, xs = _inverse_affine_coords(hp, wp, p["rot"], (zero, zero), 1.0, 0.0,
                                    hw=(h, w))
    taps = _nearest_taps(ys, xs, *ext, wp)
    x1, x2 = _sample_nearest(x1, taps), _sample_nearest(x2, taps)
    # 5b. resize to target; 6. normalize.
    x1 = _resize_bilinear(x1, h, w, out_size)
    x2 = _resize_bilinear(x2, h, w, out_size)
    if lab is not None:
        lab = _resize_nearest(_sample_nearest(lab, taps), h, w, out_size)
    return (normalize(x1).permute(0, 2, 3, 1),
            normalize(x2).permute(0, 2, 3, 1), _labels_out(lab, labels))
