"""Photometric augmentation: the CUDA kernels' wrappers and their plain
PyTorch versions.

Replaces the TPU kernels of ``gan_aug_pfa_tpu/ops/pallas_kernels/
photometric.py``: ``photometric_native_chw`` (the native-resolution chain)
and ``photometric_flip_chw`` (the fixed-size chain).  Each takes (B, 3, H, W)
images in [0, 1] and one (B, 8) float32 parameter row an image, applies
torchvision's ColorJitter (brightness, contrast, saturation in one of six
orders, each clipped to [0, 1]) and then a 3x3 separable Gaussian blur with
reflect-101 edges:

  native  rows [b, c, s, order, sigma, h, w, count]: the contrast mean is
          the gray mean over the native (h, w) extent (count = h*w pixels),
          the blur reflects at that extent, values outside it are
          unspecified;
  flip    rows [b, c, s, order, sigma, flip_h, flip_v, 0]: full extent,
          then the horizontal and vertical flips where the row's flag is
          above 0.5.

Unlike the TPU ``photometric_flip_chw``, whose flips run in its NHWC
wrapper, the port's applies them itself: the kernel folds them into its
store index.  ``photometric_native_batch`` and ``photometric_flip_batch``
are the NHWC forms.

The wrappers dispatch on the images' device: CUDA tensors always go to the
kernels (``csrc/photometric.cu``, one launch a call; a failed build, a plan
the card cannot schedule or a refused launch raises), CPU tensors to the
plain versions, which also take float64 images.
``photometric_native_chw.calls`` / ``.launches`` and
``photometric_flip_chw.calls`` / ``.launches`` count the kernels' calls
and launches.

Each launch runs one thread-block cluster per image, each block of the
cluster on a band of the image's rows, the band held in shared memory
(resident) or passed through a ring of rows there (streamed);
``plan_launch`` makes the plan from (B, Hp, Wp) alone, so it holds for
every native extent h <= Hp.

Bound by bytes: 24 bytes a pixel (three float32 channels read and written
once) plus 32 an image, 0.47 us for 4x3x128x128 at 3.35 TB/s.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Tuple

import torch

from . import build

NAME = "photometric"
_LAUNCHES_PER_CALL = 1
THREADS = 512  # a block at most (kMaxThreads in csrc/photometric.cu)
MAX_CLUSTER = 16  # blocks a cluster; above 8 a non-portable size on sm_90
# Resident mode splits an image over up to MAX_SPLIT clusters (kMaxSplit)
# while the card holds them all at once: a resident block of 512 threads
# takes over 100 registers a thread, so one block an SM, and an H100 then
# holds 7 clusters of 16 blocks (cudaOccupancyMaxActiveClusters).
MAX_SPLIT = 4
CLUSTERS_AT_ONCE = 7
# Shared memory a block may take on sm_90 (sharedMemPerBlockOptin), and the
# share of it the plan gives the rows: 1 KB stays for the kernel's static
# shared memory (its barriers and sums, under 200 bytes).
MAX_SHARED_BYTES = 232_448
BAND_LIMIT = MAX_SHARED_BYTES - 1024
# Streamed mode's ring: MIN_SLOTS..MAX_SLOTS rows (kMinSlots, kMaxSlots in
# the source) in about RING_BYTES, so that several blocks share an SM.
MIN_SLOTS, MAX_SLOTS = 4, 8
RING_BYTES = 48 * 1024
# torchvision ColorJitter's six orders: 0 brightness, 1 contrast,
# 2 saturation.
_JITTER_ORDERS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1),
                 (2, 1, 0))


def _check(imgs: torch.Tensor, params: torch.Tensor) -> None:
    for name, t in (("imgs", imgs), ("params", params)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if imgs.dim() != 4 or imgs.shape[1] != 3:
        raise ValueError(f"imgs must be (B, 3, H, W), got {tuple(imgs.shape)}")
    if params.shape != (imgs.shape[0], 8):
        raise ValueError(f"params must be (B, 8) = ({imgs.shape[0]}, 8), got "
                         f"{tuple(params.shape)}")
    if params.dtype != torch.float32:
        raise TypeError(f"params must be float32, got {params.dtype}")
    if imgs.device != params.device:
        raise ValueError(f"device mismatch: imgs on {imgs.device}, params "
                         f"on {params.device}")
    want = ((torch.float32,) if imgs.device.type == "cuda"
            else (torch.float32, torch.float64))
    if imgs.dtype not in want:
        raise TypeError(f"imgs on {imgs.device} must be one of {want}, got "
                        f"{imgs.dtype}")


# -- the plain versions ---------------------------------------------------


def _gray(x: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) -> (B, 1, H, W)."""
    return 0.2989 * x[:, 0:1] + 0.587 * x[:, 1:2] + 0.114 * x[:, 2:3]


def _jitter(x, rows, mask, count):
    """ColorJitter with per-image factors and order from ``rows``; the
    contrast mean is sum(gray * mask) / count (``mask`` None: all pixels)."""
    b = x.shape[0]
    f = rows[:, :3].to(x.dtype).view(b, 3, 1, 1, 1)
    order = rows[:, 3].long().clamp(0, 5)
    ops = torch.tensor(_JITTER_ORDERS, device=x.device)[order]  # (B, 3)
    count = count.to(x.dtype).view(b, 1, 1, 1)
    for pos in range(3):
        g = _gray(x)
        masked = g if mask is None else g * mask
        mean = masked.sum(dim=(2, 3), keepdim=True) / count
        out = (torch.clamp(x * f[:, 0], 0.0, 1.0),
               torch.clamp(mean * (1.0 - f[:, 1]) + x * f[:, 1], 0.0, 1.0),
               torch.clamp(g * (1.0 - f[:, 2]) + x * f[:, 2], 0.0, 1.0))
        op = ops[:, pos].view(b, 1, 1, 1)
        x = torch.where(op == 0, out[0], torch.where(op == 1, out[1], out[2]))
    return x


def _reflect_neighbors(n_buf: int, n: torch.Tensor):
    """(B, n_buf) index tensors (prev, next) of reflect-101 at the dynamic
    extent ``n`` (B,): prev[i] = |i-1|, next[i] = i+1 except at i = n-1,
    where it is prev (the TPU kernel's fix-up)."""
    i = torch.arange(n_buf, device=n.device)
    prev = (i - 1).abs().clamp(max=n_buf - 1).expand(n.shape[0], n_buf)
    nxt = (i + 1).clamp(max=n_buf - 1).expand(n.shape[0], n_buf)
    return prev, torch.where(i == (n - 1)[:, None], prev, nxt)


def take_along(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """x (B, C, H, W) indexed along ``dim`` (2 or 3) by per-image (B, n)
    indices."""
    shape = [x.shape[0], 1, 1, 1]
    shape[dim] = idx.shape[1]
    return x.gather(dim, idx.view(shape).expand(
        *[idx.shape[1] if d == dim else s for d, s in enumerate(x.shape)]))


def _blur(x, sigma, h, w):
    """3x3 separable Gaussian, rows then columns, reflect-101 at (h, w)."""
    b = x.shape[0]
    sigma = sigma.to(x.dtype)
    e = torch.exp(-0.5 / (sigma * sigma))
    s = (e + 1.0) + e
    k_edge = (e / s).view(b, 1, 1, 1)
    k_mid = (1.0 / s).view(b, 1, 1, 1)
    up, dn = _reflect_neighbors(x.shape[2], h)
    x = take_along(x, up, 2) * k_edge + x * k_mid + take_along(x, dn, 2) * k_edge
    lf, rt = _reflect_neighbors(x.shape[3], w)
    return take_along(x, lf, 3) * k_edge + x * k_mid + take_along(x, rt, 3) * k_edge


def photometric_native_reference(imgs: torch.Tensor,
                                 params: torch.Tensor) -> torch.Tensor:
    """Plain version of the native kernel (values outside each extent are
    unspecified here too)."""
    _check(imgs, params)
    hp, wp = imgs.shape[2], imgs.shape[3]
    h = params[:, 5].long().clamp(1, hp)
    w = params[:, 6].long().clamp(1, wp)
    mask = ((torch.arange(hp, device=imgs.device)[:, None] < h[:, None, None])
            & (torch.arange(wp, device=imgs.device) < w[:, None, None]))
    x = _jitter(imgs, params, mask[:, None].to(imgs.dtype), params[:, 7])
    return _blur(x, params[:, 4], h, w)


def photometric_flip_reference(imgs: torch.Tensor,
                               params: torch.Tensor) -> torch.Tensor:
    """Plain version of the flip kernel."""
    _check(imgs, params)
    b, _, h, w = imgs.shape
    hw = torch.tensor([h, w], device=imgs.device).expand(b, 2)
    x = _jitter(imgs, params, None, hw[:, 0] * hw[:, 1])
    x = _blur(x, params[:, 4], hw[:, 0], hw[:, 1])
    flip_h = (params[:, 5] > 0.5).view(b, 1, 1, 1)
    flip_v = (params[:, 6] > 0.5).view(b, 1, 1, 1)
    x = torch.where(flip_h, x.flip(3), x)
    return torch.where(flip_v, x.flip(2), x)


# -- the launch plan -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One launch: ``grid`` = B * ``split`` * ``cluster`` blocks of
    ``threads`` threads, ``split`` clusters an image, block r of each on
    rows ``bands(h)[r]``, whose gray it sums.  ``smem_bytes`` of shared
    memory hold ``slots`` rows of all three channels (16-byte rows).

    resident  the rows a block jitters, blurs and stores (part j of its
              band in the image's cluster j) and 2 halo rows fit: it reads
              them once, and the rest of its band from device memory for
              the sum, where another cluster of the image holds them;
    streamed  the band does not fit (``split`` 1): it passes twice (for the
              mean, then for the rest) through a ring of ``slots`` rows.
    """

    mode: str
    threads: int
    cluster: int
    split: int
    band_rows: int
    slots: int
    smem_bytes: int
    grid: int

    def bands(self, h: int) -> List[Tuple[int, int]]:
        """Row ranges [y0, y1) of the cluster's blocks for an extent of h
        rows, as the kernel splits it (empty ranges at the end)."""
        per = -(-h // self.cluster)
        return [(min(h, r * per), min(h, r * per + per))
                for r in range(self.cluster)]

    def parts(self, y0: int, y1: int) -> List[Tuple[int, int]]:
        """The rows of band [y0, y1) that each of an image's clusters
        jitters, blurs and stores, as the kernel splits them."""
        n = y1 - y0
        return [(y0 + n * j // self.split, y0 + n * (j + 1) // self.split)
                for j in range(self.split)]

    def c_args(self) -> Tuple[int, int, int, int, int, int]:
        """(threads, cluster, split, band_rows, resident, smem_bytes), the C
        entry points' plan arguments."""
        return (self.threads, self.cluster, self.split, self.band_rows,
                int(self.mode == "resident"), self.smem_bytes)


@functools.lru_cache(maxsize=256)
def plan_launch(b: int, hp: int, wp: int) -> LaunchPlan:
    """The plan for (b, 3, hp, wp) images: clusters of min(16, hp) blocks,
    each block on a band of ceil(hp / cluster) rows.  Resident where the
    band and its halo rows fit a block's shared memory, with the most
    clusters an image (up to MAX_SPLIT, at most one a band row) of which
    the card holds all b * split at once.  Else streamed, one cluster an
    image, a thread a float4 group of a row (64 to 512).  Rows too wide for
    a ring of MIN_SLOTS have no plan."""
    if min(b, hp, wp) < 1:
        raise ValueError(f"no plan for {b} images of {hp}x{wp}")
    cluster = min(MAX_CLUSTER, hp)
    band = -(-hp // cluster)
    groups = -(-wp // 4)
    row = 3 * 4 * 4 * groups  # bytes of a shared row, 16-byte aligned
    if (band + 2) * row <= BAND_LIMIT:
        split = max(1, min(MAX_SPLIT, band, CLUSTERS_AT_ONCE // b))
        slots = -(-band // split) + 2
        return LaunchPlan("resident", THREADS, cluster, split, band, slots,
                          slots * row, b * split * cluster)
    slots = max(MIN_SLOTS, min(MAX_SLOTS, RING_BYTES // row))
    if slots * row > BAND_LIMIT:
        raise ValueError(f"no plan for rows of {wp} px: {MIN_SLOTS} rows "
                         f"take more than {BAND_LIMIT} bytes")
    threads = min(THREADS, max(64, 32 * -(-groups // 32)))
    return LaunchPlan("streamed", threads, cluster, 1, band, slots,
                      slots * row, b * cluster)


# -- the kernels ----------------------------------------------------------

_PLAN_ARGTYPES = [ctypes.c_int] * 6


@functools.lru_cache(maxsize=None)
def _kernels():
    """The C entry points (native, flip, active clusters), built and bound
    on first use."""
    lib = build.load(NAME)
    fns = []
    for fn in (lib.photometric_native_f32, lib.photometric_flip_f32):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, *_PLAN_ARGTYPES,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns.append(fn)
    active = lib.photometric_active_clusters
    active.argtypes = [ctypes.c_int] * 4 + _PLAN_ARGTYPES
    active.restype = ctypes.c_int
    return fns[0], fns[1], active


def active_clusters(native: bool, b: int, hp: int, wp: int,
                    plan: LaunchPlan) -> int:
    """How many of the plan's clusters the current card holds at once
    (cudaOccupancyMaxActiveClusters); raises on a CUDA error."""
    n = _kernels()[2](int(native), b, hp, wp, *plan.c_args())
    if n < 0:
        raise RuntimeError(f"{NAME} plan {plan}: CUDA error {-n}")
    return n


def launch(imgs: torch.Tensor, params: torch.Tensor,
           native: bool) -> torch.Tensor:
    """The one launch of a call on checked float32 CUDA tensors."""
    native_fn, flip_fn, _ = _kernels()
    b, _, h, w = imgs.shape
    plan = plan_launch(b, h, w)
    out = torch.empty_like(imgs)
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = (native_fn if native else flip_fn)(
            imgs.data_ptr(), params.data_ptr(), b, h, w, *plan.c_args(),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed ({plan}): CUDA "
                           f"error {err}")
    return out


def _dispatch(counted, reference, imgs, params, native):
    _check(imgs, params)
    if imgs.device.type == "cpu":
        return reference(imgs, params)
    if imgs.device.type != "cuda":
        raise ValueError(f"unsupported device {imgs.device}")
    if imgs.numel() == 0:
        return torch.empty_like(imgs)
    out = launch(imgs, params, native)
    counted.calls += 1
    counted.launches += _LAUNCHES_PER_CALL
    return out


def photometric_native_chw(imgs: torch.Tensor,
                           params: torch.Tensor) -> torch.Tensor:
    """(B, 3, Hp, Wp) padded images + (B, 8) native rows -> jittered and
    blurred images (outside each native extent: unspecified)."""
    return _dispatch(photometric_native_chw, photometric_native_reference,
                     imgs, params, native=True)


def photometric_flip_chw(imgs: torch.Tensor,
                         params: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) images + (B, 8) flip rows -> jittered, blurred and
    flipped images."""
    return _dispatch(photometric_flip_chw, photometric_flip_reference,
                     imgs, params, native=False)


photometric_native_chw.calls = photometric_native_chw.launches = 0
photometric_flip_chw.calls = photometric_flip_chw.launches = 0


def photometric_native_batch(imgs_nhwc: torch.Tensor,
                             params: torch.Tensor) -> torch.Tensor:
    """NHWC form of ``photometric_native_chw``.  An NHWC view of NCHW
    storage reaches the kernel without a copy."""
    chw = imgs_nhwc.permute(0, 3, 1, 2).contiguous()
    return photometric_native_chw(chw, params).permute(0, 2, 3, 1)


def photometric_flip_batch(imgs_nhwc: torch.Tensor,
                           params: torch.Tensor) -> torch.Tensor:
    """NHWC form of ``photometric_flip_chw`` (flips included)."""
    chw = imgs_nhwc.permute(0, 3, 1, 2).contiguous()
    return photometric_flip_chw(chw, params).permute(0, 2, 3, 1)
