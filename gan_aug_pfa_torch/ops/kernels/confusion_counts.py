"""Per-sample confusion counts: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``gan_aug_pfa_tpu/ops/pallas_kernels/metrics.py:
confusion_counts_batch``: (B, H, W) float32 probabilities and binary
targets -> (B, 4) float32 [tp, fp, fn, tn] at ``p > threshold`` (strict).
The kernel (``csrc/confusion_counts.cu``) counts tp, the predicted
positives and the target positives as int32 in one pass; fp, fn and tn are
derived from them here, as the TPU kernel derives them.

Bound by bytes: it reads 8*B*H*W bytes, 262 KB at the evaluation shape
(B=2, 128x128), about 78 ns at 3.35 TB/s, so a launch costs more than the
work.  The kernel answers with short, deterministic launches: many blocks
per sample, 16-byte loads, int counts reduced by warp shuffles and one
int32 atomic per block and count (see the source's note).

``confusion_counts_batch`` dispatches on the tensors' device: CUDA tensors
always go to the kernel (a failed build or launch raises), CPU tensors to
``confusion_counts_batch_reference``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

NAME = "confusion_counts"
# H*W must stay below 2^24 so that float32 holds the counts exactly.
MAX_PIXELS = 1 << 24
_MAX_GRID_Y = 65535


def _check(probs: torch.Tensor, targets: torch.Tensor) -> None:
    for name, t in (("probs", probs), ("targets", targets)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be (B, H, W), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if probs.shape != targets.shape:
        raise ValueError(f"shape mismatch: probs {tuple(probs.shape)}, "
                         f"targets {tuple(targets.shape)}")
    if probs.device != targets.device:
        raise ValueError(f"device mismatch: probs on {probs.device}, "
                         f"targets on {targets.device}")
    b, h, w = probs.shape
    if h * w >= MAX_PIXELS:
        raise ValueError(f"H*W = {h * w} must be < 2^24 for exact counts")
    if b > _MAX_GRID_Y:
        raise ValueError(f"batch {b} exceeds {_MAX_GRID_Y}")


def _derive(counts: torch.Tensor, hw: int) -> torch.Tensor:
    """(B, 3) int32 [tp, sum p, sum t] -> (B, 4) float32 [tp, fp, fn, tn]."""
    tp, sum_p, sum_t = counts.unbind(1)
    return torch.stack(
        [tp, sum_p - tp, sum_t - tp, hw - sum_p - sum_t + tp], dim=1
    ).to(torch.float32)


def confusion_counts_batch_reference(probs: torch.Tensor,
                                     targets: torch.Tensor,
                                     threshold: float = 0.5) -> torch.Tensor:
    """Plain PyTorch version: the same counts, the same way."""
    _check(probs, targets)
    p = probs > threshold
    t = targets > 0.5
    counts = torch.stack(
        [(p & t).sum(dim=(1, 2)), p.sum(dim=(1, 2)), t.sum(dim=(1, 2))],
        dim=1,
    ).to(torch.int32)
    return _derive(counts, probs.shape[1] * probs.shape[2])


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point, built and bound on first use."""
    fn = build.load(NAME).confusion_counts_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def confusion_counts_batch(probs: torch.Tensor, targets: torch.Tensor,
                           threshold: float = 0.5) -> torch.Tensor:
    """(B, H, W) float32 probs and binary targets -> (B, 4) float32
    [tp, fp, fn, tn].  ``confusion_counts_batch.launches`` counts the
    kernel launches."""
    _check(probs, targets)
    if probs.device.type == "cpu":
        return confusion_counts_batch_reference(probs, targets, threshold)
    if probs.device.type != "cuda":
        raise ValueError(f"unsupported device {probs.device}")
    b, h, w = probs.shape
    counts = torch.zeros((b, 3), dtype=torch.int32, device=probs.device)
    fn = _kernel()
    with torch.cuda.device(probs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(probs.data_ptr(), targets.data_ptr(), float(threshold), b,
                 h * w, counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    if probs.numel():
        confusion_counts_batch.launches += 1
    return _derive(counts, h * w)


confusion_counts_batch.launches = 0
