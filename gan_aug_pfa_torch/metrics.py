"""Evaluation metrics (reference evaluate.py:34-64).

Threshold the probabilities, count tp/fp/fn/tn, then, in float32,

  precision = (tp + s) / (tp + fp + s)
  recall    = (tp + s) / (tp + fn + s)
  f1        = (2 P R + s) / (P + R + s)        (from the smoothed P, R)
  iou       = (tp + s) / (tp + fp + fn + s)
  accuracy  = (tp + tn + s) / (tp + tn + fp + fn + s)

with s = 1e-6, in the JAX package's order of operations (metrics.py:44-57).
``per_sample_metrics`` and ``per_sample_metrics_sweep`` take their counts
from the confusion-counts kernel; ``calculate_metrics`` (whole input, the
single-pair evaluation) from the kernel where the targets are binary.

Every threshold is compared in float32, as JAX compares its float32
threshold grid: the kernel takes a C float, and the plain version's
``probs > threshold`` compares a float32 tensor with a Python scalar in
float32.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .ops.kernels.confusion_counts import confusion_counts_batch

METRIC_KEYS = ("accuracy", "precision", "recall", "f1", "iou")


def confusion_counts(preds: torch.Tensor, targets: torch.Tensor,
                     threshold: float = 0.5):
    """tp/fp/fn/tn over the whole input from probability maps and {0,1}
    targets (plain torch)."""
    p = (preds.float() > threshold).float().reshape(-1)
    t = targets.float().reshape(-1)
    tp = torch.sum(p * t)
    fp = torch.sum((1.0 - t) * p)
    fn = torch.sum(t * (1.0 - p))
    tn = torch.sum((1.0 - t) * (1.0 - p))
    return tp, fp, fn, tn


def metrics_from_counts(tp, fp, fn, tn, smooth: float = 1e-6
                        ) -> Dict[str, torch.Tensor]:
    precision = (tp + smooth) / (tp + fp + smooth)
    recall = (tp + smooth) / (tp + fn + smooth)
    f1 = (2.0 * precision * recall + smooth) / (precision + recall + smooth)
    iou = (tp + smooth) / (tp + fp + fn + smooth)
    accuracy = (tp + tn + smooth) / (tp + tn + fp + fn + smooth)
    return {
        "accuracy": accuracy,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "iou": iou,
    }


def per_sample_metrics(preds: torch.Tensor, targets: torch.Tensor,
                       threshold: float = 0.5) -> Dict[str, torch.Tensor]:
    """Per-sample metrics over a batch of (B, H, W) float32 maps; each
    metric is a (B,) vector, for the reference's per-sample
    macro-averaging (evaluate.py:159-173)."""
    c = confusion_counts_batch(preds, targets, threshold)
    return metrics_from_counts(c[:, 0], c[:, 1], c[:, 2], c[:, 3])


def calculate_metrics(preds: torch.Tensor, targets: torch.Tensor,
                      smooth: float = 1e-6, threshold: float = 0.5
                      ) -> Dict[str, torch.Tensor]:
    """Metrics over the whole (flattened) input (reference
    evaluate.py:34-64, JAX metrics.py:60-67); each metric is a 0-d tensor.

    JAX multiplies the thresholded map with the targets as they are,
    fractional values included (a gray label divided by 255 is not
    binarised).  The confusion-counts kernel binarises targets at 0.5, so
    it serves only targets that hold 0 and 1 alone, where the two agree
    exactly; any other targets take the plain float sums of products
    (``confusion_counts``), as JAX computes them."""
    targets = targets.to(preds.device, torch.float32)
    if bool(((targets == 0) | (targets == 1)).all()):
        c = confusion_counts_batch(
            preds.float().reshape(1, 1, -1).contiguous(),
            targets.reshape(1, 1, -1).contiguous(), threshold)[0]
        tp, fp, fn, tn = c.unbind()
    else:
        tp, fp, fn, tn = confusion_counts(preds, targets, threshold)
    return metrics_from_counts(tp, fp, fn, tn, smooth)


def sweep_thresholds() -> np.ndarray:
    """The operating-point grid of ``--threshold-sweep``: 0.05, 0.10, ...,
    0.95 (JAX pipelines.py:862-865)."""
    return np.round(np.arange(0.05, 0.951, 0.05), 2)


def confusion_counts_sweep(preds: torch.Tensor, targets: torch.Tensor,
                           thresholds: Sequence[float]) -> torch.Tensor:
    """(T, B, 4) float32 [tp, fp, fn, tn] of (B, H, W) maps at each of T
    thresholds: one confusion-counts call a threshold."""
    return torch.stack([confusion_counts_batch(preds, targets, float(t))
                        for t in thresholds])


def per_sample_metrics_sweep(preds: torch.Tensor, targets: torch.Tensor,
                             thresholds: Sequence[float]
                             ) -> Dict[str, torch.Tensor]:
    """``per_sample_metrics`` over a threshold grid (JAX metrics.py:82-92):
    each metric a (T, B) tensor, from one ``metrics_from_counts`` over the
    stacked counts."""
    c = confusion_counts_sweep(preds, targets, thresholds)
    return metrics_from_counts(c[..., 0], c[..., 1], c[..., 2], c[..., 3])
