"""Evaluation metrics (reference evaluate.py:34-64).

Threshold the probabilities, count tp/fp/fn/tn, then, in float32,

  precision = (tp + s) / (tp + fp + s)
  recall    = (tp + s) / (tp + fn + s)
  f1        = (2 P R + s) / (P + R + s)        (from the smoothed P, R)
  iou       = (tp + s) / (tp + fp + fn + s)
  accuracy  = (tp + tn + s) / (tp + tn + fp + fn + s)

with s = 1e-6, in the JAX package's order of operations (metrics.py:44-57).
``per_sample_metrics`` takes its counts from the confusion-counts kernel.
"""

from __future__ import annotations

from typing import Dict

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
