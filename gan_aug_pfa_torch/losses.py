"""Segmentation losses (own copy of the JAX package's ``losses.py``, the
reference's train.py:34-128), with the same formulas:

  dice       = 1 - (2*sum(p*t) + s) / (sum(p) + sum(t) + s), global flatten
  focal      = mean(alpha_t * (1-pt)^gamma * bce),  pt = exp(-bce)
  combined   = a * BCEWithLogits(pos_weight) + (1-a) * dice
  focal_dice = b * focal + (1-b) * dice

  gan_bce    = BCEWithLogits against an all-ones / all-zeros patch map
  l1         = mean |x - y|

(the GAN losses of a data-parallel shard: its part of the global mean).

Everything upcasts to float32.  ``focal_dice_loss`` here is the composite
the reference computes; training calls the fused kernel's wrapper
(``ops/kernels/fused_loss.py``), which computes the same function.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _flatten_pair(logits: torch.Tensor, targets: torch.Tensor):
    return (logits.to(torch.float32).reshape(-1),
            targets.to(torch.float32).reshape(-1))


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    pos_weight: Optional[float] = None,
                    reduction: str = "mean") -> torch.Tensor:
    """Stable BCE-with-logits with an optional weight on the positive term:
    -(pw * t * log(sigmoid(x)) + (1 - t) * log(1 - sigmoid(x)))."""
    x = logits.to(torch.float32)
    t = targets.to(torch.float32)
    log_p = -F.softplus(-x)
    log_not_p = -F.softplus(x)
    pos = t * log_p if pos_weight is None else pos_weight * t * log_p
    return _reduce(-(pos + (1.0 - t) * log_not_p), reduction)


def dice_loss(logits: torch.Tensor, targets: torch.Tensor,
              smooth: float = 1.0) -> torch.Tensor:
    """Global-flatten soft Dice (reference train.py:34-45)."""
    x, t = _flatten_pair(logits, targets)
    probs = torch.sigmoid(x)
    intersection = torch.sum(probs * t)
    return 1.0 - (2.0 * intersection + smooth) / (
        torch.sum(probs) + torch.sum(t) + smooth)


def focal_loss(logits: torch.Tensor, targets: torch.Tensor,
               gamma: float = 2.0, alpha: float = 0.25,
               reduction: str = "mean") -> torch.Tensor:
    """Alpha-balanced focal loss (reference train.py:47-80)."""
    x = logits.to(torch.float32)
    t = targets.to(torch.float32).reshape(x.shape)
    bce = bce_with_logits(x, t, reduction="none")
    pt = torch.exp(-bce)
    alpha_t = t * alpha + (1.0 - t) * (1.0 - alpha)
    return _reduce(alpha_t * (1.0 - pt) ** gamma * bce, reduction)


def combined_loss(logits: torch.Tensor, targets: torch.Tensor,
                  alpha: float = 0.5, smooth_dice: float = 1.0,
                  pos_weight: float = 9.0) -> torch.Tensor:
    """alpha * weighted-BCE + (1-alpha) * Dice (reference train.py:82-105)."""
    t = targets.to(torch.float32).reshape(logits.shape)
    bce = bce_with_logits(logits, t, pos_weight=pos_weight)
    return alpha * bce + (1.0 - alpha) * dice_loss(logits, t, smooth_dice)


def focal_dice_loss(logits: torch.Tensor, targets: torch.Tensor,
                    beta: float = 0.5, focal_gamma: float = 2.0,
                    focal_alpha: float = 0.75,
                    dice_smooth: float = 1.0) -> torch.Tensor:
    """beta * Focal + (1-beta) * Dice, the training loss (reference
    train.py:108-128)."""
    t = targets.to(torch.float32).reshape(logits.shape)
    return beta * focal_loss(logits, t, focal_gamma, focal_alpha) + (
        1.0 - beta) * dice_loss(logits, t, dice_smooth)


def gan_bce_loss(pred_logits: torch.Tensor, is_real: bool,
                 total: Optional[int] = None) -> torch.Tensor:
    """BCEWithLogits against an all-ones (``is_real``) or all-zeros patch
    map (reference train_gan.py:42, 58-67).  With ``total``, this rank's
    part of the global batch's mean: the local sum over the global
    element count ``total`` (the ranks' parts add up to the mean)."""
    x = pred_logits.to(torch.float32)
    target = torch.ones_like(x) if is_real else torch.zeros_like(x)
    if total is None:
        return bce_with_logits(x, target)
    return bce_with_logits(x, target, reduction="sum") / total


def l1_loss(x: torch.Tensor, y: torch.Tensor,
            total: Optional[int] = None) -> torch.Tensor:
    """Mean absolute error in float32 (reference train_gan.py:43, 68);
    with ``total``, the local sum over the global element count, as
    ``gan_bce_loss``."""
    err = torch.abs(x.to(torch.float32) - y.to(torch.float32))
    return torch.mean(err) if total is None else torch.sum(err) / total
