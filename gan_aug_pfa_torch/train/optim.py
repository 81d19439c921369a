"""Optimizers with the JAX package's semantics (``train/optim.py``).

  adamw: decoupled weight decay, ``torch.optim.AdamW`` (optax.adamw).
  adam:  ``torch.optim.Adam``, whose weight_decay adds wd*param to the
         gradient before the moment update (coupled L2), as the JAX
         package's ``add_decayed_weights`` before ``scale_by_adam``.

Betas (0.9, 0.999) and eps 1e-8 in both.  The learning rate lives in the
optimizer's ``param_groups``: ``set_learning_rate`` rewrites it between
epochs.
"""

from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                   learning_rate: float, weight_decay: float = 0.0,
                   b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8) -> torch.optim.Optimizer:
    name = name.lower()
    if name == "adamw":
        return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2),
                                 eps=eps, weight_decay=weight_decay)
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2),
                                eps=eps, weight_decay=weight_decay)
    raise ValueError(f"Unknown optimizer: {name}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])
