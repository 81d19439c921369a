"""Learning-rate plateau control and early stopping (the JAX package's
``train/plateau.py``).

The JAX package's ``ReduceLROnPlateau`` is a copy of torch's semantics, so
the port uses torch's own scheduler with the reference's settings
(train.py:296).  ``EarlyStopping`` is the JAX package's class, copied.
"""

from __future__ import annotations

import torch


def make_plateau_scheduler(optimizer: torch.optim.Optimizer,
                           factor: float = 0.2, patience: int = 7
                           ) -> torch.optim.lr_scheduler.ReduceLROnPlateau:
    """``ReduceLROnPlateau`` on the validation loss: mode min, relative
    threshold 1e-4, no cooldown, min_lr 0."""
    return torch.optim.lr_scheduler.ReduceLROnPlateau(
        optimizer, mode="min", factor=factor, patience=patience,
        threshold=1e-4, threshold_mode="rel")


class EarlyStopping:
    """Stop training after `patience` consecutive epochs with no
    validation-loss improvement (the reference always runs the full
    --num-epochs budget).  Improvement uses the same strict `<`-best
    criterion as best-model checkpointing (reference train.py:307-309), so
    "stopped" always means "the best_model checkpoint stopped advancing
    `patience` epochs ago".  A NaN validation loss never counts as an
    improvement, so a diverged run stops after `patience` epochs.

    patience <= 0 disables (``step`` always returns False).  Its state
    rides the last_state checkpoint, so --resume continues the bad-epoch
    count instead of resetting it."""

    def __init__(self, patience: int = 0):
        self.patience = int(patience)
        self.best = float("inf")
        self.num_bad_epochs = 0

    def step(self, metric: float) -> bool:
        """Feed the epoch's validation loss; True = stop now."""
        if metric < self.best:
            self.best = float(metric)
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        return self.patience > 0 and self.num_bad_epochs >= self.patience

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, state: dict) -> None:
        self.best = float(state["best"])
        self.num_bad_epochs = int(state["num_bad_epochs"])
