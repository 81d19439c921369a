"""Checkpoints under the reference's file-naming contract.

The reference saves a bare ``model.state_dict()`` as ``best_model.pth``
and ``model_epoch_N.pth`` (reference train.py:307-321, loaded by
evaluate.py:343-351).  This port reads and writes the same files, which
the JAX package's CLIs load too.  ``last_state.pth`` is the port's resume
file: model, optimizer, scheduler and early-stop state, the epoch and the
best validation loss.  Reading the JAX package's ``.msgpack`` checkpoints
is not ported yet.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
from torch import nn

from . import interop


def checkpoint_name(base: str) -> str:
    """The reference's stem with its ``.pth`` extension."""
    return base + ".pth"


def find_checkpoint(directory: str, stem: str) -> Optional[str]:
    """Locate ``<stem>.pth`` in a directory, None if absent."""
    p = os.path.join(directory, checkpoint_name(stem))
    return p if os.path.exists(p) else None


def _save_atomic(path: str, payload) -> None:
    """``torch.save`` to a tmp file, then rename over ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _cpu_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def save_model(path: str, model: nn.Module) -> None:
    """Write ``model.state_dict()`` atomically (tmp file + rename)."""
    _save_atomic(path, _cpu_state_dict(model))


def save_train_state(path: str, model: nn.Module,
                     optimizer: torch.optim.Optimizer, scheduler,
                     stopper, epoch: int, best_val_loss: float) -> None:
    """Write the resume state atomically: the model, optimizer, scheduler
    and early-stop state dicts, the epoch just finished and the best
    validation loss so far."""
    _save_atomic(path, {
        "model": _cpu_state_dict(model),
        "optimizer": optimizer.state_dict(),
        "scheduler": scheduler.state_dict(),
        "early_stop": stopper.state_dict(),
        "epoch": int(epoch),
        "best_val_loss": float(best_val_loss),
    })


def restore_train_state(path: str, model: nn.Module,
                        optimizer: torch.optim.Optimizer, scheduler,
                        stopper) -> Dict[str, Any]:
    """Load a ``save_train_state`` file into the given objects, in place.
    Returns {"epoch", "best_val_loss"}."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    scheduler.load_state_dict(state["scheduler"])
    stopper.load_state_dict(state["early_stop"])
    return {"epoch": int(state["epoch"]),
            "best_val_loss": float(state["best_val_loss"])}


def restore_model_only(path: str, model: nn.Module) -> nn.Module:
    """Load a ``.pth`` state dict into ``model`` (strict), in place."""
    if not path.endswith(".pth"):
        raise ValueError(
            f"{path}: only .pth checkpoints load here (.msgpack reading is "
            "not ported yet)"
        )
    model.load_state_dict(interop.load_torch_state_dict(path), strict=True)
    return model
