"""Checkpoints under the reference's file-naming contract.

The reference saves a bare ``model.state_dict()`` as ``best_model.pth``,
``model_epoch_N.pth``, ``generator_epoch_N.pth`` and
``discriminator_epoch_N.pth`` (reference train.py:307-321,
train_gan.py:149-154, loaded by evaluate.py:343-351 and
generate_synthetic_data.py:48).  This port reads and writes the same
files, which the JAX package's CLIs load too; ``generator_ema_epoch_N.pth``
(``--ema-decay``) is one more bare generator ``state_dict``.  The resume
files are the port's own: ``last_state.pth`` (Siamese: model, optimizer,
scheduler and early-stop state, the epoch and the best validation loss)
and ``last_generator.pth`` / ``last_discriminator.pth`` (GAN: model,
optimizer, the generator's EMA and the epoch).  Reading the JAX package's
``.msgpack`` checkpoints is not ported yet.
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


def save_state_dict(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """Write a bare ``state_dict`` (its tensors on the CPU) atomically (tmp
    file + rename)."""
    _save_atomic(path, {k: v.detach().cpu() for k, v in state_dict.items()})


def save_model(path: str, model: nn.Module) -> None:
    """Write ``model.state_dict()`` with ``save_state_dict``."""
    save_state_dict(path, model.state_dict())


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


def save_gan_state(path: str, model: nn.Module,
                   optimizer: torch.optim.Optimizer, epoch: int,
                   ema: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Write one GAN model's resume state atomically: the model and
    optimizer state dicts, the epoch just finished and, for the generator
    with an EMA, the EMA by parameter name."""
    payload = {"model": _cpu_state_dict(model),
               "optimizer": optimizer.state_dict(), "epoch": int(epoch)}
    if ema is not None:
        payload["ema"] = {k: v.detach().cpu() for k, v in ema.items()}
    _save_atomic(path, payload)


def restore_gan_state(path: str, model: nn.Module,
                      optimizer: torch.optim.Optimizer,
                      ema: Optional[Dict[str, torch.Tensor]] = None) -> int:
    """Load a ``save_gan_state`` file into the given objects, in place.
    The EMA tensors, when given, take the saved EMA, or the saved model's
    parameters if the file has none.  Returns the epoch."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    if ema is not None:
        source = state.get("ema", state["model"])
        for name, v in ema.items():
            v.copy_(source[name])
    return int(state["epoch"])


def restore_model_only(path: str, model: nn.Module) -> nn.Module:
    """Load a ``.pth`` state dict into ``model`` (strict), in place."""
    if not path.endswith(".pth"):
        raise ValueError(
            f"{path}: only .pth checkpoints load here (.msgpack reading is "
            "not ported yet)"
        )
    model.load_state_dict(interop.load_torch_state_dict(path), strict=True)
    return model
