"""Checkpoints under the reference's file-naming contract.

The reference saves a bare ``model.state_dict()`` as ``best_model.pth``
(reference train.py:307-321, loaded by evaluate.py:343-351).  This port
reads and writes the same files.  Reading the JAX package's ``.msgpack``
checkpoints is not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional

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


def save_model(path: str, model: nn.Module) -> None:
    """Write ``model.state_dict()`` atomically (tmp file + rename)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    try:
        torch.save({k: v.detach().cpu() for k, v in
                    model.state_dict().items()}, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def restore_model_only(path: str, model: nn.Module) -> nn.Module:
    """Load a ``.pth`` state dict into ``model`` (strict), in place."""
    if not path.endswith(".pth"):
        raise ValueError(
            f"{path}: only .pth checkpoints load here (.msgpack reading is "
            "not ported yet)"
        )
    model.load_state_dict(interop.load_torch_state_dict(path), strict=True)
    return model
