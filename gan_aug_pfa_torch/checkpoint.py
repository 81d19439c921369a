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
optimizer, the generator's EMA and the epoch).

Every write is atomic (a tmp file, then a rename).  ``save`` writes at
once; ``AsyncCheckpointWriter.save`` snapshots the payload on the device
and writes it on a background thread (``--async-ckpt``).

Models also load from the JAX package's ``.msgpack`` checkpoints
(``restore_model_only``, through ``interop.variables_from_msgpack``):
model-only files and full train states, Siamese, generator (EMA included)
and discriminator.  Resuming training from a JAX train state
(``last_state.msgpack``, ``last_generator.msgpack``, whose optax moments
and schedule need their own mapping) is not ported yet:
``find_resume_checkpoint`` raises ``ResumeNotPortedError`` on one.
"""

from __future__ import annotations

import copy
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import torch
from torch import nn

from . import interop


class ResumeNotPortedError(NotImplementedError):
    """``--resume`` found only a JAX train state (``.msgpack``)."""


def checkpoint_name(base: str) -> str:
    """The reference's stem with its ``.pth`` extension."""
    return base + ".pth"


def find_checkpoint(directory: str, stem: str) -> Optional[str]:
    """Locate ``<stem>.pth``, else a JAX package ``<stem>.msgpack``, in a
    directory; None if neither exists."""
    for ext in (".pth", ".msgpack"):
        p = os.path.join(directory, stem + ext)
        if os.path.exists(p):
            return p
    return None


def find_resume_checkpoint(directory: str, stem: str) -> Optional[str]:
    """``<stem>.pth`` to resume from, None if absent.  Raises
    ``ResumeNotPortedError`` when only a JAX ``<stem>.msgpack`` is there,
    rather than start again at epoch 1."""
    path = find_checkpoint(directory, stem)
    if path is not None and path.endswith(".msgpack"):
        raise ResumeNotPortedError(
            f"{path}: resuming from a JAX train state (.msgpack) is not "
            "ported yet")
    return path


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


def _map(obj, fn, leaf=lambda x: x):
    """``obj`` with ``fn`` applied to every tensor in its dicts, lists and
    tuples, and ``leaf`` to every other leaf."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map(v, fn, leaf) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(v, fn, leaf) for v in obj)
    return leaf(obj)


def save(path: str, payload) -> None:
    """Write ``payload`` (tensors, in dicts and lists, on any device) with
    every tensor on the CPU, atomically."""
    _save_atomic(path, _map(payload, lambda t: t.detach().cpu()))


def _snapshot(payload):
    """A copy the training loop cannot change: each tensor cloned where it
    lies (``optimizer.step()`` and BatchNorm update parameters, moments,
    step counts and running statistics in place), every other leaf deep
    copied (the scheduler's and early-stop dicts)."""
    return _map(payload, lambda t: t.detach().clone(), copy.deepcopy)


class AsyncCheckpointWriter:
    """Background checkpoint writes (the JAX package's
    ``AsyncCheckpointWriter``, checkpoint.py:110-174).

    ``save`` clones the payload on its device (``_snapshot``), records a
    CUDA event after the clones on the current stream, and hands the
    snapshot to one worker thread, which waits for the event, copies the
    snapshot to the host and writes it atomically while training goes on.
    The event orders the copy after the clones whatever stream either
    thread uses.  One write is in flight at a time: a second ``save``
    waits for the first, which bounds the extra device memory to one
    snapshot.  A write's error is raised by the next ``save`` or
    ``wait``."""

    def __init__(self):
        self._ex = ThreadPoolExecutor(max_workers=1)
        self._inflight = None

    def save(self, path: str, payload) -> None:
        self.wait()
        snap = _snapshot(payload)
        devices = []
        _map(snap, lambda t: t.is_cuda and devices.append(t.device))
        done = None
        if devices:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(devices[0]))
        self._inflight = self._ex.submit(self._write, path, snap, done)

    @staticmethod
    def _write(path: str, snap, done) -> None:
        if done is not None:
            done.synchronize()
        save(path, snap)

    def wait(self) -> None:
        """Block until the write in flight (if any) is on disk; raise its
        error.  Call after the training loop, so that the last checkpoint
        is durable before the process exits."""
        if self._inflight is not None:
            fut, self._inflight = self._inflight, None
            fut.result()

    def close(self) -> None:
        """``wait``, then stop the worker thread."""
        try:
            self.wait()
        finally:
            self._ex.shutdown()


def save_state_dict(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """Write a bare ``state_dict`` (its tensors on the CPU) atomically."""
    save(path, state_dict)


def save_model(path: str, model: nn.Module) -> None:
    """Write ``model.state_dict()`` with ``save_state_dict``."""
    save(path, model.state_dict())


def train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                scheduler, stopper, epoch: int,
                best_val_loss: float) -> Dict[str, Any]:
    """The Siamese resume payload (live tensors; ``save`` or a writer
    copies them): the model, optimizer, scheduler and early-stop state
    dicts, the epoch just finished and the best validation loss so far."""
    return {
        "model": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "scheduler": scheduler.state_dict(),
        "early_stop": stopper.state_dict(),
        "epoch": int(epoch),
        "best_val_loss": float(best_val_loss),
    }


def restore_train_state(path: str, model: nn.Module,
                        optimizer: torch.optim.Optimizer, scheduler,
                        stopper) -> Dict[str, Any]:
    """Load a ``train_state`` file into the given objects, in place.
    Returns {"epoch", "best_val_loss"}."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    scheduler.load_state_dict(state["scheduler"])
    stopper.load_state_dict(state["early_stop"])
    return {"epoch": int(state["epoch"]),
            "best_val_loss": float(state["best_val_loss"])}


def gan_state(model: nn.Module, optimizer: torch.optim.Optimizer,
              epoch: int, ema: Optional[Dict[str, torch.Tensor]] = None
              ) -> Dict[str, Any]:
    """One GAN model's resume payload (live tensors): the model and
    optimizer state dicts, the epoch just finished and, for the generator
    with an EMA, the EMA by parameter name."""
    payload = {"model": model.state_dict(),
               "optimizer": optimizer.state_dict(), "epoch": int(epoch)}
    if ema is not None:
        payload["ema"] = dict(ema)
    return payload


def restore_gan_state(path: str, model: nn.Module,
                      optimizer: torch.optim.Optimizer,
                      ema: Optional[Dict[str, torch.Tensor]] = None) -> int:
    """Load a ``gan_state`` file into the given objects, in place.  The
    EMA tensors, when given, take the saved EMA, or the saved model's
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
    """Load a checkpoint's weights into ``model`` (strict), in place: a
    ``.pth`` state dict, or a JAX package ``.msgpack`` file, of which only
    ``params`` and ``batch_stats`` are read (a full train state's
    ``opt_state``, ``step``, ``ema_params`` and ``extra`` are ignored, as
    the JAX package's ``restore_model_only`` ignores them)."""
    if path.endswith(".msgpack"):
        variables = interop.variables_from_msgpack(path)
        if not isinstance(variables, dict) or not {
                "params", "batch_stats"} <= set(variables):
            raise ValueError(f"{path}: not a JAX model checkpoint (no "
                             "params and batch_stats)")
        sd = interop.state_dict_from_jax(model, variables)
    else:
        sd = interop.load_torch_state_dict(path)
    model.load_state_dict(sd, strict=True)
    return model
