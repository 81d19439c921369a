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
and discriminator.  Training resumes from a JAX train state too:
``restore_train_state_from_jax`` reads ``last_state.msgpack`` (the model,
optax's Adam moments and count, the injected learning rate, the plateau
and early-stop state, the epoch and the best validation loss) and
``restore_gan_state_from_jax`` reads ``last_generator.msgpack`` and
``last_discriminator.msgpack`` (the model, the Adam state, the
generator's ``ema_params`` and the epoch), in each optax layout of the
JAX package's optimizer knobs: ``optax.MultiSteps`` (``--grad-accum`` >
1: the counters and the accumulator too), flattened
(``--flat-opt-state``) and bfloat16 first moments (``--momentum-dtype
bfloat16``).  The port's own resume files hold its optimizer's state in
whichever layout (``train.optim.OptaxAdam.state_dict``).  A state, the
JAX package's or the port's, whose layout is not the one the run's flags
give raises ``ResumeLayoutError`` naming both, as the JAX package fails
on it (at the restore or the first step); a file that is not a train
state raises ``ResumeStateError``.

A model sharded over the tensor-parallel 'model' axis
(``parallel/tensor.py``) saves and restores the whole state, so that a
file moves between topologies: ``train_state`` and ``gan_state`` gather
every sharded leaf, its Adam moments and G's EMA over the model group (a
collective: every rank of the group calls them; one rank writes), and
hold the keys, shapes and dtypes of a one-process save; a bare model is
``parallel.tensor.whole_state_dict`` written with ``save_state_dict``.
The restores cut each rank's blocks from the whole tensors, the JAX
package's files too.  The ``AsyncCheckpointWriter`` snapshots such a
gathered payload.
"""

from __future__ import annotations

import copy
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from . import interop
from .parallel import tensor
from .train import optim


class ResumeStateError(ValueError):
    """``--resume`` found a file that is not a train state it can read
    (truncated, or another kind of checkpoint)."""


class ResumeLayoutError(ResumeStateError):
    """``--resume`` found a train state whose optimizer layout is not the
    one this run's flags give."""


def _check_layout(path: str, optimizer: torch.optim.Optimizer,
                  saved: Mapping[str, Any]) -> None:
    try:
        optim.check_layout(optimizer, saved)
    except optim.LayoutMismatchError as e:
        raise ResumeLayoutError(f"{path}: {e}") from e


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
    dicts, the epoch just finished and the best validation loss so far.
    Whole under a 'model' axis (module docstring)."""
    return {
        "model": tensor.whole_state_dict(model),
        "optimizer": tensor.whole_optimizer_state(model, optimizer),
        "scheduler": scheduler.state_dict(),
        "early_stop": stopper.state_dict(),
        "epoch": int(epoch),
        "best_val_loss": float(best_val_loss),
    }


def restore_train_state(path: str, model: nn.Module,
                        optimizer: torch.optim.Optimizer, scheduler,
                        stopper) -> Dict[str, Any]:
    """Load a ``train_state`` file (or, for a ``.msgpack`` path, the JAX
    package's: ``restore_train_state_from_jax``) into the given objects,
    in place.  Returns {"epoch", "best_val_loss"}."""
    if path.endswith(".msgpack"):
        return restore_train_state_from_jax(path, model, optimizer,
                                            scheduler, stopper)
    state = torch.load(path, map_location="cpu", weights_only=True)
    _check_layout(path, optimizer, optim.saved_layout(state["optimizer"]))
    _load_model_and_optimizer(model, optimizer, state["model"],
                              state["optimizer"])
    scheduler.load_state_dict(state["scheduler"])
    stopper.load_state_dict(state["early_stop"])
    return {"epoch": int(state["epoch"]),
            "best_val_loss": float(state["best_val_loss"])}


def gan_state(model: nn.Module, optimizer: torch.optim.Optimizer,
              epoch: int, ema: Optional[Dict[str, torch.Tensor]] = None
              ) -> Dict[str, Any]:
    """One GAN model's resume payload (live tensors): the model and
    optimizer state dicts, the epoch just finished and, for the generator
    with an EMA, the EMA by parameter name.  Whole under a 'model' axis
    (module docstring)."""
    payload = {"model": tensor.whole_state_dict(model),
               "optimizer": tensor.whole_optimizer_state(model, optimizer),
               "epoch": int(epoch)}
    if ema is not None:
        payload["ema"] = tensor.whole_state_dict(model, dict(ema))
    return payload


def _load_model_and_optimizer(model, optimizer, model_state,
                              optimizer_state) -> None:
    """Load whole (one-process) state dicts, cut to this rank's blocks
    when ``model`` is sharded."""
    model.load_state_dict(tensor.cut_state_dict(model, model_state),
                          strict=True)
    optimizer.load_state_dict(tensor.cut_optimizer_state(
        model, optimizer, optimizer_state))


def _load_ema(model, ema, source) -> None:
    """Copy ``source`` (whole tensors by parameter name) into ``ema``."""
    source = tensor.cut_state_dict(model, {k: source[k] for k in ema})
    for name, v in ema.items():
        v.copy_(source[name])


def restore_gan_state(path: str, model: nn.Module,
                      optimizer: torch.optim.Optimizer,
                      ema: Optional[Dict[str, torch.Tensor]] = None) -> int:
    """Load a ``gan_state`` file (or, for a ``.msgpack`` path, the JAX
    package's: ``restore_gan_state_from_jax``) into the given objects, in
    place.  The EMA tensors, when given, take the saved EMA, or the saved
    model's parameters if the file has none.  Returns the epoch."""
    if path.endswith(".msgpack"):
        return restore_gan_state_from_jax(path, model, optimizer, ema)
    state = torch.load(path, map_location="cpu", weights_only=True)
    _check_layout(path, optimizer, optim.saved_layout(state["optimizer"]))
    _load_model_and_optimizer(model, optimizer, state["model"],
                              state["optimizer"])
    if ema is not None:
        _load_ema(model, ema, state.get("ema", state["model"]))
    return int(state["epoch"])


def _jax_train_state(path: str) -> Dict[str, Any]:
    """A JAX package train state (``save_checkpoint`` without
    ``model_only``) as its nested dict."""
    try:
        state = interop.variables_from_msgpack(path)
    except ValueError as e:
        raise ResumeStateError(f"{path}: cannot read it to resume: {e}") \
            from e
    if not isinstance(state, dict) or not {
            "params", "batch_stats", "opt_state"} <= set(state):
        raise ResumeStateError(f"{path}: not a JAX train state (no params, "
                               "batch_stats and opt_state)")
    return state


# Where make_optimizer (the JAX package's train/optim.py:44-73) keeps
# optax's ScaleByAdamState inside inject_hyperparams' inner_state: adamw
# is optax.adamw's chain (scale_by_adam first), adam the chain
# (add_decayed_weights, scale_by_adam, scale_by_learning_rate).
_ADAM_INDEX = {"adamw": "0", "adam": "1"}


def _has_bfloat16(tree) -> bool:
    """Whether a decoded tree holds a bfloat16 leaf (the decoder's
    ``torch.bfloat16`` tensors)."""
    if isinstance(tree, dict):
        return any(_has_bfloat16(v) for v in tree.values())
    return isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16


def _optimizer_name(optimizer: torch.optim.Optimizer) -> str:
    if isinstance(optimizer, optim.OptaxAdam):
        return "adamw" if optimizer.decoupled else "adam"
    return "adamw" if isinstance(optimizer, torch.optim.AdamW) else "adam"


def _adam_state(path: str, opt_state: Mapping[str, Any],
                optimizer: torch.optim.Optimizer):
    """(ScaleByAdamState, injected hyperparams, MultiSteps state or None)
    of a JAX optimizer state for ``optimizer``.  Raises
    ``ResumeLayoutError`` when its layout is not ``optimizer``'s,
    ``ResumeStateError`` on another optimizer's state."""
    multi = opt_state if "inner_opt_state" in opt_state else None
    inner = multi["inner_opt_state"] if multi else opt_state
    name = _optimizer_name(optimizer)
    chain = inner.get("inner_state", {})
    adam = chain.get(_ADAM_INDEX[name]) if isinstance(chain, dict) else None
    if not isinstance(adam, dict) or not {"count", "mu", "nu"} <= set(adam):
        raise ResumeStateError(
            f"{path}: no {name} state where the JAX package's {name} keeps "
            f"it (inner_state[{_ADAM_INDEX[name]}])")
    _check_layout(path, optimizer, {
        "mu_dtype": "bfloat16" if _has_bfloat16(adam["mu"]) else "float32",
        "flat": not isinstance(adam["mu"], dict),
        "multi_steps": multi is not None})
    return adam, inner["hyperparams"], multi


def _load_jax_model_and_optimizer(path: str, state: Dict[str, Any],
                                  model: nn.Module,
                                  optimizer: torch.optim.Optimizer) -> None:
    adam, hyperparams, multi = _adam_state(path, state["opt_state"],
                                           optimizer)
    _load_model_and_optimizer(
        model, optimizer, interop.state_dict_from_jax(model, state),
        interop.optimizer_state_dict_from_jax(
            model, optimizer, adam, hyperparams, state["batch_stats"],
            state["params"], multi))


def restore_train_state_from_jax(path: str, model: nn.Module,
                                 optimizer: torch.optim.Optimizer, scheduler,
                                 stopper) -> Dict[str, Any]:
    """Load the JAX package's ``last_state.msgpack`` into the given
    objects, in place, as the JAX pipeline resumes (pipelines.py:158-175):
    the model, the optimizer (``interop.optimizer_state_dict_from_jax``),
    and from the extras the plateau state (its 4-key dict into torch's
    ``ReduceLROnPlateau``, and its learning rate into the optimizer, as
    the JAX pipeline injects it) and the early-stop state.  Returns
    {"epoch", "best_val_loss"}."""
    state = _jax_train_state(path)
    _load_jax_model_and_optimizer(path, state, model, optimizer)
    extra = state.get("extra", {})
    epoch = int(extra.get("epoch", 0))
    plateau = extra.get("scheduler")
    if plateau is not None:
        # The JAX optimizer runs with the float32 injected value.
        lr = float(np.float32(plateau["lr"]))
        for group in optimizer.param_groups:
            group["lr"] = lr
        sd = scheduler.state_dict()
        sd.update(best=float(plateau["best"]),
                  num_bad_epochs=int(plateau["num_bad_epochs"]),
                  cooldown_counter=int(plateau["cooldown_counter"]),
                  last_epoch=epoch,
                  _last_lr=[lr] * len(optimizer.param_groups))
        scheduler.load_state_dict(sd)
    if "early_stop" in extra:
        stopper.load_state_dict(extra["early_stop"])
    return {"epoch": epoch,
            "best_val_loss": float(extra.get("best_val_loss", float("inf")))}


def restore_gan_state_from_jax(path: str, model: nn.Module,
                               optimizer: torch.optim.Optimizer,
                               ema: Optional[Dict[str, torch.Tensor]] = None
                               ) -> int:
    """Load the JAX package's ``last_generator.msgpack`` or
    ``last_discriminator.msgpack`` into the given objects, in place: the
    model and its Adam state, and for a generator with an EMA its
    ``ema_params`` (the saved model's parameters if the file has none, as
    ``restore_gan_state`` does).  Returns the epoch."""
    state = _jax_train_state(path)
    _load_jax_model_and_optimizer(path, state, model, optimizer)
    if ema is not None:
        _load_ema(model, ema, interop.state_dict_from_jax(model, {
            "params": state.get("ema_params", state["params"]),
            "batch_stats": state["batch_stats"]}))
    return int(state.get("extra", {}).get("epoch", 0))


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
    model.load_state_dict(tensor.cut_state_dict(model, sd), strict=True)
    return model
