"""Weights in and out of the port's models.

  * ``siamese_state_dict_from_jax``, ``generator_state_dict_from_jax``,
    ``discriminator_state_dict_from_jax``: a JAX/Flax ``{"params",
    "batch_stats"}`` tree of numpy arrays (the JAX package's SiameseUNet,
    UNetGenerator or NLayerDiscriminator variables) to this port's
    ``state_dict``, loadable with ``strict=True``; ``state_dict_from_jax``
    picks the one for a model's class;
  * ``variables_from_msgpack``: a JAX package checkpoint (``.msgpack``,
    flax's serialization, model-only or a full train state) as the nested
    dict it holds, read by the port's own decoder (``utils/msgpack.py``);
  * ``load_torch_state_dict``: a ``.pth`` file (a bare reference
    ``state_dict``) as a dict of CPU tensors;
  * ``optimizer_state_dict_from_jax``: optax's Adam state (the
    ``ScaleByAdamState`` of the JAX package's ``make_optimizer``), its
    injected hyperparameters and, under ``--grad-accum``, the
    ``optax.MultiSteps`` counters and accumulator, as a ``state_dict`` for
    a model's optimizer (``torch.optim``'s Adam(W), or
    ``train.optim.OptaxAdam`` with bfloat16 or flat moments).

Layout: Flax conv kernels are (kh, kw, in, out), torch's are
(out, in, kh, kw).  A Flax ``ConvTranspose`` kernel is (kh, kw, in, out)
too and convolves; torch's ``ConvTranspose2d`` weight is
(in, out, kh, kw) and correlates, so the taps are flipped in both spatial
axes (the JAX package's interop.py:52-59).  Flax BatchNorm
``scale``/``bias`` + ``mean``/``var`` map to torch ``weight``/``bias`` +
``running_mean``/``running_var``; ``num_batches_tracked`` is emitted as 0.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from .models.pix2pix import NLayerDiscriminator, UNetGenerator
from .models.siamese_unet import SiameseUNet
from .utils import msgpack

_SIAMESE_SEQS = (
    "dconv_down1", "dconv_down2", "dconv_down3", "dconv_down4",
    "bottleneck", "dconv_up3", "dconv_up2", "dconv_up1", "dconv_last",
)
_SIAMESE_GATES = ("att3", "att2", "att1", "att_last")
# (flax conv name, flax bn name, torch conv idx, torch bn idx) within the
# reference double_conv Sequential(Conv, BN, ReLU, Conv, BN, ReLU).
_DC_LAYOUT = (("conv0", "bn0", 0, 1), ("conv1", "bn1", 3, 4))
# Attention gate: flax (conv, bn) <- torch Sequential attribute.
_GATE_LAYOUT = (("w_g", "bn_g", "W_g"), ("w_x", "bn_x", "W_x"),
                ("psi", "bn_psi", "psi"))


def _np(a) -> np.ndarray:
    """A leaf as a numpy array; a ``torch.bfloat16`` leaf (numpy has no
    bfloat16; see ``utils/msgpack.py``) widens exactly to float32."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a)


def _t(a, dtype=np.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(_np(a), dtype=dtype))


def _conv(kernel, dtype=np.float32) -> torch.Tensor:
    """Flax HWIO kernel -> torch OIHW weight."""
    return _t(np.transpose(_np(kernel), (3, 2, 0, 1)), dtype)


def _conv_transpose(kernel, dtype=np.float32) -> torch.Tensor:
    """Flax ConvTranspose HWIO kernel -> torch (in, out, kh, kw) weight,
    spatially flipped."""
    k = _np(kernel)[::-1, ::-1]
    return _t(np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1))), dtype)


def _bn(out, prefix, p, s, dtype) -> None:
    out[prefix + ".weight"] = _t(p["scale"], dtype)
    out[prefix + ".bias"] = _t(p["bias"], dtype)
    out[prefix + ".running_mean"] = _t(s["mean"], dtype)
    out[prefix + ".running_var"] = _t(s["var"], dtype)
    out[prefix + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def siamese_state_dict_from_jax(variables: Dict[str, Any],
                                dtype=np.float32) -> Dict[str, torch.Tensor]:
    """``dtype``: of the floating-point tensors (float32, the model's)."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    for name in _SIAMESE_SEQS:
        for cname, bname, ci, bi in _DC_LAYOUT:
            out[f"{name}.{ci}.weight"] = _conv(params[name][cname]["kernel"],
                                               dtype)
            _bn(out, f"{name}.{bi}", params[name][bname], stats[name][bname],
                dtype)
    for name in _SIAMESE_GATES:
        for cname, bname, tattr in _GATE_LAYOUT:
            out[f"{name}.{tattr}.0.weight"] = _conv(
                params[name][cname]["kernel"], dtype)
            out[f"{name}.{tattr}.0.bias"] = _t(params[name][cname]["bias"],
                                               dtype)
            _bn(out, f"{name}.{tattr}.1", params[name][bname],
                stats[name][bname], dtype)
    out["conv_last.weight"] = _conv(params["conv_head"]["kernel"], dtype)
    out["conv_last.bias"] = _t(params["conv_head"]["bias"], dtype)
    return out


def _skip_block(out, params, stats, prefix, dtype) -> None:
    """One UnetSkipBlock subtree at the Sequential ``prefix``: the index
    layout of models/pix2pix.py (outermost: no upnorm; innermost: no
    submodule)."""
    if "upnorm" not in params:  # outermost
        down, sub, up = 0, 1, 3
    elif "submodule" not in params:  # innermost
        down, sub, up = 1, None, 3
    else:
        down, sub, up = 1, 3, 5
    out[f"{prefix}.{down}.weight"] = _conv(params["downconv"]["kernel"],
                                           dtype)
    if "downnorm" in params:
        _bn(out, f"{prefix}.2", params["downnorm"], stats["downnorm"], dtype)
    if sub is not None:
        _skip_block(out, params["submodule"], stats["submodule"],
                    f"{prefix}.{sub}.model", dtype)
    out[f"{prefix}.{up}.weight"] = _conv_transpose(
        params["upconv"]["kernel"], dtype)
    if "bias" in params["upconv"]:
        out[f"{prefix}.{up}.bias"] = _t(params["upconv"]["bias"], dtype)
    if "upnorm" in params:
        _bn(out, f"{prefix}.{up + 1}", params["upnorm"], stats["upnorm"],
            dtype)


def generator_state_dict_from_jax(variables: Dict[str, Any],
                                  dtype=np.float32
                                  ) -> Dict[str, torch.Tensor]:
    """The JAX UNetGenerator's variables as the port's ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    _skip_block(out, variables["params"]["model"],
                variables["batch_stats"]["model"], "model.model", dtype)
    return out


def discriminator_state_dict_from_jax(variables: Dict[str, Any],
                                      dtype=np.float32
                                      ) -> Dict[str, torch.Tensor]:
    """The JAX NLayerDiscriminator's variables as the port's
    ``state_dict``: convs at Sequential indices 0, 2, 5, ..., norms at 3,
    6, ... (conv0, conv1..conv{n_layers}, conv_out; bn1..bn{n_layers})."""
    params, stats = variables["params"], variables["batch_stats"]
    n_bn = sum(1 for k in params if k.startswith("bn"))
    convs = [f"conv{n}" for n in range(n_bn + 1)] + ["conv_out"]
    idxs = [0] + [2 + 3 * n for n in range(n_bn + 1)]
    out: Dict[str, torch.Tensor] = {}
    for name, i in zip(convs, idxs):
        out[f"model.{i}.weight"] = _conv(params[name]["kernel"], dtype)
        if "bias" in params[name]:
            out[f"model.{i}.bias"] = _t(params[name]["bias"], dtype)
    for n in range(1, n_bn + 1):
        _bn(out, f"model.{3 * n}", params[f"bn{n}"], stats[f"bn{n}"], dtype)
    return out


_CONVERTERS = (
    (SiameseUNet, siamese_state_dict_from_jax),
    (UNetGenerator, generator_state_dict_from_jax),
    (NLayerDiscriminator, discriminator_state_dict_from_jax),
)


def state_dict_from_jax(model: nn.Module, variables: Dict[str, Any],
                        dtype=np.float32) -> Dict[str, torch.Tensor]:
    """The JAX variables of ``model``'s counterpart as ``model``'s
    ``state_dict``, by the model's class."""
    for cls, convert in _CONVERTERS:
        if isinstance(model, cls):
            return convert(variables, dtype)
    raise TypeError(f"no JAX converter for {type(model).__name__}")


def variables_from_msgpack(path: str) -> Dict[str, Any]:
    """The nested dict of a JAX package ``.msgpack`` checkpoint: at least
    ``params`` and ``batch_stats``; a full train state adds ``opt_state``
    and ``step``, and ``extra`` holds the epoch and the like.  Leaves are
    numpy arrays (read-only views of the file's bytes), bfloat16 leaves
    ``torch.bfloat16`` tensors."""
    with open(path, "rb") as f:
        return msgpack.restore(f.read())


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a ``.pth`` state dict onto the CPU (tensors only)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def unravel_like(flat, params: Mapping[str, Any]) -> Dict[str, Any]:
    """A 1-D vector of ``jax.flatten_util.ravel_pytree``'s layout (the
    moments of ``optax.flatten``) as a tree like ``params``: the leaves
    in flax's sorted-key order, each row-major in its JAX shape."""
    off = 0

    def walk(tree):
        nonlocal off
        if isinstance(tree, Mapping):
            return {k: walk(tree[k]) for k in sorted(tree)}
        shape = np.shape(tree)
        n = int(np.prod(shape))
        piece = flat[off:off + n].reshape(shape)
        off += n
        return piece

    out = walk(params)
    if off != len(flat):
        raise ValueError(f"a flat vector of {len(flat)} for {off} "
                         "parameters")
    return out


def optimizer_state_dict_from_jax(model: nn.Module,
                                  optimizer: torch.optim.Optimizer,
                                  adam_state: Mapping[str, Any],
                                  hyperparams: Mapping[str, Any],
                                  batch_stats: Dict[str, Any],
                                  params: Mapping[str, Any],
                                  multi_steps: Mapping[str, Any] = None
                                  ) -> Dict[str, Any]:
    """A ``state_dict`` for ``optimizer`` (over ``model``'s parameters)
    from optax's Adam state {"count", "mu", "nu"}, the
    ``inject_hyperparams`` dict beside it and, for an ``optax.MultiSteps``
    state, its {"mini_step", "gradient_step", "acc_grads"}.  ``params`` is
    the JAX parameter tree: it gives flattened moments their split.

    ``mu``, ``nu`` and ``acc_grads`` have the params tree's structure (a
    flattened moment is split back into it), so each goes through the
    model's weight converter (``state_dict_from_jax``, with the
    checkpoint's ``batch_stats`` to complete the tree): the HWIO to OIHW
    transposes and the conv-transpose flip apply to them as to the
    weights; bfloat16 moments come back bfloat16, exactly.  Each
    parameter's tensors are matched to it by name.  ``count`` becomes
    every parameter's ``step`` (torch.optim) or the ``count``; the
    learning rate, the weight decay and, where they were injected
    (adamw), the betas and eps become the group's."""
    def by_name(tree):
        if not isinstance(tree, Mapping):
            tree = unravel_like(tree, params)
        return state_dict_from_jax(
            model, {"params": tree, "batch_stats": batch_stats})

    moments = {key: by_name(adam_state[key]) for key in ("mu", "nu")}
    names = {id(p): name for name, p in model.named_parameters()}
    ps = [p for group in optimizer.param_groups for p in group["params"]]
    count = int(_np(adam_state["count"]))
    out = optimizer.state_dict()
    hp = {k: float(_np(v)) for k, v in hyperparams.items()}
    for group in out["param_groups"]:
        group["lr"] = hp["learning_rate"]
        group["weight_decay"] = hp["weight_decay"]
        if "b1" in hp:
            group["betas"] = (hp["b1"], hp["b2"])
            group["eps"] = hp["eps"]
    if "layout" not in out:  # torch.optim's Adam(W)
        out["state"] = {i: {"step": torch.tensor(float(count)),
                            "exp_avg": moments["mu"][names[id(p)]],
                            "exp_avg_sq": moments["nu"][names[id(p)]]}
                        for i, p in enumerate(ps)}
        return out

    def tensors(per_name, dtype=None):
        per = [per_name[names[id(p)]].to(dtype or p.dtype) for p in ps]
        if out["layout"]["flat"]:
            return [torch.cat([t.reshape(-1) for t in per])]
        return per

    mu_dtype = (torch.bfloat16 if out["layout"]["mu_dtype"] == "bfloat16"
                else None)
    out.update(count=count, exp_avg=tensors(moments["mu"], mu_dtype),
               exp_avg_sq=tensors(moments["nu"]))
    if multi_steps is not None:
        out.update(mini_step=int(_np(multi_steps["mini_step"])),
                   gradient_step=int(_np(multi_steps["gradient_step"])),
                   acc=tensors(by_name(multi_steps["acc_grads"])))
    return out
