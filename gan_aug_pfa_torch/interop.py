"""Weights in and out of the port's SiameseUNet.

  * ``siamese_state_dict_from_jax``: a JAX/Flax ``{"params",
    "batch_stats"}`` tree of numpy arrays (the JAX package's SiameseUNet
    variables) to this port's ``state_dict``, loadable with
    ``strict=True``;
  * ``load_torch_state_dict``: a ``.pth`` file (a bare reference
    ``state_dict``) as a dict of CPU tensors.

Layout: Flax conv kernels are (kh, kw, in, out), torch's are
(out, in, kh, kw).  Flax BatchNorm ``scale``/``bias`` + ``mean``/``var``
map to torch ``weight``/``bias`` + ``running_mean``/``running_var``;
``num_batches_tracked`` is emitted as 0.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

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


def _t(a, dtype=np.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype))


def _conv(kernel, dtype=np.float32) -> torch.Tensor:
    """Flax HWIO kernel -> torch OIHW weight."""
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)), dtype)


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


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a ``.pth`` state dict onto the CPU (tensors only)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
