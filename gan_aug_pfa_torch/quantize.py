"""Post-training weight-only int8 quantization for serving (the JAX
package's ``quantize.py``): symmetric per-output-channel int8 weights,
full-precision activations.  No calibration data, no quantization-aware
training.

A quantized tensor is the dict ``{"q8": int8[*shape], "q8_scale":
f32[...]}`` spliced into a ``state_dict`` where the floating-point tensor
was.  The scale keeps the weight's rank, with every axis but the output
channels' of size 1, so ``q8 * q8_scale`` broadcasts without knowing the
axis.  Only floating-point tensors with ndim >= 2 and >= ``min_elems``
elements are quantized (conv and conv-transpose weights); BatchNorm
vectors, biases and running statistics stay at full precision.  Integer
buffers (BatchNorm's ``num_batches_tracked``, which the JAX variables
tree does not have) pass through and are not counted in the report, so
the report's counts and bytes are the JAX package's for the same model.

The output-channel axis is the owning module's: 0 for ``nn.Conv2d``
(out, in, kh, kw), 1 for ``nn.ConvTranspose2d`` (in, out, kh, kw)
(``out_channel_axes``).  The JAX package reduces over every axis but the
last, because Flax kernels are HWIO in both layouts; the same channels
give the same scales and the same int8 values.  The arithmetic is JAX's,
in float32: scale = amax / 127 (1 for an all-zero channel), q =
clip(rint(w / scale), -127, 127); ``torch.round`` rounds half to even, as
``np.rint`` does.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

QKEY = "q8"
SKEY = "q8_scale"

#: Tensors smaller than this stay at full precision: quantizing them saves
#: few bytes, and BatchNorm statistics and biases are accuracy-critical.
DEFAULT_MIN_ELEMS = 4096

_CONV_TRANSPOSE = (nn.ConvTranspose1d, nn.ConvTranspose2d,
                   nn.ConvTranspose3d)


def is_qleaf(node: Any) -> bool:
    """True for the dict a quantized tensor is stored as."""
    return isinstance(node, dict) and QKEY in node and SKEY in node


def out_channel_axes(model: nn.Module) -> Dict[str, int]:
    """``state_dict`` key -> output-channel axis of every weight whose axis
    is not 0: the conv-transposes' (in, out, kh, kw) weights."""
    return {f"{name}.weight" if name else "weight": 1
            for name, module in model.named_modules()
            if isinstance(module, _CONV_TRANSPOSE)}


def quantize_array(w: torch.Tensor, axis: int = 0) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of one tensor, with
    the output channels on ``axis``.  scale[c] = max|w[c]| / 127, so the
    reconstruction error is at most scale/2 an element."""
    w = torch.as_tensor(w).to(torch.float32)
    reduce = tuple(d for d in range(w.ndim) if d != axis % w.ndim)
    amax = w.abs().amax(dim=reduce, keepdim=True)
    scale = amax / 127.0
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {QKEY: q, SKEY: scale}


def dequantize_array(node: Mapping[str, torch.Tensor],
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_array`` up to the rounding bound.  The multiply
    runs in float32, where the int8 values and the scales are exact, and
    only the result is cast to ``dtype``: a bfloat16 dequantize rounds
    once, not also the scales."""
    out = node[QKEY].to(torch.float32) * node[SKEY]
    return out if dtype == torch.float32 else out.to(dtype)


def quantize_tree(state_dict: Mapping[str, torch.Tensor],
                  min_elems: int = DEFAULT_MIN_ELEMS,
                  out_axes: Optional[Mapping[str, int]] = None
                  ) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """Quantize every large floating-point tensor of a ``state_dict`` with
    ndim >= 2.  ``out_axes`` gives the output-channel axis of a key where
    it is not 0 (``out_channel_axes(model)``).

    Returns (qtree, report): qtree has the input's keys, each quantized
    tensor replaced by a ``{"q8", "q8_scale"}`` dict; report counts the
    tensors and their bytes either side (float32 bytes for the
    full-precision side, as the JAX package counts them)."""
    out_axes = out_axes or {}
    report = {"quantized": 0, "kept_fp": 0, "bytes_fp": 0, "bytes_q": 0}
    qtree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        if not value.is_floating_point():
            qtree[key] = value
            continue
        nbytes_fp = value.numel() * 4
        report["bytes_fp"] += nbytes_fp
        if value.ndim >= 2 and value.numel() >= min_elems:
            node = quantize_array(value, out_axes.get(key, 0))
            report["quantized"] += 1
            report["bytes_q"] += sum(t.numel() * t.element_size()
                                     for t in node.values())
            qtree[key] = node
        else:
            report["kept_fp"] += 1
            report["bytes_q"] += nbytes_fp
            qtree[key] = value
    return qtree, report


def dequantize_tree(qtree: Mapping[str, Any],
                    dtype: torch.dtype = torch.float32
                    ) -> Dict[str, torch.Tensor]:
    """A full-precision ``state_dict`` from a quantized one: each quantized
    tensor dequantized to ``dtype``, every other tensor as it is."""
    return {key: dequantize_array(node, dtype) if is_qleaf(node) else node
            for key, node in qtree.items()}


def max_reconstruction_error(state_dict: Mapping[str, torch.Tensor],
                             qtree: Mapping[str, Any]) -> float:
    """Largest |w - dequant(q)| / scale over the quantized tensors: at most
    0.5 (plus float rounding) by construction."""
    worst = 0.0
    for key, node in qtree.items():
        if is_qleaf(node):
            w = state_dict[key].to(torch.float32)
            err = (w - dequantize_array(node)).abs() / node[SKEY]
            worst = max(worst, float(err.max()))
    return worst
