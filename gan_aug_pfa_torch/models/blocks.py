"""Shared building blocks: DoubleConv and the additive AttentionGate (NCHW).

Submodule names and order follow the reference ``state_dict`` keys
(``dconv_down1.0.weight``, ``att3.W_g.0.weight``, ``att3.psi.1.running_var``)
so that reference ``.pth`` files load with ``strict=True``.

The knobs of the JAX package's ``models/blocks.py``:

  * an input may arrive as a tuple of channel slices (``--concat-free``):
    the first convolution then runs as ``sliced_conv2d``, the sum of the
    per-slice convolutions with the matching slices of the unchanged
    weight, and the channel concatenation is never built;
  * ``DoubleConv.remat`` (``--remat``) recomputes the block's activations
    in the backward (``torch.utils.checkpoint``) instead of keeping them.

Under the 'spatial' axis (``parallel/spatial.py``) a DoubleConv's 3x3
convolutions run on its level's height blocks with halo rows; the 1x1
convolutions of the attention gate need none.  Neither knob runs there:
each raises naming itself.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel import spatial
from ..parallel.batchnorm import GlobalBatchNorm2d, reducing
from ..parallel.tensor import conv_input_slice, whole

Slices = Union[torch.Tensor, Sequence[torch.Tensor]]


def sliced_conv2d(xs: Slices, conv: nn.Conv2d) -> torch.Tensor:
    """``conv(cat(xs, dim=1))`` as ``sum_i conv(x_i, W[:, off_i:off_i +
    c_i])``, the bias added after the sum (the JAX package's
    ``SlicedConv``, blocks.py:77-133): the same function up to the order
    of the sums, with ``conv``'s parameters as they are (gathered, when
    they are sharded over the 'model' axis: ``parallel/tensor.py``)."""
    if isinstance(xs, torch.Tensor):
        return spatial.conv(conv, xs)[0]
    spatial.refuse("--concat-free (channel slices)")
    out, off = None, 0
    for x in xs:
        y = conv_input_slice(conv, x, off)
        out = y if out is None else out + y
        off += x.shape[1]
    if off != conv.in_channels:
        raise ValueError(f"slices hold {off} channels, the conv takes "
                         f"{conv.in_channels}")
    if conv.bias is not None:
        out = out + whole(conv, "bias").to(out.dtype).view(1, -1, 1, 1)
    return out


def _stateless_bn(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """``bn(x)`` in train mode, the module's running statistics untouched:
    a train-mode pass normalizes with the batch's own statistics, so the
    output is the module's.  The update goes to scratch buffers (written,
    never read into the output; no kernel fills them), so that the pass
    saves the same tensors for the backward as ``bn(x)`` does, as
    ``torch.utils.checkpoint`` checks.  A ``GlobalBatchNorm2d`` under a
    data mesh normalizes with the global batch's statistics, again
    without an update (``parallel/batchnorm.py``); a sharded one's weight
    and bias are gathered, its scratch buffers whole."""
    if isinstance(bn, GlobalBatchNorm2d) and reducing():
        return bn.normalize(x, update_stats=False)
    scratch = [torch.empty(bn.num_features, dtype=t.dtype, device=t.device)
               for t in (bn.running_mean, bn.running_var)]
    return F.batch_norm(x, *scratch, whole(bn, "weight"), whole(bn, "bias"),
                        True, bn.momentum, bn.eps)


class DoubleConv(nn.Sequential):
    """(Conv3x3 no-bias -> BN -> ReLU) x2 (reference models.py:7-15).

    ``x`` may be a tuple of channel slices (``sliced_conv2d``).  With
    ``remat`` a train-mode forward under autograd keeps only its input:
    the backward runs the block again.  The running statistics update
    once, in the first forward; the recomputation normalizes with the
    batch statistics only (the same output), as JAX's ``nn.remat`` leaves
    them."""

    remat = False

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(
            nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_channels, eps=1e-5),
            nn.ReLU(inplace=True),
            nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_channels, eps=1e-5),
            nn.ReLU(inplace=True),
        )

    def forward(self, x: Slices) -> torch.Tensor:
        xs = (x,) if isinstance(x, torch.Tensor) else tuple(x)
        if self.remat:
            spatial.refuse("--remat")
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return self._run(xs, update_stats=True)
        first = [True]

        def run(*xs):
            update, first[0] = first[0], False
            return self._run(xs, update_stats=update)

        return checkpoint(run, *xs, use_reentrant=False,
                          preserve_rng_state=False)

    def _run(self, xs, update_stats: bool) -> torch.Tensor:
        conv0, bn0, relu0, conv1, bn1, relu1 = self
        bn = (lambda m, t: m(t)) if update_stats else _stateless_bn
        x = sliced_conv2d(xs[0] if len(xs) == 1 else xs, conv0)
        x = spatial.conv(conv1, relu0(bn(bn0, x)))[0]
        return relu1(bn(bn1, x))


class AttentionGate(nn.Module):
    """Additive attention gate (reference models.py:18-44):
    psi = sigmoid(BN(Conv1x1(relu(BN(W_g g) + BN(W_x x))))); returns x * psi.

    ``g`` and ``x`` may be tuples of channel slices: W_g and W_x then run
    as ``sliced_conv2d`` and the gate returns the tuple ``x_i * psi``
    (JAX blocks.py:136-194).
    """

    def __init__(self, f_g: int, f_l: int, f_int: int):
        super().__init__()
        self.W_g = nn.Sequential(
            nn.Conv2d(f_g, f_int, 1, bias=True), nn.BatchNorm2d(f_int)
        )
        self.W_x = nn.Sequential(
            nn.Conv2d(f_l, f_int, 1, bias=True), nn.BatchNorm2d(f_int)
        )
        self.psi = nn.Sequential(
            nn.Conv2d(f_int, 1, 1, bias=True), nn.BatchNorm2d(1), nn.Sigmoid()
        )

    def forward(self, g: Slices, x: Slices):
        g1 = self.W_g[1](sliced_conv2d(g, self.W_g[0]))
        x1 = self.W_x[1](sliced_conv2d(x, self.W_x[0]))
        psi = self.psi(torch.relu(g1 + x1))
        if isinstance(x, torch.Tensor):
            return x * psi
        return tuple(xi * psi for xi in x)
