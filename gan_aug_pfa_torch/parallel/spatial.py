"""The 'spatial' mesh axis: feature-map height split over ranks (the JAX
package's ``P(data, spatial, None, None)`` on its input batches,
``train/siamese.py:269-293`` and ``train/gan.py:310-330``, for which XLA
inserts the halo exchanges around the convolutions).

Spatial rank k of s holds rows [k H/s, (k+1) H/s) of every map that is
split; the width stays whole.  Three operations move rows between the
ranks of the spatial group, each an ``autograd.Function`` whose backward
is the exact adjoint of its forward:

  * ``halo(x, top, bottom)``: the block with ``top`` rows of the rank
    above and ``bottom`` rows of the rank below; rows outside the map are
    zeros, a convolution's own zero padding.  The backward sends each halo
    row's gradient back to its owner, which adds it;
  * ``gather_rows`` (split -> whole): every rank's block on every rank;
    the backward sums the gradient over the group and keeps the rank's
    block (a reduce-scatter);
  * ``split_rows`` (whole -> split): the rank's block; the backward puts
    the block's gradient into zeros.

With these adjoints every rank's parameter gradient is a *partial* one,
and their sum over data x spatial is the whole gradient, in the split and
in the whole parts of a network alike, so one reduction serves every leaf
(``DataMesh.reduce_gradients``).  A loss that every spatial rank computes
whole (D's patch map) seeds its backward with 1/s of itself.  The rows
move through ``all_reduce`` alone (a zeroed buffer in which each rank
fills its slot; at least float32, which a 16-bit value survives exactly),
which gloo also runs on CUDA tensors.

The split rule (JAX's "XLA splits what it can" as one rule): a map of
global height h is split when h divides by s, else every spatial rank
holds it whole.  ``level(h)`` tells the BatchNorms inside which state
their maps are in; ``conv``, ``max_pool2x`` and ``upsample2x`` take a map
of height h to the next height and keep the rule:

  * an op whose window is the same on a block as on the map (``conv`` with
    2p + stride = k, a ``ConvTranspose2d`` with k - 2p = stride, the 2x2
    max pool) runs on the block, with a ``halo`` of its padding's rows and
    no H-padding (a conv-transpose's padding becomes stride * halo + p,
    which crops its output to the block's rows), when both heights split;
  * the align-corners 2x upsample reads within one row of the block:
    a 1-row ``halo``, the width interpolated whole, then the rows of the
    global (2h, h) interpolation matrix that belong to the block;
  * otherwise the input is gathered (when split), the op runs whole, and
    its output is split again when its height divides.

Where the rule leaves a map whole, a stride-2 op's blocks all start on an
even row: a split output height h/2 = s q makes the input blocks 2q rows.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.resize import upsample2x_align_corners
from .tensor import shard_of, sharded_conv

ROADMAP_KNOBS = "ROADMAP A5"


@dataclasses.dataclass(frozen=True)
class Split:
    """A step's height split: this process is ``rank`` of ``size`` in the
    spatial ``group``; ``stats_group`` is what a split map's BatchNorm
    statistics and a split loss sum over (data x spatial in a sharded
    step, the spatial group in a replicated one)."""

    group: Any
    size: int
    rank: int
    stats_group: Any

    def block(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's rows of the whole ``t`` along ``dim`` (a view)."""
        h = t.shape[dim]
        if h % self.size:
            raise ValueError(
                f"the 'spatial' axis splits the height over {self.size} "
                f"ranks: a height of {h} does not divide")
        n = h // self.size
        return t.narrow(dim, self.rank * n, n)


# The step's split (``splitting``), the global height of the maps the
# model works on now and whether they are split (``level``).  Module
# globals, as ``batchnorm``'s group: they are read in the forward only.
_SPLIT: Optional[Split] = None
_HEIGHT = 0
_HERE = False


class _State:
    """Sets the module's state for a block and restores it after."""

    def __init__(self, split, height, here):
        self.state = split, height, here

    def __enter__(self):
        global _SPLIT, _HEIGHT, _HERE
        self.prev = _SPLIT, _HEIGHT, _HERE
        _SPLIT, _HEIGHT, _HERE = self.state

    def __exit__(self, *exc):
        global _SPLIT, _HEIGHT, _HERE
        _SPLIT, _HEIGHT, _HERE = self.prev


_NOTHING = contextlib.nullcontext()


def splitting(split: Optional[Split]):
    """Within: models run on this rank's height blocks of their inputs
    (None: on whole maps, as without the axis)."""
    if split is None:
        return _NOTHING
    return _State(split, 0, True)


def here() -> Optional[Split]:
    """The split when the maps the model works on now are split, else
    None (what train-mode BatchNorm reads)."""
    return _SPLIT if _HERE else None


def splits(height: int) -> bool:
    """Whether a map of global ``height`` is split (the rule)."""
    return _SPLIT is not None and height % _SPLIT.size == 0


def level(height: int):
    """Within: the model works on maps of global ``height``, split or
    whole by the rule."""
    if _SPLIT is None:
        return _NOTHING
    return _State(_SPLIT, height, splits(height))


def height() -> int:
    """The global height of the current ``level``."""
    return _HEIGHT


def input_height(x: torch.Tensor) -> int:
    """The global height of a model's input ``x``: its rows times s under
    a split (the trainers cut each rank's block), else its rows."""
    return x.shape[2] * (_SPLIT.size if _SPLIT is not None else 1)


def refuse(knob: str) -> None:
    """Raise when a knob whose convolutions are not ported under the
    axis would run on split maps."""
    if _SPLIT is not None:
        raise ValueError(f"{knob} does not run under the 'spatial' axis "
                         f"yet ({ROADMAP_KNOBS}); train without it")


# -- moving rows --------------------------------------------------------------


def _exchange(t: torch.Tensor, split: Split) -> torch.Tensor:
    """Every rank's ``t`` on every rank of the spatial group: (size,
    *t.shape), at least float32, from an all-reduce of a zeroed buffer in
    which each rank fills its slot."""
    acc = torch.promote_types(t.dtype, torch.float32)
    buf = t.new_zeros((split.size, *t.shape), dtype=acc)
    buf[split.rank].copy_(t)
    dist.all_reduce(buf, group=split.group)
    return buf


def _sum(t: torch.Tensor, split: Split) -> torch.Tensor:
    """``t`` summed over the spatial group, at least float32."""
    out = t.to(torch.promote_types(t.dtype, torch.float32),
               memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(out, group=split.group)
    return out


class _Halo(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, top, bottom, split):
        ctx.top, ctx.bottom, ctx.split = top, bottom, split
        n, c, h, w = x.shape
        if h < max(top, bottom):
            raise ValueError(f"a halo of {max(top, bottom)} rows from "
                             f"blocks of {h}")
        # Each rank offers its first ``bottom`` rows (to the rank above)
        # and its last ``top`` rows (to the rank below).
        edges = _exchange(torch.cat([x[:, :, :bottom], x[:, :, h - top:]],
                                    dim=2), split).to(x.dtype)
        k = split.rank
        above = (edges[k - 1][:, :, bottom:] if k > 0
                 else x.new_zeros((n, c, top, w)))
        below = (edges[k + 1][:, :, :bottom] if k + 1 < split.size
                 else x.new_zeros((n, c, bottom, w)))
        return torch.cat([above, x, below], dim=2)

    @staticmethod
    def backward(ctx, g):
        top, bottom, split = ctx.top, ctx.bottom, ctx.split
        h = g.shape[2] - top - bottom
        # The halo rows' gradients go to their owners: the rank above
        # owns the first ``top``, the rank below the last ``bottom``.
        back = _exchange(torch.cat([g[:, :, :top], g[:, :, top + h:]],
                                   dim=2), split).to(g.dtype)
        gx = g[:, :, top:top + h].clone(memory_format=torch.contiguous_format)
        k = split.rank
        if k + 1 < split.size and top:
            gx[:, :, h - top:] += back[k + 1][:, :, :top]
        if k > 0 and bottom:
            gx[:, :, :bottom] += back[k - 1][:, :, top:]
        return gx, None, None, None


def halo(x: torch.Tensor, top: int, bottom: int,
         split: Optional[Split] = None) -> torch.Tensor:
    """The block ``x`` (N, C, h, W) with ``top`` rows of the rank above and
    ``bottom`` of the rank below (zeros beyond the map's edges)."""
    return _Halo.apply(x, top, bottom, split or _SPLIT)


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        n, c, h, w = x.shape
        buf = _exchange(x, split)  # (s, N, C, h, W)
        return buf.permute(1, 2, 0, 3, 4).reshape(n, c, split.size * h,
                                                  w).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        split = ctx.split
        return split.block(_sum(g, split), 2).to(g.dtype), None


def gather_rows(x: torch.Tensor, split: Optional[Split] = None
                ) -> torch.Tensor:
    """The whole map from every rank's block ``x`` (N, C, h, W)."""
    return _GatherRows.apply(x, split or _SPLIT)


class _SplitRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, split):
        ctx.split, ctx.shape = split, x.shape
        return split.block(x, 2).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        split = ctx.split
        whole = g.new_zeros(ctx.shape)
        split.block(whole, 2).copy_(g)
        return whole, None


def split_rows(x: torch.Tensor, split: Optional[Split] = None
               ) -> torch.Tensor:
    """This rank's block of the whole map ``x`` (N, C, H, W)."""
    return _SplitRows.apply(x, split or _SPLIT)


# -- the layers ---------------------------------------------------------------


def _window(module: nn.Module):
    """(halo top, halo bottom, H-padding on the halo'd block) of a conv
    whose window is the same on a block as on the map, else None."""
    kh, sh, ph = module.kernel_size[0], module.stride[0], module.padding[0]
    if module.dilation[0] != 1:
        return None
    if module.transposed:
        if kh - 2 * ph != sh or module.output_padding[0]:
            return None
        top, bottom = -(-(kh - 1 - ph) // sh), (sh - 1 + ph) // sh
        return top, bottom, sh * top + ph
    if 2 * ph + sh != kh:
        return None
    return ph, ph, 0


def conv_height(module: nn.Module, h: int) -> int:
    """The global output height of ``module`` (a Conv2d or
    ConvTranspose2d) on a map of global height ``h``."""
    kh, sh, ph = module.kernel_size[0], module.stride[0], module.padding[0]
    dh = module.dilation[0]
    if module.transposed:
        return ((h - 1) * sh - 2 * ph + dh * (kh - 1)
                + module.output_padding[0] + 1)
    return (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1


def _block_conv(module: nn.Module, x: torch.Tensor, window) -> torch.Tensor:
    """``module`` on the split block ``x`` (the rule's first case)."""
    top, bottom, pad_h = window
    if x.shape[2] % module.stride[0] and not module.transposed:
        raise ValueError(f"blocks of {x.shape[2]} rows under a stride of "
                         f"{module.stride[0]}")
    xh = halo(x, top, bottom) if top or bottom else x
    padding = (pad_h, module.padding[1])
    if shard_of(module) is not None:
        return sharded_conv(module, xh, padding=padding)
    if module.transposed:
        return F.conv_transpose2d(xh, module.weight, module.bias,
                                  module.stride, padding,
                                  module.output_padding, module.groups,
                                  module.dilation)
    return F.conv2d(xh, module.weight, module.bias, module.stride, padding,
                    module.dilation, module.groups)


def _rule(x, h, h_out, whole_op, block_op):
    """The rule for an op from height ``h`` to ``h_out``: ``block_op`` on
    the block when both split and it has one (not None), else the op
    whole, the input gathered before it and the output split after it as
    the rule says."""
    s_in, s_out = splits(h), splits(h_out)
    if s_in and s_out and block_op is not None:
        return block_op(x)
    if s_in:
        x = gather_rows(x)
    y = whole_op(x)
    return split_rows(y) if s_out else y


def conv(module: nn.Module, x: torch.Tensor, h: Optional[int] = None):
    """``module(x)`` (a Conv2d or ConvTranspose2d, sharded over 'model' or
    not) on a map of global height ``h`` (the current ``level``'s when
    None); returns (output, its global height)."""
    if _SPLIT is None:
        y = module(x)
        return y, y.shape[2]
    h = _HEIGHT if h is None else h
    h_out = conv_height(module, h)
    window = _window(module)
    block_op = (None if window is None
                else functools.partial(_block_conv, module, window=window))
    return _rule(x, h, h_out, module, block_op), h_out


def max_pool2x(x: torch.Tensor, h: int) -> torch.Tensor:
    """``F.max_pool2d(x, 2, 2)`` on a map of global height ``h``."""
    pool = functools.partial(F.max_pool2d, kernel_size=2, stride=2)
    if _SPLIT is None:
        return pool(x)
    return _rule(x, h, h // 2, pool, pool)


def upsample2x(x: torch.Tensor, h: int) -> torch.Tensor:
    """``upsample2x_align_corners(x)`` on a map of global height ``h``."""
    if _SPLIT is None:
        return upsample2x_align_corners(x)
    return _rule(x, h, 2 * h, upsample2x_align_corners, _upsample_block)


@functools.lru_cache(maxsize=64)
def _upsample_rows(h: int, rank: int, size: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """The rows of the global (2h, h) align-corners interpolation matrix
    (float64 weights, cast) that spatial rank ``rank`` of ``size`` owns,
    over its block's input rows with one row of halo each side."""
    out, n = 2 * h, h // size
    src = np.arange(out) * ((h - 1) / (out - 1) if out > 1 else 0.0)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, h - 1)
    w = src - lo
    m = np.zeros((out, h + 2))  # columns: rows -1 .. h of the map
    np.add.at(m, (np.arange(out), lo + 1), 1.0 - w)
    np.add.at(m, (np.arange(out), hi + 1), w)
    rows = m[2 * rank * n:2 * (rank + 1) * n, rank * n:rank * n + n + 2]
    return torch.from_numpy(np.ascontiguousarray(rows)).to(device, dtype)


def _upsample_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype ``upsample2x_align_corners(x)`` returns under the current
    autocast: float32 for a bf16 input on CUDA, bf16 on the CPU."""
    dev = x.device.type
    if not torch.is_autocast_enabled(dev):
        return x.dtype
    return _autocast_upsample_dtype(dev, x.dtype,
                                    torch.get_autocast_dtype(dev))


@functools.lru_cache(maxsize=None)
def _autocast_upsample_dtype(dev: str, dtype: torch.dtype,
                             low: torch.dtype) -> torch.dtype:
    with torch.autocast(dev, dtype=low):
        return upsample2x_align_corners(
            torch.zeros(1, 1, 2, 2, dtype=dtype, device=dev)).dtype


def _upsample_block(x: torch.Tensor) -> torch.Tensor:
    """The align-corners 2x upsample of a split block: a 1-row halo, the
    width interpolated whole (the height kept: an identity at
    align-corners), then the block's rows of the height matrix; in float32
    at least, outside autocast, rounded once to the dtype that
    ``F.interpolate`` gives under it."""
    split = _SPLIT
    n = x.shape[2]
    out = _upsample_dtype(x)
    acc = torch.promote_types(x.dtype, torch.float32)
    with torch.autocast(x.device.type, enabled=False):
        xh = halo(x, 1, 1).to(acc)
        y = F.interpolate(xh, size=(n + 2, 2 * x.shape[3]), mode="bilinear",
                          align_corners=True)
        rows = _upsample_rows(n * split.size, split.rank, split.size, acc,
                              x.device)
        return torch.matmul(rows, y).to(out)
