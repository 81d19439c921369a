"""The tensor-parallel 'model' axis (the JAX package's ``param_shardings``,
``parallel/mesh.py:84-119``, applied to the whole train state by its
``train/siamese.py:134-143`` and ``train/gan.py:96-106``).

The rule (``shard_plan``), restated on torch modules: a leaf is sharded
over a 'model' extent m when it is

  * a 4-D conv weight whose output-channel dim is at least ``MIN_SIZE``
    (256) and divides by m.  JAX's kernels are HWIO, the output channels
    last; torch keeps them in dim 0 of a ``Conv2d`` weight (O, I, kh, kw)
    and in dim 1 of a ``ConvTranspose2d`` weight (I, O, kh, kw);
  * a 1-D vector of such a size: conv biases, BatchNorm weights, biases,
    running means and variances (and so the Adam moments that mirror
    them).

Everything else is replicated, and so is everything when m is 1.  Rank k
of the model group holds the contiguous block [k C/m, (k+1) C/m) of the
sharded dim, as XLA lays out a sharded dim.

``shard_model`` cuts a model's leaves to the rank's blocks in place: the
same modules, ``state_dict`` keys and parameter order, with shard shapes.
Wide convs become ``ShardedConv2d`` / ``ShardedConvTranspose2d`` and wide
BatchNorms ``GlobalBatchNorm2d`` with a ``model_shard``
(``batchnorm.py``).  Every rank of a model group runs the whole forward
on the same rows (the batch is split over 'data' only, as in JAX,
``train/siamese.py:269-290``), so:

  * a sharded weight is gathered over the model group where it is used,
    and the gather's backward is the slice of the full gradient: every
    rank of the group computed the same full gradient from the same rows,
    so no reduce-scatter is needed; the shard gradients are then summed
    over the data group as on a data mesh;
  * a conv keeps only its input and its shard for the backward
    (``_ShardedConv``), which gathers the weight again: no full weight
    lives from the forward to the backward, so parameters, gradients,
    Adam moments and G's EMA all take 1/m of a rank's memory for the
    sharded leaves;
  * the math is the unsharded step's: the gathered weight is the same
    tensor, the convolution the same call (``torch.convolution``, its
    backward ``aten.convolution_backward`` with autograd's arguments), so
    a (data d, model m) step gives a (data d) step's bits.

The gather is an all-reduce of an integer view of a zero-filled buffer
into which each rank writes its block (``gather_value``): adding integer
zeros is exact for every bit pattern (a float sum with +0.0 would turn
-0.0 into +0.0), and ``all_reduce`` runs on every backend the port uses,
gloo with CUDA tensors included.  16-bit floats go through float32,
exactly.

Checkpoints hold the whole state: ``whole_state_dict`` and
``whole_optimizer_state`` gather every sharded leaf (a collective: every
rank of the model group calls them), ``cut_state_dict`` and
``cut_optimizer_state`` cut a rank's blocks from whole tensors
(``checkpoint.py``).
"""

from __future__ import annotations

import dataclasses
import math
from itertools import chain
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

MIN_SIZE = 256  # JAX param_shardings' min_size


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """A module's place on the model axis: this rank's ``rank`` of
    ``size`` in ``group``, and the dim of each sharded leaf by name."""

    group: Any
    rank: int
    size: int
    dims: Dict[str, int]

    def block(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of the whole tensor ``t`` along ``dim``, a
        contiguous copy."""
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.rank * n, n).clone(
            memory_format=torch.contiguous_format)


_INT_VIEW = {torch.float32: torch.int32, torch.float64: torch.int64}


def gather_value(t: torch.Tensor, dim: int, shard: ModelShard
                 ) -> torch.Tensor:
    """The whole tensor of the blocks ``t`` along ``dim`` over the model
    group (no autograd): an all-reduce of an integer view of a zeroed
    buffer that holds this rank's block (module docstring)."""
    if t.dtype not in _INT_VIEW:  # bfloat16 moments: exact via float32
        return gather_value(t.float(), dim, shard).to(t.dtype)
    size = list(t.shape)
    n = size[dim]
    size[dim] = n * shard.size
    whole = torch.zeros(size, dtype=_INT_VIEW[t.dtype], device=t.device)
    whole.narrow(dim, shard.rank * n, n).copy_(t.detach().view(
        _INT_VIEW[t.dtype]))
    dist.all_reduce(whole, group=shard.group)
    return whole.view(t.dtype)


class _Gather(torch.autograd.Function):
    """The whole tensor from a rank's block; its backward is the block of
    the whole gradient (every rank of the group computed the same)."""

    @staticmethod
    def forward(ctx, t, dim, shard):
        ctx.dim, ctx.shard = dim, shard
        return gather_value(t, dim, shard)

    @staticmethod
    def backward(ctx, grad):
        return ctx.shard.block(grad, ctx.dim), None, None


def shard_of(module: nn.Module) -> Optional[ModelShard]:
    return getattr(module, "model_shard", None)


def whole(module: nn.Module, name: str) -> Optional[torch.Tensor]:
    """``module``'s leaf ``name`` whole: gathered (differentiably) when it
    is sharded, else the leaf itself."""
    t = getattr(module, name)
    shard = shard_of(module)
    if t is None or shard is None or name not in shard.dims:
        return t
    return _Gather.apply(t, shard.dims[name], shard)


def own_block(module: nn.Module, name: str, t: torch.Tensor
              ) -> torch.Tensor:
    """This rank's block of a whole tensor ``t`` shaped as ``module``'s
    leaf ``name`` (``t`` itself when that leaf is not sharded)."""
    shard = shard_of(module)
    if shard is None or name not in shard.dims:
        return t
    return shard.block(t, shard.dims[name])


# -- the rule ---------------------------------------------------------------


def _out_dim(module: nn.Module, t: torch.Tensor) -> Optional[int]:
    """The dim of ``t`` (a leaf of ``module``) that JAX's rule reads: the
    output channels of a conv weight, dim 0 of a vector; None for a leaf
    the rule never shards (scalars)."""
    if t.dim() == 1:
        return 0
    if t.dim() == 4:
        if isinstance(module, nn.ConvTranspose2d):
            return 1
        if isinstance(module, nn.Conv2d):
            return 0
        raise NotImplementedError(
            f"no model-axis rule for a 4-D leaf of {type(module).__name__}")
    return None


def shard_plan(model: nn.Module, model_size: int) -> Dict[str, int]:
    """{``state_dict`` key: dim} of every leaf of ``model`` (parameters
    and buffers) that JAX's ``param_shardings`` shards over a 'model'
    extent of ``model_size``; empty when it is 1."""
    plan = {}
    if model_size <= 1:
        return plan
    for prefix, module in model.named_modules():
        leaves = chain(module.named_parameters(recurse=False),
                       module.named_buffers(recurse=False))
        for name, t in leaves:
            dim = _out_dim(module, t)
            if (dim is not None and t.shape[dim] >= MIN_SIZE
                    and t.shape[dim] % model_size == 0):
                plan[f"{prefix}.{name}" if prefix else name] = dim
    return plan


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Cut ``model``'s leaves that ``shard_plan`` shards over ``mesh``'s
    model axis to this rank's blocks, in place (module docstring), and
    make its BatchNorms global (``batchnorm.convert_batchnorm``).
    Returns ``model``."""
    from .batchnorm import GlobalBatchNorm2d, convert_batchnorm

    convert_batchnorm(model)
    plan = shard_plan(model, mesh.model_size)
    for prefix, module in model.named_modules():
        dims = {key.rpartition(".")[2]: dim for key, dim in plan.items()
                if key.rpartition(".")[0] == prefix}
        if not dims:
            continue
        if isinstance(module, nn.ConvTranspose2d):
            cls = ShardedConvTranspose2d
        elif isinstance(module, nn.Conv2d):
            cls = ShardedConv2d
        elif isinstance(module, GlobalBatchNorm2d):
            cls = GlobalBatchNorm2d
        else:
            raise NotImplementedError(
                f"{prefix}: no model-axis forward for "
                f"{type(module).__name__}")
        if isinstance(module, nn.Conv2d) and module.padding_mode != "zeros":
            raise NotImplementedError(f"{prefix}: padding_mode "
                                      f"{module.padding_mode!r}")
        shard = ModelShard(mesh.model_group, mesh.model_rank,
                           mesh.model_size, dims)
        for name, dim in dims.items():
            block = shard.block(getattr(module, name).detach(), dim)
            if name in module._parameters:
                param = nn.Parameter(block, requires_grad=module._parameters[
                    name].requires_grad)
                param.model_sharded = True  # DataMesh.reduce_gradients
                module._parameters[name] = param
            else:
                module._buffers[name] = block
        module.model_shard = shard
        module.__class__ = cls
    return model


# -- the convolutions -------------------------------------------------------


class _ShardedConv(torch.autograd.Function):
    """``conv``'s convolution of ``x`` with its gathered weight (input
    channels [start, start + count) of it when ``count`` is given) and a
    whole ``bias`` (or None), under the caller's autocast as
    ``F.conv2d`` runs it, with ``padding`` in place of the module's when
    given.  Keeps the input and the shard for the backward, which gathers
    the weight again."""

    @staticmethod
    def forward(ctx, x, weight, bias, conv, start, count, padding):
        dev = x.device.type
        low = (torch.get_autocast_dtype(dev)
               if torch.is_autocast_enabled(dev) else None)

        def cast(t):  # autocast's rule: floating, not float64
            if (low is None or t is None or not t.is_floating_point()
                    or t.dtype == torch.float64):
                return t
            return t.to(low)

        w = cast(_conv_weight(conv, weight, start, count))
        xc, bc = cast(x), cast(bias)
        args = _conv_args(conv, padding)
        with torch.autocast(dev, enabled=False):
            y = torch.convolution(xc, w, bc, *args)
        ctx.save_for_backward(xc, weight)
        ctx.conv, ctx.start, ctx.count, ctx.args = conv, start, count, args
        ctx.dtypes = (x.dtype, bias.dtype if bias is not None else None)
        ctx.bias_sizes = None if bias is None else list(bias.shape)
        return y

    @staticmethod
    def backward(ctx, gy):
        xc, weight = ctx.saved_tensors
        conv = ctx.conv
        w = _conv_weight(conv, weight, ctx.start, ctx.count).to(xc.dtype)
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        gx, gw, gb = torch.ops.aten.convolution_backward(
            gy, xc, w, ctx.bias_sizes, *ctx.args,
            [need_x, need_w, need_b and ctx.bias_sizes is not None])
        x_dtype, b_dtype = ctx.dtypes
        if gx is not None:
            gx = gx.to(x_dtype)
        if gw is not None:
            gw = gw.to(weight.dtype)
            shard = conv.model_shard
            dim = shard.dims["weight"]
            if ctx.count is not None:  # the slice's place in the weight
                in_dim = 0 if conv.transposed else 1
                size = list(gw.shape)
                size[in_dim] = weight.shape[in_dim]
                full = gw.new_zeros(size)
                full.narrow(in_dim, ctx.start, ctx.count).copy_(gw)
                gw = full
            gw = shard.block(gw, dim)
        if gb is not None:
            gb = gb.to(b_dtype)
        return gx, gw, gb, None, None, None, None


def _conv_weight(conv, weight, start, count):
    """The gathered weight of ``conv`` from its shard ``weight``, or its
    input channels [start, start + count)."""
    shard = conv.model_shard
    w = gather_value(weight, shard.dims["weight"], shard)
    if count is not None:
        w = w.narrow(0 if conv.transposed else 1, start, count)
    return w


def _conv_args(conv, padding=None):
    """``torch.convolution``'s arguments after the bias, as ``F.conv2d``
    and ``F.conv_transpose2d`` give them (``padding`` in place of the
    module's when given)."""
    return (list(conv.stride), list(padding or conv.padding),
            list(conv.dilation), conv.transposed, list(conv.output_padding),
            conv.groups)


def sharded_conv(conv: nn.Module, x: torch.Tensor, start: int = 0,
                 count: Optional[int] = None, bias: bool = True,
                 padding=None) -> torch.Tensor:
    """The convolution of a sharded conv module (its bias when ``bias``);
    of its input channels [start, start + count) when ``count`` is given;
    with ``padding`` in place of the module's when given (a block of the
    'spatial' axis, ``spatial.py``)."""
    b = whole(conv, "bias") if bias else None
    return _ShardedConv.apply(x, conv.weight, b, conv, start, count, padding)


class ShardedConv2d(nn.Conv2d):
    """A ``Conv2d`` whose weight (and bias) hold this rank's block of the
    output channels (``shard_model``)."""

    model_shard: Optional[ModelShard] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sharded_conv(self, x)


class ShardedConvTranspose2d(nn.ConvTranspose2d):
    """A ``ConvTranspose2d`` whose weight holds this rank's block of the
    output channels, dim 1 (``shard_model``)."""

    model_shard: Optional[ModelShard] = None

    def forward(self, x: torch.Tensor, output_size=None) -> torch.Tensor:
        if output_size is not None:
            raise NotImplementedError("output_size under the model axis")
        return sharded_conv(self, x)


def conv_input_slice(conv: nn.Conv2d, x: torch.Tensor,
                     start: int) -> torch.Tensor:
    """``conv``'s convolution, without its bias, of ``x`` with the input
    channels [start, start + x.shape[1]) of its weight (the slices of
    ``models/blocks.sliced_conv2d``)."""
    count = x.shape[1]
    if shard_of(conv) is None:
        return F.conv2d(x, conv.weight[:, start:start + count], None,
                        conv.stride, conv.padding)
    return sharded_conv(conv, x, start, count, bias=False)


# -- whole states and their blocks -----------------------------------------


def _leaf_shards(model: nn.Module) -> Dict[str, tuple]:
    """{``state_dict`` key: (ModelShard, dim)} of ``model``'s sharded
    leaves."""
    out = {}
    for prefix, module in model.named_modules():
        shard = shard_of(module)
        if shard is not None:
            for name, dim in shard.dims.items():
                out[f"{prefix}.{name}" if prefix else name] = (shard, dim)
    return out


def whole_state_dict(model: nn.Module, state_dict=None) -> Dict[str, Any]:
    """``state_dict`` (``model.state_dict()`` when None; a dict by
    ``model``'s keys, such as G's EMA) with every sharded leaf gathered:
    the one-process state.  A collective over the model group; the same
    dict when nothing is sharded."""
    sd = model.state_dict() if state_dict is None else state_dict
    leaves = _leaf_shards(model)
    if not leaves:
        return sd
    return {k: gather_value(v, leaves[k][1], leaves[k][0]) if k in leaves
            else v for k, v in sd.items()}


def cut_state_dict(model: nn.Module, state_dict) -> Dict[str, Any]:
    """A whole ``state_dict`` (or a dict by ``model``'s keys) with this
    rank's block of every leaf that ``model`` shards."""
    leaves = _leaf_shards(model)
    if not leaves:
        return state_dict
    return {k: leaves[k][0].block(v, leaves[k][1]) if k in leaves else v
            for k, v in state_dict.items()}


def _param_shards(model: nn.Module, optimizer) -> List[Optional[tuple]]:
    """(ModelShard, dim) or None for each of ``optimizer``'s parameters,
    in its order (its state's indices)."""
    leaves = _leaf_shards(model)
    names = {id(p): name for name, p in model.named_parameters()}
    return [leaves.get(names[id(p)]) for group in optimizer.param_groups
            for p in group["params"]]


_MOMENT_KEYS = ("exp_avg", "exp_avg_sq", "acc")  # OptaxAdam's lists


def _map_optimizer_state(model, optimizer, state_dict, fn, whole_in):
    """``state_dict`` (an optimizer's) with ``fn(t, shard, dim)`` applied
    to every tensor that mirrors a sharded parameter: torch.optim's
    per-parameter state, ``OptaxAdam``'s moment lists and, flattened, each
    parameter's piece of its flat vectors (shard-sized pieces, or whole
    ones when ``whole_in``)."""
    shards = _param_shards(model, optimizer)
    if not any(shards):
        return state_dict
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def one(t, s):
        return t if s is None or t.dim() == 0 else fn(t, *s)

    out = dict(state_dict)
    if "layout" not in state_dict:  # torch.optim
        out["state"] = {i: {k: one(v, shards[i]) if torch.is_tensor(v)
                            else v for k, v in st.items()}
                        for i, st in state_dict["state"].items()}
        return out
    for key in _MOMENT_KEYS:
        ts = state_dict.get(key)
        if ts is None:
            continue
        if not state_dict["layout"]["flat"]:
            out[key] = [one(t, s) for t, s in zip(ts, shards)]
            continue
        shapes = [_whole_shape(p, s) if whole_in else p.shape
                  for p, s in zip(params, shards)]
        pieces = ts[0].split([math.prod(sh) for sh in shapes])
        out[key] = [torch.cat([one(t.view(sh), s).reshape(-1) for t, sh, s
                               in zip(pieces, shapes, shards)])]
    return out


def _whole_shape(p: torch.Tensor, s) -> torch.Size:
    if s is None:
        return p.shape
    shard, dim = s
    size = list(p.shape)
    size[dim] *= shard.size
    return torch.Size(size)


def whole_optimizer_state(model: nn.Module, optimizer) -> Dict[str, Any]:
    """``optimizer.state_dict()`` of a sharded model's optimizer as one
    process's: every moment of a sharded parameter gathered, flat moments
    re-laid as the whole parameters' vector.  A collective over the model
    group; the same dict when nothing is sharded."""
    return _map_optimizer_state(
        model, optimizer, optimizer.state_dict(),
        lambda t, shard, dim: gather_value(t, dim, shard), whole_in=False)


def cut_optimizer_state(model: nn.Module, optimizer,
                        state_dict) -> Dict[str, Any]:
    """A one-process optimizer ``state_dict`` cut to this rank's blocks,
    for ``optimizer`` over ``model``'s sharded parameters."""
    return _map_optimizer_state(
        model, optimizer, state_dict,
        lambda t, shard, dim: shard.block(t, dim), whole_in=True)

