"""BatchNorm over the global batch (the JAX package's BatchNorm under a
mesh, ``models/siamese_unet.py:16-19``: XLA reduces its statistics over
the 'data' axis).

``convert_batchnorm(model)`` makes every ``nn.BatchNorm2d`` of ``model`` a
``GlobalBatchNorm2d`` in place: the same module objects, parameters,
buffers and ``state_dict`` keys.  A ``GlobalBatchNorm2d`` is
``nn.BatchNorm2d`` (``F.batch_norm``, the same bits) except in train mode
inside ``global_statistics(group)`` with a group, where each rank holds a
shard of the batch:

  * each channel's sum and the element count are summed over the ranks,
    the mean taken, then each channel's sum of (x - mean)^2, all through
    a differentiable all-reduce (``all_reduce_sum``: its backward
    all-reduces the gradient), so that the backward is the global
    batch's too;
  * the running statistics update once with that mean and variance, the
    variance times N/(N-1) with the global N, as torch's does with the
    local one (ROADMAP §C1; with ``--batched-encoder`` N = 2B.H.W).

``torch.nn.SyncBatchNorm`` serves neither the CPU (it raises on CPU
tensors) nor the recomputation of ``--remat``, which needs a pass that
leaves the running statistics alone: ``GlobalBatchNorm2d.normalize(x,
update_stats=False)``, called by ``models/blocks.py``'s stateless pass.
The group is read when the module runs: a recomputation inside the
backward enters the state its forward saw (``current``), and so reduces
over the same group in the same order on every rank.

Under the tensor-parallel 'model' axis (``tensor.py``) the group is the
mesh's data group: the ranks of a model group hold the same rows, so the
statistics are never summed over them.  A wide BatchNorm's leaves hold
this rank's block of the channels (``model_shard``): its weight and bias
are gathered where they are used, as the convs' weights are, and its
running mean and variance are updated from the whole statistics, which
every rank of the model group computes, block by block.  Outside
``global_statistics`` (a replicated step, evaluation) such a module runs
``F.batch_norm`` on its gathered leaves and keeps its block of the
running statistics it updated.

Under the 'spatial' axis (``spatial.py``) a train-mode BatchNorm whose
map is split (``spatial.here()``) takes its statistics over the split's
``stats_group``: data x spatial in a sharded step, the spatial group in a
replicated one.  One whose map runs whole holds the whole map on every
spatial rank, so it reduces over the data group as above (in a sharded
step) or not at all.  The running statistics take C1's unbiased form with
the global count either way.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from . import spatial
from .tensor import gather_value, own_block, shard_of, whole

# The group whose ranks hold the shards of the batch in flight, set by
# ``global_statistics``; None: each rank's batch is the whole batch.  A
# module global, not a thread-local: autograd may run a recomputation on
# its own thread.
_GROUP = None
_ACTIVE = False


class _Statistics:
    """Sets ``_GROUP`` and ``_ACTIVE`` for a block and restores them after
    (one block at a time: it may be entered again once it has exited)."""

    def __init__(self, group, active):
        self.state = group, active

    def __enter__(self):
        global _GROUP, _ACTIVE
        self.prev = _GROUP, _ACTIVE
        _GROUP, _ACTIVE = self.state

    def __exit__(self, *exc):
        global _GROUP, _ACTIVE
        _GROUP, _ACTIVE = self.prev


def global_statistics(group=None) -> _Statistics:
    """Within: train-mode ``GlobalBatchNorm2d`` take their statistics over
    the shards of ``group``'s ranks (None: the default group).  Outside,
    over the rank's own batch, as a replicated step needs."""
    return _Statistics(group, True)


def current() -> _Statistics:
    """The state as it is now, to enter again later (a recomputation in
    the backward, ``models/blocks.py``)."""
    return _Statistics(_GROUP, _ACTIVE)


def reducing() -> bool:
    """Whether train-mode BatchNorm reduces over ranks now."""
    return _ACTIVE or spatial.here() is not None


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks of ``group``; its gradient is the sum over
    the ranks of the gradients (each rank's output feeds its own loss
    terms)."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``tensor`` over the ranks of ``group``."""
    return _AllReduceSum.apply(tensor, group)


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode statistics are the global
    batch's inside ``global_statistics`` (module docstring).  Adds no
    state: ``convert_batchnorm`` swaps the class of existing modules, and
    ``tensor.shard_model`` sets ``model_shard`` on a wide one."""

    model_shard = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if reducing() and self.training and self.track_running_stats:
            return self.normalize(x, update_stats=True)
        if self.model_shard is None:
            return super().forward(x)
        return self._forward_whole(x)

    def _forward_whole(self, x: torch.Tensor) -> torch.Tensor:
        """``nn.BatchNorm2d.forward`` on the gathered leaves of a sharded
        module; its blocks of the running statistics take the update."""
        self._check_input_dim(x)
        factor = 0.0 if self.momentum is None else self.momentum
        if self.training and self.track_running_stats:
            self.num_batches_tracked.add_(1)
            if self.momentum is None:
                factor = 1.0 / float(self.num_batches_tracked)
        shard = shard_of(self)
        running = [gather_value(getattr(self, name), 0, shard)
                   if name in shard.dims else getattr(self, name)
                   for name in ("running_mean", "running_var")]
        y = F.batch_norm(x, *running, whole(self, "weight"),
                         whole(self, "bias"), self.training, factor,
                         self.eps)
        if self.training:
            with torch.no_grad():
                for name, t in zip(("running_mean", "running_var"),
                                   running):
                    getattr(self, name).copy_(own_block(self, name, t))
        return y

    def normalize(self, x: torch.Tensor, update_stats: bool) -> torch.Tensor:
        """The global train-mode BatchNorm of this rank's shard ``x``
        (N, C, H, W): statistics in float32 (float64 for float64 input),
        the output in ``x``'s dtype; the running statistics updated when
        ``update_stats``.  Over the split's statistics group when the map
        is split, else over ``global_statistics``' group."""
        self._check_input_dim(x)
        split = spatial.here()
        group = _GROUP if split is None else split.stats_group
        acc = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(acc)
        dims = (0, 2, 3)
        c = x.shape[1]
        local = xf.sum(dims)
        packed = all_reduce_sum(torch.cat([local, local.new_full(
            (1,), x.numel() // c)]), group)
        count = packed[c]
        mean = packed[:c] / count
        centered = xf - mean.view(1, c, 1, 1)
        var = all_reduce_sum((centered * centered).sum(dims),
                             group) / count
        y = centered * torch.rsqrt(var + self.eps).view(1, c, 1, 1)
        if self.affine:
            y = (y * whole(self, "weight").to(acc).view(1, c, 1, 1)
                 + whole(self, "bias").to(acc).view(1, c, 1, 1))
        if update_stats:
            self._update_running(mean.detach(), var.detach(), count)
        return y.to(x.dtype)

    @torch.no_grad()
    def _update_running(self, mean, var, count) -> None:
        """The running statistics' update from the whole statistics (this
        rank's block of them under the model axis)."""
        self.num_batches_tracked.add_(1)
        m = (self.momentum if self.momentum is not None
             else 1.0 / self.num_batches_tracked.double())
        unbiased = var * (count / (count - 1))
        rm, rv = self.running_mean, self.running_var
        rm.mul_(1 - m).add_(m * own_block(self, "running_mean", mean)
                            .to(rm.dtype))
        rv.mul_(1 - m).add_(m * own_block(self, "running_var", unbiased)
                            .to(rv.dtype))


def convert_batchnorm(model: nn.Module) -> nn.Module:
    """Make every ``nn.BatchNorm2d`` of ``model`` a ``GlobalBatchNorm2d``,
    in place (the same objects, parameters, buffers and keys); returns
    ``model``."""
    for m in model.modules():
        if type(m) is nn.BatchNorm2d:
            m.__class__ = GlobalBatchNorm2d
    return model
