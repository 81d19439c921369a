"""Siamese U-Net training and inference (the JAX package's
``train/siamese.py``).

``SiameseTrainer`` holds the model, the optimizer and the loss.  A train
step gathers its batch from the device cache by a device index tensor,
augments it (``augment=True``) or normalizes it to [-1, 1], runs the
train-mode forward under ``compute_precision``, the FocalDice loss through
the fused kernels' wrapper, the backward and the optimizer step.  The
epoch loss is the mean of the per-batch losses (reference train.py:147),
read once per epoch.

Augmentation draws its parameters on the device from the trainer's
``generator`` and runs the chain of ``data/transforms.py``: on the padded
native-size cache with ``native_out_size``, else on the target-size cache.
Validation never augments.

The model and the optimizer take the JAX package's knobs from the config
(its train/siamese.py:88-98): ``batched_encoder``, ``concat_free`` and
``remat`` shape the model (``models/siamese_unet.py``); the optimizer's
``opt_momentum_dtype``, ``opt_flat_state`` and ``grad_accum`` pick
``train.optim.OptaxAdam`` over torch's Adam(W).  Under ``grad_accum`` a
step still runs one forward and one backward on its batch, and the
optimizer applies the mean of the last k gradients on every k-th.  By
default training runs the two-pass encoder: each image gets its own
train-mode BatchNorm statistics, as in the reference.

Two observability hooks, both off by default, are set by the pipeline
(``--profile-dir``, ``--debug-nans``): ``step_timer`` (a
``utils.profiling.StepTimer``) times each step up to a device sync, and
``nan_checks`` checks each step's loss and gradients before the optimizer
step.  With neither, a step makes no host sync.

``train_epoch_streaming`` trains from a ``data.stream.StreamingSource``
(``--stream host|decode``) with the same batch-level step,
``train_batch``, as the resident path; there is no native-size variant,
so an augmented streamed epoch runs the fixed-size chain.

With a ``mesh`` (``parallel/mesh.py``; the JAX package's data axis) the
trainer is one rank of a data-parallel group.  Each batch of the one
epoch order is split into the ranks' row blocks when its size divides by
the world size, else replicated.  The augmentation draws for the whole
global batch from the one generator, as every rank does, and each rank
takes its rows' draws (JAX draws, then shards).  A sharded step takes
its BatchNorm statistics (``parallel/batchnorm.py``) and its FocalDice
loss over the global batch and sums the gradients over the ranks; a
replicated one runs the whole batch alone and takes rank 0's gradients.
Either way one update equals the single-device update on the global
batch, up to the order of the sums.  A streamed rank stages only its
rows of a sharded batch.  ``validate`` splits each batch the same way
and gives every rank the single-device value.

A mesh with a 'model' axis (``make_mesh(n, ("data", "model"), (d, m))``;
the JAX package's ``param_shardings``) shards the model's wide leaves,
and so the optimizer's moments, over its model group
(``parallel/tensor.py``).  The mesh's ``world_size``, ``rank`` and
``group`` are its data axis, which everything above reads: the rows, the
BatchNorm statistics, the loss's global count and the gradient sums are
the (data d) mesh's, and the ranks of a model group run the same rows.

A mesh with a 'spatial' axis (``make_mesh(n, ("data", "spatial"[,
"model"]), (d, s[, m]))``; JAX's ``P(data, spatial, None, None)`` on the
batch) splits the height of every map the split rule allows over its
spatial group (``parallel/spatial.py``).  ``_prepare`` augments or
normalizes the rank's rows whole, as without the axis, and ``train_batch``
then cuts the rank's height block of the images and labels: each spatial
rank repeats its rows' augmentation, so the draws and the contrast's
masked gray mean are per image, the (data d) step's.  A split map's
BatchNorm statistics, the FocalDice loss (its global form, N = the
block's elements x d x s) and the gradients sum over data x spatial in a
sharded step, over the spatial group in a replicated one
(``DataMesh.sum_group``).  ``validate`` runs split the same way and gives
every rank the single-device value.  ``--concat-free`` (its sliced convs
take the rule slice by slice) and ``--remat`` (each block's recomputation
in the backward re-enters the state of its forward, exchanges and
BatchNorm reductions included) run under the axis as without it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from ..config import SiameseTrainConfig
from ..data.stream import BatchPut, prefetch_batches
from ..data.transforms import (
    augment_batch,
    augment_batch_native,
    normalize,
    sample_augment_params,
)
from ..device import resolve_device, tf32_off
from ..models.siamese_unet import SiameseUNet
from ..ops.kernels.fused_loss import focal_dice_loss_fused
from ..parallel import spatial
from ..parallel.batchnorm import convert_batchnorm, global_statistics
from ..parallel.tensor import shard_model
from ..utils.profiling import step_guard, sync
from .optim import make_optimizer

COMPUTE_DTYPES = ("float32", "bfloat16")


def step_label(epoch, step: int) -> str:
    """The place of a step in a run, for error messages."""
    return f"step {step}" if epoch is None else f"epoch {epoch}, step {step}"


@contextlib.contextmanager
def compute_precision(compute_dtype: str, device_type: str):
    """``"float32"``: full float32, TF32 off for convolutions (cuDNN) and
    matrix products.  ``"bfloat16"``: autocast to bf16 (the JAX eval
    default, config.py:265)."""
    if compute_dtype == "float32":
        with tf32_off():
            yield
    elif compute_dtype == "bfloat16":
        with torch.autocast(device_type, dtype=torch.bfloat16):
            yield
    else:
        raise ValueError(
            f"compute_dtype must be one of {COMPUTE_DTYPES}, got "
            f"{compute_dtype!r}"
        )


@torch.no_grad()
def predict(model: nn.Module, img1: torch.Tensor, img2: torch.Tensor,
            compute_dtype: str = "bfloat16") -> torch.Tensor:
    """Sigmoid probabilities for [0,1]-range NHWC images: normalize, eval
    forward, sigmoid.  Returns (B, H, W, n_classes) float32.

    The permutes to and from NCHW are views: an NHWC view of an NCHW
    tensor (as the pipeline passes its device cache) reaches the model
    without a copy."""
    x1 = normalize(img1.permute(0, 3, 1, 2))
    x2 = normalize(img2.permute(0, 3, 1, 2))
    return predict_normalized(model, x1, x2,
                              compute_dtype).permute(0, 2, 3, 1)


@torch.no_grad()
def predict_normalized(model: nn.Module, x1: torch.Tensor, x2: torch.Tensor,
                       compute_dtype: str = "bfloat16") -> torch.Tensor:
    """Sigmoid probabilities of the eval forward on NCHW inputs that are
    already normalized: (B, n_classes, H, W) float32."""
    model.eval()
    with compute_precision(compute_dtype, x1.device.type):
        logits = model(x1, x2)
    return torch.sigmoid(logits.float())


class SiameseTrainer:
    """Model, optimizer and loss of Siamese training on one device, or on
    one rank of a data mesh.  The model is ``init_model(config.seed)``,
    moved to ``device``; the optimizer is built over its parameters, so
    weights loaded later with ``model.load_state_dict`` stay the ones it
    updates."""

    def __init__(self, config: SiameseTrainConfig, device="cuda",
                 augment: bool = False, native_out_size=None, mesh=None):
        """``native_out_size`` = (H, W) switches the augmented train step
        to the native-resolution chain: the train cache must then be a
        ``pipelines.NativeDeviceCache``, and each batch is augmented at
        its native size and resized to (H, W).  ``mesh``: a
        ``parallel.mesh.DataMesh`` of more than one rank (the trainer then
        runs on ``mesh.device``, its BatchNorms global, its wide leaves
        sharded under a 'model' axis), or None."""
        self.config = config
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(device))
        self.augment = augment
        self.native_out_size = (tuple(native_out_size)
                                if augment and native_out_size else None)
        # The augmentation parameters' only source; the pipeline reseeds
        # it when a run starts.
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        model = self.init_model(config.seed)
        if self.mesh is not None:
            convert_batchnorm(model)
            if self.mesh.model_size > 1:  # cut on the host: never whole
                shard_model(model, self.mesh)  # on the card
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(
            config.optimizer, self.model.parameters(), config.learning_rate,
            config.weight_decay, mu_dtype=config.opt_momentum_dtype,
            flat_state=config.opt_flat_state, grad_accum=config.grad_accum)
        self.loss_kwargs = dict(
            beta=config.loss_beta, focal_gamma=config.focal_gamma,
            focal_alpha=config.focal_alpha, dice_smooth=config.dice_smooth)
        # Observability hooks (utils/profiling.py), off by default.
        self.step_timer = None
        self.nan_checks = False

    def init_model(self, seed: int) -> SiameseUNet:
        """A freshly initialized SiameseUNet (on the CPU) from ``seed``,
        with the config's model knobs (which leave the init as it is),
        without touching the global generator's state."""
        cfg = self.config
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            return SiameseUNet(cfg.n_channels, cfg.n_classes,
                               batched_encoder=cfg.batched_encoder,
                               concat_free=cfg.concat_free, remat=cfg.remat)

    def loss(self, logits: torch.Tensor, labels: torch.Tensor,
             sharded: bool = False) -> torch.Tensor:
        """FocalDice of (B, 1, H, W) logits against (B, H, W) labels; of
        the global batch when they are this rank's shard (``sharded``) or
        its height block (a 'spatial' axis)."""
        over = (self.mesh.sum_group(sharded) if self.mesh is not None
                else None)
        if over is None:
            return focal_dice_loss_fused(logits, labels, **self.loss_kwargs)
        group, ranks = over
        return focal_dice_loss_fused(
            logits, labels, **self.loss_kwargs, group=group,
            n_total=logits.numel() * ranks)

    def _batch(self, cache, idx: torch.Tensor):
        """The gather: the cache rows ``idx`` (a device index tensor) as
        NCHW [0, 1] images, labels and, from a native-size cache, their
        native sizes (else None)."""
        sizes = (cache.sizes.index_select(0, idx)
                 if self.native_out_size is not None else None)
        return (cache.img1.index_select(0, idx),
                cache.img2.index_select(0, idx),
                cache.labels.index_select(0, idx), sizes)

    def _full_sizes(self, b: int, img1: torch.Tensor) -> torch.Tensor:
        """(b, 2) sizes of ``img1``'s full (H, W), filled on the device: no
        host-to-device copy in a step."""
        sizes = torch.full((b, 2), img1.shape[2], device=self.device)
        sizes[:, 1] = img1.shape[3]
        return sizes

    def _prepare(self, img1, img2, labels, sizes=None, params=None):
        """The train step's input from a batch: augmented with ``params``
        (drawn from ``generator`` when None) or normalized.  Returns NCHW
        images in [-1, 1] and labels."""
        if not self.augment:
            return normalize(img1), normalize(img2), labels
        if sizes is None:
            sizes = self._full_sizes(img1.shape[0], img1)
        if params is None:
            params = sample_augment_params(self.generator, sizes)
        # The chain takes NHWC views of the NCHW rows and ends in the
        # [-1, 1] normalize.
        nhwc = (img1.permute(0, 2, 3, 1), img2.permute(0, 2, 3, 1), labels)
        if self.native_out_size is not None:
            img1, img2, labels = augment_batch_native(
                *nhwc, sizes, self.native_out_size, params)
        else:
            img1, img2, labels = augment_batch(*nhwc, params)
        return img1.permute(0, 3, 1, 2), img2.permute(0, 3, 1, 2), labels

    def train_step(self, cache, idx: torch.Tensor, params=None,
                   where: str = "") -> torch.Tensor:
        """One optimization step on the cache rows ``idx`` (a device index
        tensor): the gather, then ``train_batch``.  Under a mesh ``idx`` is
        the global batch and ``params`` its draws: the rank gathers its
        rows of a sharded batch."""
        if self.mesh is None:
            img1, img2, labels, sizes = self._batch(cache, idx)
            return self.train_batch(img1, img2, labels, params, where, sizes)
        rows = self.mesh.rows(len(idx))
        if self.augment and params is None:
            # Every rank draws for the whole global batch, as the one
            # generator of a single device does.
            params = sample_augment_params(
                self.generator, cache.sizes.index_select(0, idx)
                if self.native_out_size is not None
                else self._full_sizes(len(idx), cache.img1))
        params = _rows_of(params, rows)
        img1, img2, labels, sizes = self._batch(
            cache, idx if rows is None else idx[rows])
        return self.train_batch(img1, img2, labels, params, where, sizes,
                                sharded=rows is not None)

    def train_batch(self, img1: torch.Tensor, img2: torch.Tensor,
                    labels: torch.Tensor, params=None, where: str = "",
                    sizes=None, sharded: bool = False) -> torch.Tensor:
        """One optimization step on a batch of NCHW [0, 1] images and
        (B, H, W) float labels on the device, the body that the resident
        and the streamed paths share (the JAX package's
        ``_train_step_batch``): augmented with ``params`` (a
        ``sample_augment_params`` dict; drawn from ``generator`` when None)
        if the trainer augments, at the native ``sizes`` on the native
        chain, else normalized.  Returns the batch loss as a detached 0-dim
        device tensor (no host sync unless ``nan_checks``, whose error
        names ``where``).  Under ``grad_accum`` the optimizer step applies
        an update only on every k-th call.  Under a mesh the batch is this
        rank's shard of the global batch (``sharded``; ``params`` then its
        rows' draws) or the whole replicated batch, and the loss is the
        global batch's."""
        img1, img2, labels = self._prepare(img1, img2, labels, sizes, params)
        split = self.mesh.split(sharded) if self.mesh is not None else None
        img1, img2, labels = _height_block(split, img1, img2, labels)
        self.model.train()
        # At float32 the backward's convolutions run without TF32 too.
        with (tf32_off() if self.config.compute_dtype == "float32"
              else contextlib.nullcontext()), (
                global_statistics(self.mesh.group) if sharded
                else contextlib.nullcontext()):
            with compute_precision(self.config.compute_dtype,
                                   self.device.type), \
                    spatial.splitting(split):
                logits = self.model(img1, img2)
            loss = (self.loss(logits, labels, sharded=True) if sharded
                    else self.loss(logits, labels))
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        if self.mesh is not None:
            self.mesh.reduce_gradients(self.model.parameters(), sharded)
        if self.nan_checks:
            step_guard(loss, self.model, where)
        self.optimizer.step()
        return loss.detach()

    def train_epoch(self, cache, epoch_rng: np.random.RandomState,
                    epoch=None) -> float:
        """One shuffled pass: the order is one ``epoch_rng.permutation(n)``;
        full batches first, then the partial final batch, which is kept
        (reference DataLoader drop_last=False).  Returns the mean of the
        per-batch losses.  ``epoch`` names the epoch in a NaN check's
        error."""
        bs = self.config.batch_size
        n = len(cache)
        perm = torch.from_numpy(epoch_rng.permutation(n)).to(self.device)
        losses = [self._observed(self.train_step, cache,
                                 perm[start:start + bs], epoch=epoch, step=i)
                  for i, start in enumerate(range(0, n, bs), 1)]
        return _mean(losses)

    def train_epoch_streaming(self, source, epoch_rng: np.random.RandomState,
                              epoch=None, depth: int = 2) -> float:
        """``train_epoch`` fed from a ``data.stream.StreamingSource``: the
        same order (one ``epoch_rng.permutation(n)``), the partial final
        batch kept, the mean of the per-batch losses, and ``train_batch``
        for each batch.  Host batches are assembled and copied to the
        device ``depth`` batches ahead (``data.stream.prefetch_batches``),
        so device memory holds O(depth) batches, not the corpus."""
        bs = self.config.batch_size
        n = len(source)
        perm = epoch_rng.permutation(n)
        batches = [perm[s:s + bs] for s in range(0, n, bs)]
        rows = [self.mesh.rows(len(b)) if self.mesh is not None else None
                for b in batches]
        staged_rows = [b if r is None else b[r] for b, r in zip(batches, rows)]
        losses = []
        staged = prefetch_batches(source, staged_rows, BatchPut(self.device),
                                  depth=depth)
        for i, (batch, r) in enumerate(zip(batches, rows), 1):
            # The batch lives in ``images`` alone, and goes before the next
            # is staged: a tuple of the loop would keep it while the
            # generator stages two more.
            images = next(staged)[1].get()
            kw = {}
            if self.mesh is not None:
                kw["sharded"] = r is not None
                if self.augment:  # drawn for the global batch
                    kw["params"] = _rows_of(sample_augment_params(
                        self.generator,
                        self._full_sizes(len(batch), images[0])), r)
            losses.append(self._observed(self.train_batch, *images,
                                         epoch=epoch, step=i, **kw))
            del images
        return _mean(losses)

    def _observed(self, fn, *args, epoch, step: int, **kw) -> torch.Tensor:
        """``fn(*args, **kw)`` (``train_step`` or ``train_batch``), under the
        step timer when there is one (up to a device sync, so that the
        time holds the card's work), naming the step in the NaN check's
        error when that is on."""
        if self.nan_checks:
            kw["where"] = step_label(epoch, step)
        if self.step_timer is None:
            return fn(*args, **kw)
        with self.step_timer.step():
            loss = fn(*args, **kw)
            sync(self.device)
        return loss

    @torch.no_grad()
    def validate(self, cache) -> float:
        """Mean FocalDice over contiguous eval-mode batches (forward kernel
        only).  0.0 for an empty cache, as the JAX package returns.  Under
        a mesh each rank runs its rows of a batch that divides (the loss
        the global batch's), all of one that does not."""
        bs = self.config.batch_size
        self.model.eval()
        losses = []
        for start in range(0, len(cache), bs):
            stop, sharded = start + bs, False
            if self.mesh is not None:
                rows = self.mesh.rows(min(stop, len(cache)) - start)
                if rows is not None:
                    start, stop, sharded = (start + rows.start,
                                            start + rows.stop, True)
            img1 = normalize(cache.img1[start:stop])
            img2 = normalize(cache.img2[start:stop])
            labels = cache.labels[start:stop]
            split = (self.mesh.split(sharded) if self.mesh is not None
                     else None)
            img1, img2, labels = _height_block(split, img1, img2, labels)
            with compute_precision(self.config.compute_dtype,
                                   self.device.type), \
                    spatial.splitting(split):
                logits = self.model(img1, img2)
            losses.append(self.loss(logits, labels, sharded=True) if sharded
                          else self.loss(logits, labels))
        return _mean(losses)


def _height_block(split, img1, img2, labels):
    """This rank's height block of NCHW images and (B, H, W) labels under a
    ``spatial.Split``; all of them without one."""
    if split is None:
        return img1, img2, labels
    return split.block(img1, 2), split.block(img2, 2), split.block(labels, 1)


def _rows_of(params, rows):
    """The draws of ``rows`` (a slice; None: all) from the draws for a
    global batch (a ``sample_augment_params`` dict, or None)."""
    if params is None or rows is None:
        return params
    return {k: v[rows] for k, v in params.items()}


def _mean(losses) -> float:
    """Mean of 0-dim device tensors with one device->host copy."""
    if not losses:
        return 0.0
    return float(torch.stack(losses).mean())
