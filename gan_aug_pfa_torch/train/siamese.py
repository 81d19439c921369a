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

Training runs the two-pass encoder (``batched_encoder=False``): each image
gets its own train-mode BatchNorm statistics, as in the reference.

Two observability hooks, both off by default, are set by the pipeline
(``--profile-dir``, ``--debug-nans``): ``step_timer`` (a
``utils.profiling.StepTimer``) times each step up to a device sync, and
``nan_checks`` checks each step's loss and gradients before the optimizer
step.  With neither, a step makes no host sync.

``train_epoch_streaming`` trains from a ``data.stream.StreamingSource``
(``--stream host|decode``) with the same batch-level step,
``train_batch``, as the resident path; there is no native-size variant,
so an augmented streamed epoch runs the fixed-size chain.  The JAX
package's mesh path is not ported.
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
    """Model, optimizer and loss of Siamese training on one device.  The
    model is ``init_model(config.seed)``, moved to ``device``; the
    optimizer is built over its parameters, so weights loaded later with
    ``model.load_state_dict`` stay the ones it updates."""

    def __init__(self, config: SiameseTrainConfig, device="cuda",
                 augment: bool = False, native_out_size=None):
        """``native_out_size`` = (H, W) switches the augmented train step
        to the native-resolution chain: the train cache must then be a
        ``pipelines.NativeDeviceCache``, and each batch is augmented at
        its native size and resized to (H, W)."""
        self.config = config
        self.device = resolve_device(device)
        self.augment = augment
        self.native_out_size = (tuple(native_out_size)
                                if augment and native_out_size else None)
        # The augmentation parameters' only source; the pipeline reseeds
        # it when a run starts.
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self.model = self.init_model(config.seed).to(self.device)
        self.optimizer = make_optimizer(
            config.optimizer, self.model.parameters(), config.learning_rate,
            config.weight_decay)
        self.loss_kwargs = dict(
            beta=config.loss_beta, focal_gamma=config.focal_gamma,
            focal_alpha=config.focal_alpha, dice_smooth=config.dice_smooth)
        # Observability hooks (utils/profiling.py), off by default.
        self.step_timer = None
        self.nan_checks = False

    def init_model(self, seed: int) -> SiameseUNet:
        """A freshly initialized SiameseUNet (on the CPU) from ``seed``,
        without touching the global generator's state."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            return SiameseUNet(self.config.n_channels, self.config.n_classes,
                               batched_encoder=False)

    def loss(self, logits: torch.Tensor, labels: torch.Tensor
             ) -> torch.Tensor:
        """FocalDice of (B, 1, H, W) logits against (B, H, W) labels."""
        return focal_dice_loss_fused(logits, labels, **self.loss_kwargs)

    def _batch(self, cache, idx: torch.Tensor):
        """The gather: the cache rows ``idx`` (a device index tensor) as
        NCHW [0, 1] images, labels and, from a native-size cache, their
        native sizes (else None)."""
        sizes = (cache.sizes.index_select(0, idx)
                 if self.native_out_size is not None else None)
        return (cache.img1.index_select(0, idx),
                cache.img2.index_select(0, idx),
                cache.labels.index_select(0, idx), sizes)

    def _prepare(self, img1, img2, labels, sizes=None, params=None):
        """The train step's input from a batch: augmented with ``params``
        (drawn from ``generator`` when None) or normalized.  Returns NCHW
        images in [-1, 1] and labels."""
        if not self.augment:
            return normalize(img1), normalize(img2), labels
        if sizes is None:
            # Filled on the device: no host-to-device copy in a step.
            sizes = torch.full((img1.shape[0], 2), img1.shape[2],
                               device=self.device)
            sizes[:, 1] = img1.shape[3]
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
        tensor): the gather, then ``train_batch``."""
        img1, img2, labels, sizes = self._batch(cache, idx)
        return self.train_batch(img1, img2, labels, params, where, sizes)

    def train_batch(self, img1: torch.Tensor, img2: torch.Tensor,
                    labels: torch.Tensor, params=None, where: str = "",
                    sizes=None) -> torch.Tensor:
        """One optimization step on a batch of NCHW [0, 1] images and
        (B, H, W) float labels on the device, the body that the resident
        and the streamed paths share (the JAX package's
        ``_train_step_batch``): augmented with ``params`` (a
        ``sample_augment_params`` dict; drawn from ``generator`` when None)
        if the trainer augments, at the native ``sizes`` on the native
        chain, else normalized.  Returns the batch loss as a detached 0-dim
        device tensor (no host sync unless ``nan_checks``, whose error
        names ``where``)."""
        img1, img2, labels = self._prepare(img1, img2, labels, sizes, params)
        self.model.train()
        # At float32 the backward's convolutions run without TF32 too.
        with (tf32_off() if self.config.compute_dtype == "float32"
              else contextlib.nullcontext()):
            with compute_precision(self.config.compute_dtype,
                                   self.device.type):
                logits = self.model(img1, img2)
            loss = self.loss(logits, labels)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
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
        losses = []
        for i, (_, staged) in enumerate(prefetch_batches(
                source, batches, BatchPut(self.device), depth=depth), 1):
            losses.append(self._observed(self.train_batch, *staged.get(),
                                         epoch=epoch, step=i))
        return _mean(losses)

    def _observed(self, fn, *args, epoch, step: int) -> torch.Tensor:
        """``fn(*args)`` (``train_step`` or ``train_batch``), under the step
        timer when there is one (up to a device sync, so that the time
        holds the card's work), naming the step in the NaN check's error
        when that is on."""
        kw = {"where": step_label(epoch, step)} if self.nan_checks else {}
        if self.step_timer is None:
            return fn(*args, **kw)
        with self.step_timer.step():
            loss = fn(*args, **kw)
            sync(self.device)
        return loss

    @torch.no_grad()
    def validate(self, cache) -> float:
        """Mean FocalDice over contiguous eval-mode batches (forward kernel
        only).  0.0 for an empty cache, as the JAX package returns."""
        bs = self.config.batch_size
        self.model.eval()
        losses = []
        for start in range(0, len(cache), bs):
            img1 = normalize(cache.img1[start:start + bs])
            img2 = normalize(cache.img2[start:start + bs])
            with compute_precision(self.config.compute_dtype,
                                   self.device.type):
                logits = self.model(img1, img2)
            losses.append(self.loss(logits, cache.labels[start:start + bs]))
        return _mean(losses)


def _mean(losses) -> float:
    """Mean of 0-dim device tensors with one device->host copy."""
    if not losses:
        return 0.0
    return float(torch.stack(losses).mean())
