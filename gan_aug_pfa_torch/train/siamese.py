"""Siamese U-Net training and inference (the JAX package's
``train/siamese.py``).

``SiameseTrainer`` holds the model, the optimizer and the loss.  A train
step gathers its batch from the device cache by a device index tensor,
normalizes to [-1, 1], runs the train-mode forward under
``compute_precision``, the FocalDice loss through the fused kernels'
wrapper, the backward and the optimizer step.  The epoch loss is the mean
of the per-batch losses (reference train.py:147), read once per epoch.

Training runs the two-pass encoder (``batched_encoder=False``): each image
gets its own train-mode BatchNorm statistics, as in the reference.  The
JAX package's augmentation, streaming, mesh and per-step profiling paths
are not ported.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from ..config import SiameseTrainConfig
from ..data.transforms import normalize
from ..device import resolve_device
from ..models.siamese_unet import SiameseUNet
from ..ops.kernels.fused_loss import focal_dice_loss_fused
from .optim import make_optimizer

COMPUTE_DTYPES = ("float32", "bfloat16")


@contextlib.contextmanager
def tf32_off():
    """TF32 off for convolutions (cuDNN) and matrix products."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


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
    model.eval()
    x1 = normalize(img1.permute(0, 3, 1, 2))
    x2 = normalize(img2.permute(0, 3, 1, 2))
    with compute_precision(compute_dtype, img1.device.type):
        logits = model(x1, x2)
    return torch.sigmoid(logits.float()).permute(0, 2, 3, 1)


class SiameseTrainer:
    """Model, optimizer and loss of Siamese training on one device.  The
    model is ``init_model(config.seed)``, moved to ``device``; the
    optimizer is built over its parameters, so weights loaded later with
    ``model.load_state_dict`` stay the ones it updates."""

    def __init__(self, config: SiameseTrainConfig, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.model = self.init_model(config.seed).to(self.device)
        self.optimizer = make_optimizer(
            config.optimizer, self.model.parameters(), config.learning_rate,
            config.weight_decay)
        self.loss_kwargs = dict(
            beta=config.loss_beta, focal_gamma=config.focal_gamma,
            focal_alpha=config.focal_alpha, dice_smooth=config.dice_smooth)

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

    def train_step(self, cache, idx: torch.Tensor) -> torch.Tensor:
        """One optimization step on the cache rows ``idx`` (a device index
        tensor).  Returns the batch loss as a detached 0-dim device tensor
        (no host sync)."""
        img1 = normalize(cache.img1.index_select(0, idx))
        img2 = normalize(cache.img2.index_select(0, idx))
        labels = cache.labels.index_select(0, idx)
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
        self.optimizer.step()
        return loss.detach()

    def train_epoch(self, cache, epoch_rng: np.random.RandomState) -> float:
        """One shuffled pass: the order is one ``epoch_rng.permutation(n)``;
        full batches first, then the partial final batch, which is kept
        (reference DataLoader drop_last=False).  Returns the mean of the
        per-batch losses."""
        bs = self.config.batch_size
        n = len(cache)
        perm = torch.from_numpy(epoch_rng.permutation(n)).to(self.device)
        losses = [self.train_step(cache, perm[start:start + bs])
                  for start in range(0, n, bs)]
        return _mean(losses)

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
