"""Pix2Pix GAN training and inference (the JAX package's ``train/gan.py``,
reference train_gan.py:41-75).

One step, in the reference's order (JAX ``_gan_batch_impl``,
gan.py:178-297):

  D step: fake = G(A) in train mode without gradients (its BatchNorm
          running statistics still update); D on (A, B), then D on
          (A, fake), two train-mode passes with their own batch
          statistics; loss_D = 0.5 (BCE(real, 1) + BCE(fake, 0)); D's Adam
          step.
  G step: G(A) in train mode again, the updated D in train mode (its
          running statistics update once more);
          loss_G = BCE(D(A, G(A)), 1) + lambda_L1 * L1(G(A), B); G's Adam
          step.  D's parameters take no gradient in this backward.

The models' outputs are taken in float32 before any loss, as the JAX
models cast theirs (pix2pix.py:144, :198).  Batch losses stay on the
device; an epoch reads their means once.  The pipeline's observability
hooks, ``step_timer`` and ``nan_checks``, are ``SiameseTrainer``'s; the
NaN check runs before each of the two optimizer steps.
``train_epoch_streaming`` runs the same ``train_batch`` on batches from a
``data.stream.StreamingSource`` (``--stream host|decode``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import GANTrainConfig
from ..data.stream import BatchPut, prefetch_batches
from ..data.transforms import normalize
from ..device import resolve_device
from ..losses import gan_bce_loss, l1_loss
from ..models.pix2pix import NLayerDiscriminator, UNetGenerator
from ..utils.profiling import step_guard, sync
from .optim import make_optimizer
from .siamese import compute_precision, step_label, tf32_off


@torch.no_grad()
def generate(generator: torch.nn.Module, img01: torch.Tensor,
             compute_dtype: str = "float32") -> torch.Tensor:
    """Eval-mode generator on [0,1] NHWC images -> [0,1] NHWC float32 (the
    x*0.5+0.5 denormalize of reference generate_synthetic_data.py:70-71).
    The permutes are views, as in ``siamese.predict``."""
    generator.eval()
    x = normalize(img01.permute(0, 3, 1, 2))
    with compute_precision(compute_dtype, img01.device.type):
        fake = generator(x)
    return (fake.float() * 0.5 + 0.5).permute(0, 2, 3, 1)


class GANTrainer:
    """Generator, discriminator, their Adam optimizers (betas (beta1,
    0.999)) and the optional generator EMA on one device.  The models are
    ``init_models(config.seed)``, moved to ``device``."""

    def __init__(self, config: GANTrainConfig, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        g, d = self.init_models(config.seed)
        self.generator = g.to(self.device)
        self.discriminator = d.to(self.device)
        self.opt_g = make_optimizer("adam", self.generator.parameters(),
                                    config.learning_rate_g, b1=config.beta1)
        self.opt_d = make_optimizer("adam", self.discriminator.parameters(),
                                    config.learning_rate_d, b1=config.beta1)
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        self.reset_ema()
        # Observability hooks (utils/profiling.py), off by default.
        self.step_timer = None
        self.nan_checks = False

    def init_models(self, seed: int
                    ) -> Tuple[UNetGenerator, NLayerDiscriminator]:
        """Fresh models (on the CPU) from ``seed``, without touching the
        global generator's state."""
        cfg = self.config
        nc = cfg.n_channels
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            g = UNetGenerator(nc, nc, num_downs=cfg.num_downs, ngf=cfg.ngf)
            d = NLayerDiscriminator(2 * nc, ndf=cfg.ndf,
                                    n_layers=cfg.n_layers)
        return g, d

    def reset_ema(self) -> None:
        """The EMA (with ``ema_decay``) restarts from the generator's
        parameters as they are."""
        if self.config.ema_decay is not None:
            self.ema = {name: p.detach().clone()
                        for name, p in self.generator.named_parameters()}

    def load_state_dicts(self, generator: Dict[str, torch.Tensor],
                         discriminator: Dict[str, torch.Tensor]) -> None:
        """Replace both models' weights (strict) and restart the EMA."""
        self.generator.load_state_dict(generator, strict=True)
        self.discriminator.load_state_dict(discriminator, strict=True)
        self.reset_ema()

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The generator's ``state_dict`` with the EMA in place of its
        parameters and its live BatchNorm buffers: a regular generator
        checkpoint (JAX pipelines.py:547-561)."""
        sd = dict(self.generator.state_dict())
        sd.update(self.ema)
        return sd

    def train_step(self, cache, idx: torch.Tensor, where: str = ""
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One D+G step on the cache rows ``idx`` (a device index tensor).
        Returns (loss_D, loss_G), detached 0-dim device tensors."""
        return self.train_batch(cache.img1.index_select(0, idx),
                                cache.img2.index_select(0, idx), where)

    def train_batch(self, a01: torch.Tensor, b01: torch.Tensor,
                    where: str = "") -> Tuple[torch.Tensor, torch.Tensor]:
        """One D+G step on NCHW [0,1] images A (input) and B (target).
        ``where`` names the step in a NaN check's error."""
        cfg = self.config
        g, d = self.generator, self.discriminator
        real_a, real_b = normalize(a01), normalize(b01)
        g.train()
        d.train()

        def precision():
            return compute_precision(cfg.compute_dtype, self.device.type)

        # At float32 the backward passes run without TF32 too.
        with (tf32_off() if cfg.compute_dtype == "float32"
              else contextlib.nullcontext()):
            with torch.no_grad(), precision():
                fake = g(real_a)
            with precision():
                pred_real = d(torch.cat([real_a, real_b], dim=1))
                pred_fake = d(torch.cat([real_a, fake], dim=1))
            loss_d = 0.5 * (gan_bce_loss(pred_real, True)
                            + gan_bce_loss(pred_fake, False))
            self.opt_d.zero_grad(set_to_none=True)
            loss_d.backward()
            if self.nan_checks:
                step_guard(loss_d, d, f"{where} (D step)")
            self.opt_d.step()

            d.requires_grad_(False)
            try:
                with precision():
                    fake = g(real_a)
                    pred_fake = d(torch.cat([real_a, fake], dim=1))
                loss_g = (gan_bce_loss(pred_fake, True)
                          + l1_loss(fake, real_b) * cfg.lambda_l1)
                self.opt_g.zero_grad(set_to_none=True)
                loss_g.backward()
            finally:
                d.requires_grad_(True)
        if self.nan_checks:
            step_guard(loss_g, g, f"{where} (G step)")
        self.opt_g.step()
        if self.ema is not None:
            self._update_ema()
        return loss_d.detach(), loss_g.detach()

    @torch.no_grad()
    def _update_ema(self) -> None:
        """ema <- ema * decay + params * (1 - decay), in that expression's
        order of rounding (JAX gan.py:290-295)."""
        decay = self.config.ema_decay
        ema = list(self.ema.values())
        params = [p.detach() for p in self.generator.parameters()]
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - decay))

    def train_epoch(self, cache, epoch_rng: np.random.RandomState,
                    epoch=None) -> Tuple[float, float]:
        """One shuffled pass of full batches (reference train_gan.py:135,
        drop_last=True) in the order ``epoch_rng.permutation(n)``.  Returns
        the means of the batch losses (loss_D, loss_G), read with one
        device-to-host copy; (0.0, 0.0) when no full batch fits.
        ``epoch`` names the epoch in a NaN check's error."""
        bs = self.config.batch_size
        n = len(cache)
        perm = epoch_rng.permutation(n)
        n_full = n // bs * bs
        if n_full == 0:
            return 0.0, 0.0
        batches = torch.from_numpy(perm[:n_full].reshape(-1, bs)).to(
            self.device)
        losses = [torch.stack(self._observed(self.train_step, cache, idx,
                                             epoch=epoch, step=i))
                  for i, idx in enumerate(batches, 1)]
        loss_d, loss_g = torch.stack(losses).mean(dim=0).tolist()
        return loss_d, loss_g

    def train_epoch_streaming(self, source, epoch_rng: np.random.RandomState,
                              epoch=None, depth: int = 2
                              ) -> Tuple[float, float]:
        """``train_epoch`` fed from a ``data.stream.StreamingSource``: the
        same order and full batches, ``train_batch`` for each, the means
        read once.  Batches are assembled and copied to the device (images
        only: the step reads no label) ``depth`` batches ahead."""
        bs = self.config.batch_size
        n = len(source)
        n_full = n // bs * bs
        if n_full == 0:
            return 0.0, 0.0
        perm = epoch_rng.permutation(n)
        batches = [perm[s:s + bs] for s in range(0, n_full, bs)]
        put = BatchPut(self.device, labels=False)
        losses = []
        for i, (_, staged) in enumerate(
                prefetch_batches(source, batches, put, depth=depth), 1):
            a, b, _ = staged.get()
            losses.append(torch.stack(self._observed(
                self.train_batch, a, b, epoch=epoch, step=i)))
        loss_d, loss_g = torch.stack(losses).mean(dim=0).tolist()
        return loss_d, loss_g

    def _observed(self, fn, *args, epoch, step: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``fn(*args)`` (``train_step`` or ``train_batch``), under the step
        timer when there is one (up to a device sync), naming the step in
        the NaN check's error when that is on."""
        kw = {"where": step_label(epoch, step)} if self.nan_checks else {}
        if self.step_timer is None:
            return fn(*args, **kw)
        with self.step_timer.step():
            losses = fn(*args, **kw)
            sync(self.device)
        return losses

    def generate(self, img01: torch.Tensor) -> torch.Tensor:
        """``generate`` with this trainer's generator and precision."""
        return generate(self.generator, img01, self.config.compute_dtype)
