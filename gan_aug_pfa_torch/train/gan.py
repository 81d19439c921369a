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

The JAX package's knobs (its gan.py:118-273), each off by default:

  * ``batched_disc``: the D step runs one D pass over
    ``(cat([A, A]), cat([B, fake]))``, so D's BatchNorm statistics mix
    real and fake and its running statistics update once, not twice;
  * ``concat_free_disc``: D takes the pair (A, x) at all three calls
    instead of ``torch.cat`` (``models/pix2pix.py``);
  * ``shared_gen_fwd``: one G forward with autograd on.  The D step takes
    it detached; the G step backpropagates through the same graph against
    the D just updated.  The reference's second train-mode G forward
    would update G's running statistics once more with the same batch
    moments; with s0 before and s1 after the one forward that update is
    s2 = (1 + m) s1 - m s0 (m = 1 - momentum, flax's 0.9), which is
    applied, and ``num_batches_tracked`` advances by 2, as two forwards
    leave it;

and the optimizers take ``opt_momentum_dtype`` and ``opt_flat_state``
(``train.optim.OptaxAdam``).

With a ``mesh`` (``parallel/mesh.py``) the trainer is one rank of a
data-parallel group, as ``SiameseTrainer``: a batch whose size divides by
the world size is split into the ranks' row blocks, any other (the
default batch of 1) replicated.  A sharded step takes every BatchNorm's
statistics over the global batch, each loss as this rank's part of the
global mean (``losses.gan_bce_loss``, ``losses.l1_loss`` with the global
count), and sums D's, then G's, gradients over the ranks before each
optimizer step; a replicated step takes rank 0's.  The returned losses
are the global batch's on every rank, and the EMA runs on every rank.
Under a 'model' axis G's and D's wide leaves, their moments and G's EMA
hold this rank's blocks (``parallel/tensor.py``), as JAX shards the whole
``GANState``; ``ema_state_dict`` gathers them.

Under a 'spatial' axis (``parallel/spatial.py``) the step cuts each
rank's height block of A and B after ``normalize``, as JAX constrains
them (gan.py:183-185).  G's output is split, so the L1 term is this
block's part of the mean over the whole output (its count x d x s); D's
patch map comes out whole on every spatial rank, so its BCE terms are the
(data d) step's, and each rank's backward takes 1/s of them.  The parts
summed over data x spatial (the spatial group in a replicated step) are
the losses, and so are the gradients.  The EMA is unchanged: no leaf is
split.  ``--concat-free-disc`` is not ported under the axis and raises
naming itself (ROADMAP A5).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import GANTrainConfig
from ..data.stream import BatchPut, prefetch_batches
from ..data.transforms import normalize
from ..device import resolve_device
from ..losses import gan_bce_loss, l1_loss
from ..models.pix2pix import NLayerDiscriminator, UNetGenerator
from ..parallel import spatial
from ..parallel.batchnorm import convert_batchnorm, global_statistics
from ..parallel.tensor import cut_state_dict, shard_model, whole_state_dict
from ..utils.profiling import step_guard, sync
from .optim import make_optimizer
from .siamese import (
    compute_precision,
    refuse_spatial_knobs,
    step_label,
    tf32_off,
)


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
    0.999)) and the optional generator EMA on one device, or on one rank
    of a data mesh (``mesh``, as ``SiameseTrainer``'s).  The models are
    ``init_models(config.seed)``, moved to ``device``."""

    def __init__(self, config: GANTrainConfig, device="cuda", mesh=None):
        self.config = config
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None and self.mesh.spatial_size > 1:
            refuse_spatial_knobs(concat_free_disc=config.concat_free_disc)
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(device))
        g, d = self.init_models(config.seed)
        if self.mesh is not None:
            for model in (g, d):
                convert_batchnorm(model)
                if self.mesh.model_size > 1:
                    shard_model(model, self.mesh)
        self.generator = g.to(self.device)
        self.discriminator = d.to(self.device)
        knobs = dict(b1=config.beta1, mu_dtype=config.opt_momentum_dtype,
                     flat_state=config.opt_flat_state)
        self.opt_g = make_optimizer("adam", self.generator.parameters(),
                                    config.learning_rate_g, **knobs)
        self.opt_d = make_optimizer("adam", self.discriminator.parameters(),
                                    config.learning_rate_d, **knobs)
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
        """Replace both models' weights (strict; whole state dicts, cut to
        this rank's blocks under a 'model' axis) and restart the EMA."""
        self.generator.load_state_dict(
            cut_state_dict(self.generator, generator), strict=True)
        self.discriminator.load_state_dict(
            cut_state_dict(self.discriminator, discriminator), strict=True)
        self.reset_ema()

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The generator's ``state_dict`` with the EMA in place of its
        parameters and its live BatchNorm buffers: a regular generator
        checkpoint (JAX pipelines.py:547-561); whole under a 'model' axis
        (a collective over the model group)."""
        sd = dict(self.generator.state_dict())
        sd.update(self.ema)
        return whole_state_dict(self.generator, sd)

    def train_step(self, cache, idx: torch.Tensor, where: str = ""
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One D+G step on the cache rows ``idx`` (a device index tensor;
        under a mesh the global batch, of which the rank gathers its rows
        when it is sharded).  Returns (loss_D, loss_G), detached 0-dim
        device tensors."""
        rows = self.mesh.rows(len(idx)) if self.mesh is not None else None
        if rows is not None:
            idx = idx[rows]
        return self.train_batch(cache.img1.index_select(0, idx),
                                cache.img2.index_select(0, idx), where,
                                sharded=rows is not None)

    def train_batch(self, a01: torch.Tensor, b01: torch.Tensor,
                    where: str = "", sharded: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One D+G step on NCHW [0,1] images A (input) and B (target): the
        whole batch, or under a mesh this rank's shard of it
        (``sharded``).  ``where`` names the step in a NaN check's
        error."""
        cfg = self.config
        g, d = self.generator, self.discriminator
        real_a, real_b = normalize(a01), normalize(b01)
        mesh = self.mesh
        split = mesh.split(sharded) if mesh is not None else None
        if split is not None:  # the rank's height block
            real_a, real_b = split.block(real_a, 2), split.block(real_b, 2)
        g.train()
        d.train()
        # A shard's losses: its part of the global batch's means.  G's
        # output is split over the spatial ranks; D's patch map is whole
        # on each, which takes 1/s of its loss.
        world = mesh.world_size if sharded else 1
        s = 1 if split is None else split.size

        def total(x):  # of a split map
            n = world * s
            return None if n == 1 else x.numel() * n

        def bce(pred, is_real):  # of D's whole map
            loss = gan_bce_loss(pred, is_real,
                                None if world == 1 else pred.numel() * world)
            return loss if s == 1 else loss / s

        def precision():
            return compute_precision(cfg.compute_dtype, self.device.type)

        def disc(a, b):
            return d((a, b) if cfg.concat_free_disc
                     else torch.cat([a, b], dim=1))

        # At float32 the backward passes run without TF32 too.
        with (tf32_off() if cfg.compute_dtype == "float32"
              else contextlib.nullcontext()), (
                global_statistics(mesh.group) if sharded
                else contextlib.nullcontext()), spatial.splitting(split):
            if cfg.shared_gen_fwd:
                stats, counters, keep = _bn_stats(g)
                # Copies of s0 in one multi-tensor launch.
                before = torch._foreach_mul(stats, 1.0)
                with precision():
                    fake_live = g(real_a)
                fake = fake_live.detach()
            else:
                with torch.no_grad(), precision():
                    fake = g(real_a)
            with precision():
                if cfg.batched_disc:
                    nb = real_a.shape[0]
                    pred = disc(torch.cat([real_a, real_a]),
                                torch.cat([real_b, fake]))
                    pred_real, pred_fake = pred[:nb], pred[nb:]
                else:
                    pred_real = disc(real_a, real_b)
                    pred_fake = disc(real_a, fake)
            loss_d = 0.5 * (bce(pred_real, True) + bce(pred_fake, False))
            self.opt_d.zero_grad(set_to_none=True)
            loss_d.backward()
            if mesh is not None:
                loss_d = self._global_loss(loss_d, sharded)
                mesh.reduce_gradients(d.parameters(), sharded)
            if self.nan_checks:
                step_guard(loss_d, d, f"{where} (D step)")
            self.opt_d.step()

            d.requires_grad_(False)
            try:
                with precision():
                    fake = fake_live if cfg.shared_gen_fwd else g(real_a)
                    pred_fake = disc(real_a, fake)
                loss_g = (bce(pred_fake, True)
                          + l1_loss(fake, real_b, total(fake))
                          * cfg.lambda_l1)
                self.opt_g.zero_grad(set_to_none=True)
                loss_g.backward()
            finally:
                d.requires_grad_(True)
        if cfg.shared_gen_fwd:
            _second_bn_update(stats, counters, keep, before)
        if mesh is not None:
            loss_g = self._global_loss(loss_g, sharded)
            mesh.reduce_gradients(g.parameters(), sharded)
        if self.nan_checks:
            step_guard(loss_g, g, f"{where} (G step)")
        self.opt_g.step()
        if self.ema is not None:
            self._update_ema()
        return loss_d.detach(), loss_g.detach()

    def _global_loss(self, loss: torch.Tensor, sharded: bool
                     ) -> torch.Tensor:
        """The global batch's loss from a rank's part: the parts summed
        over ``sum_group`` (a replicated step's loss without a 'spatial'
        axis is whole already)."""
        loss = loss.detach()
        over = self.mesh.sum_group(sharded)
        if over is None:
            return loss
        out = loss.clone()
        dist.all_reduce(out, group=over[0])
        return out

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
        rows = self.mesh.rows(bs) if self.mesh is not None else None
        if rows is not None:  # the rank stages only its rows
            batches = [b[rows] for b in batches]
        kw = {} if self.mesh is None else {"sharded": rows is not None}
        put = BatchPut(self.device, labels=False)
        losses = []
        for i, (_, staged) in enumerate(
                prefetch_batches(source, batches, put, depth=depth), 1):
            a, b, _ = staged.get()
            losses.append(torch.stack(self._observed(
                self.train_batch, a, b, epoch=epoch, step=i, **kw)))
        loss_d, loss_g = torch.stack(losses).mean(dim=0).tolist()
        return loss_d, loss_g

    def _observed(self, fn, *args, epoch, step: int, **kw
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``fn(*args, **kw)`` (``train_step`` or ``train_batch``), under
        the step timer when there is one (up to a device sync), naming the
        step in the NaN check's error when that is on."""
        if self.nan_checks:
            kw["where"] = step_label(epoch, step)
        if self.step_timer is None:
            return fn(*args, **kw)
        with self.step_timer.step():
            losses = fn(*args, **kw)
            sync(self.device)
        return losses

    def generate(self, img01: torch.Tensor) -> torch.Tensor:
        """``generate`` with this trainer's generator and precision."""
        return generate(self.generator, img01, self.config.compute_dtype)


def _bn_stats(model: torch.nn.Module):
    """The running means and variances of ``model``'s BatchNorms (live
    tensors), their ``num_batches_tracked`` counters, and m = 1 -
    momentum, which they share."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    (momentum,) = {m.momentum for m in bns}
    stats = [t for m in bns for t in (m.running_mean, m.running_var)]
    return stats, [m.num_batches_tracked for m in bns], 1.0 - momentum


@torch.no_grad()
def _second_bn_update(stats, counters, keep: float, before) -> None:
    """What a second train-mode forward on the same batch would leave in
    the running statistics ``stats`` after one did: with s0 ``before``
    and s1 now, s2 = m s1 + (1 - m) b = (1 + m) s1 - m s0 (m ``keep``; b
    the batch moment, the same in both forwards), as the JAX package
    computes it (gan.py:260-270); and one more tracked batch."""
    torch._foreach_mul_(stats, 1.0 + keep)
    torch._foreach_add_(stats, before, alpha=-keep)
    torch._foreach_add_(counters, 1)
