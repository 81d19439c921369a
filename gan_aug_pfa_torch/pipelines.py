"""End-to-end pipelines, on the device-resident cached path: Siamese
training with and without augmentation (the JAX package's
``run_siamese_training``, pipelines.py:88-392), Pix2Pix GAN training
(``run_gan_training``, :400-606), synthetic-pair generation
(``run_generate_synthetic``, :614-747), evaluation (``run_evaluation``,
:755-991) and single-pair evaluation (``evaluate_single_pair``,
:994-1103).

Both trainers carry the JAX package's run control: the SIGTERM/SIGINT
guard (the epoch in flight finishes, the resume state is written at it,
the run returns), the JSONL run log (``--log-jsonl``), the profiler trace
and step timer (``--profile-dir``), the NaN checks (``--debug-nans``) and
background checkpoint writes (``--async-ckpt``); Siamese training also
the deferred best model (``--defer-best-ckpt``).  Evaluation and synthesis
load a JAX package ``.msgpack`` checkpoint as they load a ``.pth``.
Evaluation takes an ensemble of checkpoints, post-processing, the
threshold sweep and the panels (matplotlib, where it is installed).
Evaluation and synthesis also run a serving artifact (``serve.py``) in
place of a checkpoint.  Both trainers resume from their own ``.pth``
resume files or from the JAX package's ``.msgpack`` train states.  Tuning
is ``tune.py``'s.

Under ``--stream host|decode`` (``data_cfg.stream``) training, GAN
training, synthesis and evaluation take their samples from a
``data.stream.StreamingSource`` instead of a device cache; validation
stays resident.  Every cache, source and single pair decodes its PNGs
through ``data/native_loader.py`` (the C unfilter).

Not ported yet: the GAN's ``--batched-disc``, ``--concat-free-disc`` and
``--shared-gen-fwd``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import checkpoint as ckpt
from . import serve
from .config import (
    DataConfig,
    EvalConfig,
    GANTrainConfig,
    GenerateConfig,
    SiameseTrainConfig,
)
from .data.loader import (
    CachedDataset,
    PaddedNativeDataset,
    build_cached_dataset,
    build_padded_native_dataset,
    float_to_uint8,
)
from .data.native_loader import decode_gray, decode_rgb
from .data.pil_resize import resize_bicubic_rgb, resize_nearest
from .data.png import PngWriterPool
from .data.scanner import create_sample_lists
from .data.stream import BatchPut, StreamingSource
from .data.transforms import normalize
from .device import resolve_device
from .metrics import (
    METRIC_KEYS,
    calculate_metrics,
    confusion_counts_sweep,
    metrics_from_counts,
    sweep_thresholds,
)
from .models.pix2pix import UNetGenerator
from .models.siamese_unet import SiameseUNet
from .ops.morphology import postprocess_prediction
from .train.gan import GANTrainer, generate
from .train.optim import get_learning_rate
from .train.plateau import EarlyStopping, make_plateau_scheduler
from .train.siamese import SiameseTrainer, predict, predict_normalized
from .utils.profiling import StepTimer, annotate, enable_nan_checks, trace
from .utils.runlog import open_run_log
from .utils.signals import GracefulShutdown
from .utils.viz import (
    have_matplotlib,
    save_gan_sample_strip,
    skip_message,
    visualize_sample,
)


@dataclasses.dataclass
class DeviceCache:
    """The cached dataset on the device: images NCHW float32 in [0, 1],
    labels (N, H, W) float32 in {0, 1}."""

    img1: torch.Tensor
    img2: torch.Tensor
    labels: torch.Tensor

    @classmethod
    def from_dataset(cls, ds: CachedDataset, device) -> "DeviceCache":
        def images(a):
            return torch.from_numpy(a).to(device).permute(0, 3, 1, 2)

        return cls(images(ds.img1).contiguous(), images(ds.img2).contiguous(),
                   torch.from_numpy(ds.labels).to(device, torch.float32))

    def __len__(self) -> int:
        return self.img1.shape[0]


@dataclasses.dataclass
class NativeDeviceCache(DeviceCache):
    """The padded native-size dataset on the device: images NCHW float32
    in [0, 1], labels float32 in {0, 1}, each sample in the top-left corner
    of its buffer, and ``sizes`` (N, 2) int64, its native (h, w)."""

    sizes: torch.Tensor

    @classmethod
    def from_dataset(cls, ds: PaddedNativeDataset,
                     device) -> "NativeDeviceCache":
        cache = DeviceCache.from_dataset(ds, device)
        return cls(cache.img1, cache.img2, cache.labels,
                   torch.from_numpy(ds.sizes).to(device, torch.int64))


def _open_dataset(samples, target_size, data_cfg: DataConfig,
                  verbose: bool):
    """The samples' decode-once host cache, or under ``data_cfg.stream``
    (``host`` or ``decode``) their ``StreamingSource``, which
    ``_closing`` closes."""
    if data_cfg.stream == "hbm":
        return build_cached_dataset(samples, target_size, verbose=verbose)
    return StreamingSource(samples, target_size, cache=data_cfg.stream,
                           verbose=verbose)


def _closing(ds):
    """A context that closes ``ds`` if it is a ``StreamingSource``."""
    if isinstance(ds, StreamingSource):
        return contextlib.closing(ds)
    return contextlib.nullcontext(ds)


def _setup_observability(trainer, cfg, items_per_step: int, verbose: bool):
    """Attach the step timer (``profile_dir``) and the NaN checks
    (``debug_nans``) to ``trainer``; returns the profiler's context."""
    if cfg.debug_nans:
        enable_nan_checks(trainer)
        if verbose:
            print("NaN checks enabled: each step's loss and gradients are "
                  "checked before the optimizer step.")
    if cfg.profile_dir:
        # The first two steps warm up (cuDNN's algorithm search for the
        # full and the partial batch, first kernel loads): excluded.
        trainer.step_timer = StepTimer(items_per_step=items_per_step,
                                       skip_first=2)
    return trace(cfg.profile_dir)


def _report_observability(trainer, cfg, verbose: bool) -> None:
    if trainer.step_timer is not None and verbose:
        print(trainer.step_timer.format_summary("Step timing: "))
        print(f"Profiler trace written to {cfg.profile_dir}")


def run_siamese_training(
    data_cfg: DataConfig,
    train_cfg: SiameseTrainConfig,
    verbose: bool = True,
    device="cuda",
    initial_state_dict: Optional[Dict[str, torch.Tensor]] = None,
) -> Optional[Dict]:
    """Train the SiameseUNet on the train cities, validating on the val
    cities each epoch (reference train.py:258-322), under the run control
    of ``train_cfg``.  ``initial_state_dict`` replaces the seeded init (a
    JAX init carried across with ``interop.siamese_state_dict_from_jax``,
    say).  Returns the history {"train_loss", "val_loss", "best_val_loss",
    "trainer"}, or None when the train split is empty.  ``resume``
    continues from ``last_state.pth``, else from the JAX package's
    ``last_state.msgpack`` (``checkpoint.ResumeNotPortedError`` on an
    optax layout not ported yet)."""
    dev = resolve_device(device)
    checkpoint_dir = os.path.join(data_cfg.root_dir, train_cfg.checkpoint_dir)
    os.makedirs(checkpoint_dir, exist_ok=True)
    resume_path = (ckpt.find_checkpoint(checkpoint_dir, "last_state")
                   if train_cfg.resume else None)

    train_samples = create_sample_lists(
        data_cfg.root_dir, data_cfg.dataset_subdir, data_cfg.synthetic_data_dir,
        mode="train", use_synthetic=data_cfg.use_synthetic, verbose=verbose,
    )
    val_samples = create_sample_lists(
        data_cfg.root_dir, data_cfg.dataset_subdir, data_cfg.synthetic_data_dir,
        mode="val", verbose=verbose,
    )
    if not train_samples:
        print("Error: Training dataset is empty. Check paths and data.")
        return None
    if not val_samples:
        print("Warning: Validation dataset is empty. Check paths and data.")
    native = data_cfg.augment and data_cfg.native_aug
    stream = data_cfg.stream != "hbm"
    if native and stream:
        print(
            "--stream has no native-resolution variant (dynamic per-sample "
            "extents need the padded HBM cache); streaming the fixed-size "
            "chain instead."
        )
        native = False
    if native:
        train_ds = build_padded_native_dataset(train_samples, verbose=verbose)
    else:
        train_ds = _open_dataset(train_samples, data_cfg.target_size,
                                 data_cfg, verbose)
    with _closing(train_ds):
        val_ds = build_cached_dataset(val_samples, data_cfg.target_size,
                                      verbose=verbose)
        if verbose:
            print(f"Dataset loaded: {len(train_ds)} train samples, "
                  f"{len(val_ds)} val samples.")

        trainer = SiameseTrainer(
            train_cfg, dev, augment=data_cfg.augment,
            native_out_size=data_cfg.target_size if native else None)
        if initial_state_dict is not None:
            trainer.model.load_state_dict(initial_state_dict, strict=True)
        scheduler = make_plateau_scheduler(
            trainer.optimizer, train_cfg.plateau_factor,
            train_cfg.plateau_patience)
        stopper = EarlyStopping(train_cfg.early_stop_patience)
        start_epoch = 1
        best_val_loss = float("inf")
        if resume_path:
            extra = ckpt.restore_train_state(
                resume_path, trainer.model, trainer.optimizer, scheduler,
                stopper)
            start_epoch = extra["epoch"] + 1
            best_val_loss = extra["best_val_loss"]
            if verbose:
                print(f"Resumed from {resume_path} at epoch {start_epoch}.")

        # Streamed, the train split stays in its source; validation is
        # always resident (JAX pipelines.py:178).
        dev_train = (train_ds if stream else (
            NativeDeviceCache if native else DeviceCache).from_dataset(
                train_ds, dev))
        dev_val = (DeviceCache.from_dataset(val_ds, dev) if len(val_ds)
                   else None)
        # The epoch order's and the augmentation's only sources; a resumed
        # run starts both afresh, as the JAX package restarts its epoch
        # order and PRNGKey(seed) (pipelines.py:148, 180).
        epoch_rng = np.random.RandomState(train_cfg.seed)
        trainer.generator.manual_seed(train_cfg.seed)
        history = {"train_loss": [], "val_loss": []}
        profiler_ctx = _setup_observability(trainer, train_cfg,
                                            train_cfg.batch_size, verbose)
        runlog = open_run_log(train_cfg.log_jsonl, append=train_cfg.resume)
        if runlog:
            runlog.log(
                "run_start", kind="siamese_train", start_epoch=start_epoch,
                n_train=len(train_ds), n_val=len(val_ds),
                data=dataclasses.asdict(data_cfg),
                config=dataclasses.asdict(train_cfg),
            )
        try:
            with profiler_ctx, GracefulShutdown() as stop:
                history["best_val_loss"] = _run_siamese_epochs(
                    trainer, train_cfg, scheduler, stopper, start_epoch,
                    best_val_loss, dev_train, dev_val, epoch_rng,
                    checkpoint_dir, history, verbose, stop, runlog)
            if runlog:
                runlog.log("run_end",
                           best_val_loss=history["best_val_loss"])
        finally:
            if runlog:
                runlog.close()
    _report_observability(trainer, train_cfg, verbose)
    history["trainer"] = trainer
    if verbose:
        print("Training finished.")
    return history


def _run_siamese_epochs(trainer, train_cfg, scheduler, stopper, start_epoch,
                        best_val_loss, dev_train, dev_val, epoch_rng,
                        checkpoint_dir, history, verbose, stop=None,
                        runlog=None) -> float:
    """The epoch loop, its writes and its events in the JAX package's
    order (pipelines.py:221-392).  ``dev_train`` is the train split's
    device cache, or its ``StreamingSource`` under ``--stream``.  Returns
    the best validation loss."""
    def path(stem):
        return os.path.join(checkpoint_dir, ckpt.checkpoint_name(stem))

    def log(event, **fields):
        if runlog:
            runlog.log(event, **fields)

    cfg = train_cfg
    best_snapshot = None  # the best model's state_dict, on the device
    writer = ckpt.AsyncCheckpointWriter() if cfg.async_ckpt else None
    save = writer.save if writer else ckpt.save
    try:
        for epoch in range(start_epoch, cfg.num_epochs + 1):
            lr_now = get_learning_rate(trainer.optimizer)
            if verbose:
                print(f"\nEpoch {epoch}/{cfg.num_epochs} - LR: {lr_now:.1e}")
            t0 = time.perf_counter()
            with annotate("train_epoch"):
                if isinstance(dev_train, StreamingSource):
                    train_loss = trainer.train_epoch_streaming(
                        dev_train, epoch_rng, epoch=epoch)
                else:
                    train_loss = trainer.train_epoch(dev_train, epoch_rng,
                                                     epoch=epoch)
            with annotate("validate"):
                val_loss = (trainer.validate(dev_val) if dev_val is not None
                            else 0.0)
            dt = time.perf_counter() - t0
            history["train_loss"].append(train_loss)
            history["val_loss"].append(val_loss)
            if verbose:
                print(f"Epoch {epoch} - Train Loss: {train_loss:.4f}, "
                      f"Val Loss: {val_loss:.4f} ({dt:.2f}s)")
            log("epoch", epoch=epoch, train_loss=train_loss,
                val_loss=val_loss, lr=lr_now, wall_s=round(dt, 3))
            scheduler.step(val_loss)
            early_stopped = dev_val is not None and stopper.step(val_loss)
            if val_loss < best_val_loss:
                best_val_loss = val_loss
                if cfg.defer_best_ckpt:
                    # A device copy of the whole state_dict, buffers too:
                    # the next epoch's steps update the live tensors in
                    # place.
                    best_snapshot = {k: v.detach().clone() for k, v in
                                     trainer.model.state_dict().items()}
                    if verbose:
                        print(f"Best model snapshotted on device (Val "
                              f"Loss: {best_val_loss:.4f})")
                    log("best_snapshot", epoch=epoch, val_loss=val_loss)
                else:
                    p = path("best_model")
                    save(p, trainer.model.state_dict())
                    if verbose:
                        print(f"Best model saved to {p} (Val Loss: "
                              f"{best_val_loss:.4f})")
                    log("checkpoint", kind="best_model", path=p,
                        epoch=epoch, val_loss=val_loss)
            preempted = stop is not None and stop.requested
            cadence = epoch % cfg.save_every == 0
            if best_snapshot is not None and (
                    cadence or epoch == cfg.num_epochs or preempted
                    or early_stopped):
                p = path("best_model")
                save(p, best_snapshot)
                best_snapshot = None
                if verbose:
                    print(f"Best model saved to {p} (deferred write)")
                log("checkpoint", kind="best_model", path=p, epoch=epoch,
                    deferred=True)
            if cadence:
                p = path(f"model_epoch_{epoch}")
                save(p, trainer.model.state_dict())
                if verbose:
                    print(f"Checkpoint saved to {p}")
                log("checkpoint", kind="model_epoch", path=p, epoch=epoch)
            # The resume state: on the save_every cadence, at the last
            # epoch, on preemption (so that --resume continues from this
            # epoch) and on early stop.
            if (cadence or epoch == cfg.num_epochs or preempted
                    or early_stopped):
                p = path("last_state")
                save(p, ckpt.train_state(
                    trainer.model, trainer.optimizer, scheduler, stopper,
                    epoch, best_val_loss))
                log("checkpoint", kind="last_state", path=p, epoch=epoch)
            if preempted:
                if verbose:
                    print(f"Preemption requested: resume state saved at "
                          f"epoch {epoch}; relaunch with --resume to "
                          "continue.")
                log("preemption", epoch=epoch)
                break
            if early_stopped:
                if verbose:
                    print(f"Early stopping at epoch {epoch}: no val-loss "
                          f"improvement in {stopper.patience} epochs (best "
                          f"{best_val_loss:.4f}).")
                log("early_stop", epoch=epoch, patience=stopper.patience,
                    best_val_loss=best_val_loss)
                break
        if writer is not None:
            writer.wait()  # the last write durable, its error raised, here
    finally:
        if writer is not None:
            writer.close()
    return best_val_loss


def run_gan_training(
    data_cfg: DataConfig,
    gan_cfg: GANTrainConfig,
    verbose: bool = True,
    device="cuda",
    initial_state_dicts: Optional[Tuple[Dict[str, torch.Tensor],
                                        Dict[str, torch.Tensor]]] = None,
) -> Optional[Dict]:
    """Train the Pix2Pix GAN on every city, no split (reference
    train_gan.py:95-155, quirk kept), from a cache at the target size on
    the device (or, under ``data_cfg.stream``, a ``StreamingSource``),
    under the run control of ``gan_cfg``.
    ``initial_state_dicts`` = (generator, discriminator) replaces the
    seeded init (a JAX init carried across, say).  Returns the history
    {"loss_d", "loss_g", "trainer"}, or None when there is no sample.
    ``resume`` continues when both resume files are there, each a
    ``.pth`` or the JAX package's ``.msgpack``
    (``checkpoint.ResumeNotPortedError`` on an optax layout not ported
    yet)."""
    dev = resolve_device(device)
    checkpoint_dir = os.path.join(data_cfg.root_dir, gan_cfg.checkpoint_dir)
    output_dir = os.path.join(data_cfg.root_dir, gan_cfg.output_dir)
    os.makedirs(checkpoint_dir, exist_ok=True)
    os.makedirs(output_dir, exist_ok=True)
    resume_paths = ([ckpt.find_checkpoint(checkpoint_dir, stem)
                     for stem in ("last_generator", "last_discriminator")]
                    if gan_cfg.resume else [None, None])

    samples = create_sample_lists(
        data_cfg.root_dir, data_cfg.dataset_subdir, data_cfg.synthetic_data_dir,
        mode="all", verbose=verbose,
    )
    if not samples:
        print("Error: GAN Training dataset is empty. Check dataset path and "
              "structure.")
        return None
    ds = _open_dataset(samples, gan_cfg.target_size, data_cfg, verbose)
    with _closing(ds):
        return _train_gan(ds, data_cfg, gan_cfg, dev, checkpoint_dir,
                          output_dir, resume_paths, initial_state_dicts,
                          verbose)


def _train_gan(ds, data_cfg, gan_cfg, dev, checkpoint_dir, output_dir,
               resume_paths, initial_state_dicts, verbose) -> Dict:
    """``run_gan_training`` from its dataset on: the host cache, or the
    ``StreamingSource`` under ``--stream``."""
    if verbose:
        print(f"GAN Dataset loaded: {len(ds)} train samples.")

    trainer = GANTrainer(gan_cfg, dev)
    if initial_state_dicts is not None:
        trainer.load_state_dicts(*initial_state_dicts)
    start_epoch = 1
    pg, pd = resume_paths
    if pg and pd:
        epoch = ckpt.restore_gan_state(pg, trainer.generator, trainer.opt_g,
                                       trainer.ema)
        ckpt.restore_gan_state(pd, trainer.discriminator, trainer.opt_d)
        start_epoch = epoch + 1
        if verbose:
            print(f"Resumed GAN from epoch {start_epoch}.")

    stream = isinstance(ds, StreamingSource)
    cache = None if stream else DeviceCache.from_dataset(ds, dev)
    # The epoch order's only source; a resumed run restarts it, as the JAX
    # package does (pipelines.py:456).
    epoch_rng = np.random.RandomState(gan_cfg.seed)
    # One fixed preview pair for every strip (JAX pipelines.py:457-462).
    preview_i = int(np.random.RandomState(gan_cfg.seed + 1).randint(len(ds)))
    history = {"loss_d": [], "loss_g": []}
    # Closed in a finally, last in first out: the guard, the run log, the
    # writer (its last write waited for), the profiler.
    run = contextlib.ExitStack()
    run.enter_context(_setup_observability(trainer, gan_cfg,
                                           gan_cfg.batch_size, verbose))
    writer = ckpt.AsyncCheckpointWriter() if gan_cfg.async_ckpt else None
    if writer:
        run.callback(writer.close)
    save = writer.save if writer else ckpt.save
    runlog = open_run_log(gan_cfg.log_jsonl, append=gan_cfg.resume)

    def log(event, **fields):
        if runlog:
            runlog.log(event, **fields)

    if runlog:
        run.callback(runlog.close)
        runlog.log(
            "run_start", kind="gan_train", start_epoch=start_epoch,
            n_train=len(ds), data=dataclasses.asdict(data_cfg),
            config=dataclasses.asdict(gan_cfg),
        )
    stop = run.enter_context(GracefulShutdown())
    try:
        for epoch in range(start_epoch, gan_cfg.num_epochs + 1):
            t0 = time.perf_counter()
            with annotate("train_epoch"):
                if stream:
                    loss_d, loss_g = trainer.train_epoch_streaming(
                        ds, epoch_rng, epoch=epoch)
                else:
                    loss_d, loss_g = trainer.train_epoch(cache, epoch_rng,
                                                         epoch=epoch)
            dt = time.perf_counter() - t0
            history["loss_d"].append(loss_d)
            history["loss_g"].append(loss_g)
            if verbose:
                print(f"Epoch {epoch} - Avg Loss D: {loss_d:.4f}, Avg Loss "
                      f"G: {loss_g:.4f} ({dt:.2f}s)")
            log("epoch", epoch=epoch, loss_d=loss_d, loss_g=loss_g,
                wall_s=round(dt, 3))
            last = epoch == gan_cfg.num_epochs
            if epoch % gan_cfg.sample_every == 0 or last:
                i = preview_i
                if stream:
                    h1, h2, _ = ds.batch(np.array([i]))
                    a = BatchPut(dev, labels=False)((h1, h2, None)).get()[0]
                    strip1, strip2 = h1[0], h2[0]
                else:
                    a = cache.img1[i:i + 1]
                    strip1, strip2 = ds.img1[i], ds.img2[i]
                fake = trainer.generate(a.permute(0, 2, 3, 1))
                p = save_gan_sample_strip(strip1, fake[0].cpu().numpy(),
                                          strip2, ds.cities[i], epoch,
                                          output_dir)
                if verbose:
                    print(f"Saved sample image to {p}")
                log("sample", epoch=epoch, path=p)
            preempted = stop.requested
            if epoch % gan_cfg.save_every == 0 or last or preempted:
                paths = _save_gan_checkpoints(trainer, checkpoint_dir,
                                              epoch, save)
                if verbose:
                    print(f"GAN Checkpoints saved for epoch {epoch}")
                log("checkpoint", kind="gan_epoch", epoch=epoch, **paths)
            if preempted:
                if verbose:
                    print(f"Preemption requested: GAN resume state saved at "
                          f"epoch {epoch}; relaunch with --resume to "
                          "continue.")
                log("preemption", epoch=epoch)
                break
        if writer is not None:
            writer.wait()
        log("run_end")
    finally:
        # Restores the signal handlers and stops the profiler on an error
        # too (a leaked guard would swallow the process's next ctrl-C).
        run.close()
    _report_observability(trainer, gan_cfg, verbose)
    if verbose:
        print("GAN Training finished.")
    history["trainer"] = trainer
    return history


def _save_gan_checkpoints(trainer: GANTrainer, checkpoint_dir: str,
                          epoch: int, save=ckpt.save) -> Dict[str, str]:
    """Bare state_dicts ``generator_epoch_N.pth``,
    ``discriminator_epoch_N.pth`` (and ``generator_ema_epoch_N.pth`` with
    an EMA), then the resume pair ``last_generator.pth`` and
    ``last_discriminator.pth`` (JAX pipelines.py:530-573), each through
    ``save`` (``checkpoint.save`` or a writer's).  Returns the paths of
    the epoch's models by the run log's keys: ``generator``,
    ``discriminator`` and, with an EMA, ``ema``."""
    def path(stem):
        return os.path.join(checkpoint_dir, ckpt.checkpoint_name(stem))

    paths = {"generator": path(f"generator_epoch_{epoch}"),
             "discriminator": path(f"discriminator_epoch_{epoch}")}
    save(paths["generator"], trainer.generator.state_dict())
    save(paths["discriminator"], trainer.discriminator.state_dict())
    if trainer.ema is not None:
        paths["ema"] = path(f"generator_ema_epoch_{epoch}")
        save(paths["ema"], trainer.ema_state_dict())
    save(path("last_generator"), ckpt.gan_state(
        trainer.generator, trainer.opt_g, epoch, trainer.ema))
    save(path("last_discriminator"), ckpt.gan_state(
        trainer.discriminator, trainer.opt_d, epoch))
    return paths


def run_generate_synthetic(
    data_cfg: DataConfig,
    gen_cfg: GenerateConfig,
    verbose: bool = True,
    device="cuda",
) -> int:
    """Write the synthetic corpus (reference generate_synthetic_data.py:
    33-89): for every sample of every city, ``images/<city>/
    img1_synth_N.png`` (the cached img1), ``img2_synth_N.png`` (the
    generator's eval-mode output) and ``labels/<city>/cm_synth_N.png``
    (the real label x255).  With ``gen_cfg.serving_artifact`` an exported
    generator (its [0, 1] -> [0, 1] function, in its exported dtype) takes
    the checkpoint's place (JAX pipelines.py:645-666).  Under
    ``data_cfg.stream`` the samples come from a ``StreamingSource`` one
    batch at a time.  The PNGs are encoded and written on a pool of
    threads (``data.png.PngWriterPool``), with the serial writer's bytes.
    Returns the number of samples written, 0 when there is no sample, no
    checkpoint or no artifact."""
    dev = resolve_device(device)
    samples = create_sample_lists(
        data_cfg.root_dir, data_cfg.dataset_subdir, data_cfg.synthetic_data_dir,
        mode="all", verbose=verbose,
    )
    if not samples:
        print("Error: Original training dataset is empty. Cannot generate "
              "synthetic data.")
        return 0
    ds = _open_dataset(samples, gen_cfg.target_size, data_cfg, verbose)
    with _closing(ds):
        return _generate(ds, data_cfg, gen_cfg, dev, verbose)


def _generator_fn(data_cfg: DataConfig, gen_cfg: GenerateConfig, dev,
                  verbose: bool):
    """The [0, 1] NHWC -> [0, 1] NHWC generator of a synthesis run: the
    serving artifact's function or the checkpoint's model; None, after
    printing why, when the file is missing."""
    if gen_cfg.serving_artifact:
        artifact = gen_cfg.serving_artifact
        if verbose:
            print(f"Loading serving artifact: {artifact}")
        if not os.path.exists(artifact):
            print(f"Error: Serving artifact not found at {artifact}")
            return None
        return serve.load_serving_fn(artifact, aot=gen_cfg.serving_aot,
                                     device=dev)[1]
    gen_path = os.path.join(data_cfg.root_dir, gen_cfg.gan_checkpoint_dir,
                            gen_cfg.generator_checkpoint_name)
    if verbose:
        print(f"Loading GAN generator from: {gen_path}")
    if not os.path.exists(gen_path):
        print(f"Error: Generator checkpoint not found at {gen_path}")
        return None
    nc = gen_cfg.n_channels
    generator = UNetGenerator(nc, nc, num_downs=gen_cfg.num_downs,
                              ngf=gen_cfg.ngf)
    ckpt.restore_model_only(gen_path, generator)
    generator.to(dev)
    return functools.partial(generate, generator,
                             compute_dtype=gen_cfg.compute_dtype)


def _generate(ds, data_cfg: DataConfig, gen_cfg: GenerateConfig, dev,
              verbose: bool) -> int:
    """``run_generate_synthetic`` from its dataset on: the host cache, or
    the ``StreamingSource`` under ``--stream``."""
    generate_fn = _generator_fn(data_cfg, gen_cfg, dev, verbose)
    if generate_fn is None:
        return 0
    out_base = os.path.join(data_cfg.root_dir, gen_cfg.synthetic_data_dir)
    stream = isinstance(ds, StreamingSource)
    if not stream:
        # NCHW on the device, as the training caches; the generator takes
        # NHWC views of it.
        img1_dev = torch.from_numpy(ds.img1).to(dev).permute(0, 3, 1, 2)
        img1_dev = img1_dev.contiguous().permute(0, 2, 3, 1)
    put = BatchPut(dev)
    bs = gen_cfg.batch_size
    count = 0
    with PngWriterPool() as writer:
        for start in range(0, len(ds), bs):
            if stream:
                # Only this batch is decoded (or gathered) and copied; the
                # same NCHW layout as the device cache, so the generator
                # computes the same bits.
                host1, _, host_lbl = ds.batch(
                    np.arange(start, min(start + bs, len(ds))))
                batch = put((host1, None, None)).get()[0].permute(
                    0, 2, 3, 1)
            else:
                batch = img1_dev[start:start + bs]
                host1 = ds.img1[start:start + bs]
                host_lbl = ds.labels[start:start + bs]
            fake = generate_fn(batch).cpu().numpy()
            for j, fake_j in enumerate(fake):
                i = start + j
                img_dir = os.path.join(out_base, "images", ds.cities[i])
                lbl_dir = os.path.join(out_base, "labels", ds.cities[i])
                os.makedirs(img_dir, exist_ok=True)
                os.makedirs(lbl_dir, exist_ok=True)
                # The reference's img1 went through normalize ->
                # denormalize in float32 before the truncating byte cast;
                # that round trip lands a hair below integer pixel values,
                # so it is replayed here, in numpy float32 with separate
                # roundings (JAX :713-726).
                img1 = host1[j].astype(np.float32)
                img1 = (img1 * np.float32(2.0) - np.float32(1.0)
                        ) * np.float32(0.5) + np.float32(0.5)
                writer.write(os.path.join(img_dir, f"img1_synth_{i}.png"),
                             float_to_uint8(img1))
                writer.write(os.path.join(img_dir, f"img2_synth_{i}.png"),
                             float_to_uint8(fake_j))
                writer.write(os.path.join(lbl_dir, f"cm_synth_{i}.png"),
                             host_lbl[j].astype(np.uint8) * np.uint8(255))
                count += 1
    if verbose:
        print(f"\nSynthetic data generation finished. Saved {count} samples "
              f"to {out_base}")
    return count


def load_models(paths: List[str], eval_cfg: EvalConfig, dev,
                missing: str) -> Optional[List[torch.nn.Module]]:
    """One eval-mode SiameseUNet on ``dev`` for each checkpoint (``.pth``
    or JAX ``.msgpack``), in order; None, after printing ``missing``
    formatted with the path, at the first that does not exist.  The
    batched encoder computes the same eval-mode function as the two-pass
    form, in one pass over 2B images."""
    models = []
    for path in paths:
        if not os.path.exists(path):
            print(missing.format(path=path))
            return None
        model = SiameseUNet(eval_cfg.n_channels, eval_cfg.n_classes,
                            batched_encoder=True)
        ckpt.restore_model_only(path, model)
        models.append(model.to(dev).eval())
    return models


def checkpoint_paths(data_cfg: DataConfig, eval_cfg: EvalConfig) -> List[str]:
    """The ensemble's checkpoints, or the one of ``--checkpoint-path``,
    else ``<root>/siamese_checkpoints/best_model.pth``."""
    if eval_cfg.ensemble_paths:
        return list(eval_cfg.ensemble_paths)
    return [eval_cfg.checkpoint_path or os.path.join(
        data_cfg.root_dir, "siamese_checkpoints",
        ckpt.checkpoint_name("best_model"),
    )]


def ensemble_probs(models: List[torch.nn.Module], img1: torch.Tensor,
                   img2: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """(B, H, W) sigmoid probabilities of NHWC [0, 1] images: the models'
    probabilities summed in order and divided by their number
    (pipelines.py:847-851)."""
    probs = predict(models[0], img1, img2, compute_dtype)
    for model in models[1:]:
        probs = probs + predict(model, img1, img2, compute_dtype)
    if len(models) > 1:
        probs = probs / len(models)
    return probs[..., 0]


def ensemble_fn(models: List[torch.nn.Module], compute_dtype: str):
    """``evaluate_cached``'s probabilities callable for one model or an
    ensemble (``ensemble_probs``)."""
    return functools.partial(ensemble_probs, models,
                             compute_dtype=compute_dtype)


def artifact_fn(serve_fn):
    """``evaluate_cached``'s probabilities callable for a Siamese serving
    artifact's function, which takes [-1, 1] images (JAX
    pipelines.py:823-824)."""
    def probs(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        return serve_fn(normalize(img1), normalize(img2))[..., 0]

    return probs


def _eval_batches(data, bs: int, device):
    """(start, img1, img2, labels, host) of each contiguous batch of
    ``data``: NCHW [0, 1] images and float labels on the device, sliced
    from a ``DeviceCache``, or assembled by a ``StreamingSource`` and
    copied to ``device`` one batch at a time (JAX pipelines.py:874-881),
    with its host batch (None for a cache)."""
    if isinstance(data, StreamingSource):
        put = BatchPut(device)
        for start in range(0, len(data), bs):
            host = data.batch(np.arange(start, min(start + bs, len(data))))
            yield (start, *put(host).get(), host)
        return
    for start in range(0, len(data), bs):
        yield (start, data.img1[start:start + bs],
               data.img2[start:start + bs], data.labels[start:start + bs],
               None)


def evaluate_cached(probs_fn, cache, cities: List[str], eval_cfg: EvalConfig,
                    keep_probs: int = 0, device=None) -> Dict:
    """Per-sample metrics over contiguous batches of the device cache (or
    of a ``StreamingSource``, whose batches are copied to ``device``),
    accumulated overall and per city in sample order (pipelines.py:872-916).

    ``probs_fn(img1, img2)`` maps NHWC [0, 1] batches to (B, H, W)
    probabilities: ``ensemble_fn`` of one model or an ensemble, or
    ``artifact_fn`` of a serving artifact.  With
    ``eval_cfg.post_process`` the probabilities become
    ``postprocess_prediction``'s masks on the device.  Each batch
    runs the confusion counts at ``eval_cfg.threshold`` and, with
    ``eval_cfg.threshold_sweep``, at each of the 19 grid thresholds: T+1
    kernel calls, one ``metrics_from_counts`` over the stacked (T+1, B)
    counts and one device->host copy.  Each threshold's float32 metrics
    are summed over the batch in float32, then into float64 totals
    (pipelines.py:900-903).  The first ``keep_probs`` samples' (H, W)
    probability maps are copied to the host as well.

    Returns the sums, the per-city sample counts, each sample's (tp, fp,
    fn, tn) as an (N, 4) array; the sweep's float64 F1 and IoU sums (T,)
    and its counts (T, N, 4), or None; the kept maps; and, from a
    source, the kept samples' host (img1, img2, label) arrays for the
    panels."""
    bs = eval_cfg.batch_size
    grid = sweep_thresholds() if eval_cfg.threshold_sweep else None
    thresholds = [eval_cfg.threshold] + ([] if grid is None else list(grid))
    nk = len(METRIC_KEYS)
    f1_col, iou_col = METRIC_KEYS.index("f1"), METRIC_KEYS.index("iou")
    total = {k: 0.0 for k in METRIC_KEYS}
    per_city: Dict[str, Dict[str, float]] = {}
    per_city_counts: Dict[str, int] = {}
    counts, sweep_counts, kept, kept_host = [], [], [], []
    sweep_f1 = sweep_iou = None
    if grid is not None:
        sweep_f1 = np.zeros(len(grid))
        sweep_iou = np.zeros(len(grid))
    for start, img1, img2, labels, rows in _eval_batches(cache, bs, device):
        stop = start + img1.shape[0]
        probs = probs_fn(img1.permute(0, 2, 3, 1), img2.permute(0, 2, 3, 1))
        if eval_cfg.post_process:
            probs = postprocess_prediction(
                probs, kernel_size=eval_cfg.post_process_kernel)
        c = confusion_counts_sweep(probs, labels, thresholds)
        m = metrics_from_counts(c[..., 0], c[..., 1], c[..., 2], c[..., 3])
        # One device->host copy per batch: (T+1, B, metrics + counts).
        host = torch.cat(
            [torch.stack([m[k] for k in METRIC_KEYS], dim=-1), c], dim=-1
        ).cpu().numpy()
        counts.append(host[0, :, nk:])
        if grid is not None:
            sweep_counts.append(host[1:, :, nk:])
            sweep_f1 += np.ascontiguousarray(host[1:, :, f1_col]).sum(axis=1)
            sweep_iou += np.ascontiguousarray(host[1:, :, iou_col]).sum(
                axis=1)
        if start < keep_probs:
            kept.extend(probs[:keep_probs - start].cpu().numpy())
            if rows is not None:
                kept_host.extend(zip(*(a[:keep_probs - start]
                                       for a in rows)))
        for k_in_batch, sample_i in enumerate(range(start, stop)):
            city = cities[sample_i]
            if city not in per_city:
                per_city[city] = {k: 0.0 for k in METRIC_KEYS}
                per_city_counts[city] = 0
            for j, key in enumerate(METRIC_KEYS):
                v = float(host[0, k_in_batch, j])
                per_city[city][key] += v
                total[key] += v
            per_city_counts[city] += 1
    return {
        "total": total, "per_city": per_city,
        "per_city_counts": per_city_counts,
        "counts": (np.concatenate(counts) if counts
                   else np.zeros((0, 4), np.float32)),
        "sweep_f1": sweep_f1, "sweep_iou": sweep_iou,
        "sweep_counts": (np.concatenate(sweep_counts, axis=1)
                         if sweep_counts else None),
        "probs": kept,
        "host": kept_host,
    }


def draw_panels(images, output_dir: str) -> None:
    """``visualize_sample`` for each (img1, img2, label, pred, city, index)
    of ``images``; without matplotlib one line says what was skipped."""
    if not images:
        return
    if not have_matplotlib():
        print(skip_message(len(images)))
        return
    for args in images:
        visualize_sample(*args, output_dir)


def run_evaluation(
    data_cfg: DataConfig,
    eval_cfg: EvalConfig,
    verbose: bool = True,
    device="cuda",
) -> Optional[Dict]:
    """Evaluate ``best_model.pth`` (or ``eval_cfg.checkpoint_path``, or the
    ensemble of ``eval_cfg.ensemble_paths``; each a ``.pth`` or a JAX
    package ``.msgpack``; or the Siamese serving artifact
    ``eval_cfg.serving_artifact``, which computes in its exported dtype)
    over every OSCD city, with the options of
    ``EvalConfig``: post-processing, the threshold sweep (also written to
    ``<output_dir>/threshold_sweep.json``) and the first
    ``num_visualizations`` samples' panels.  Returns overall and per-city
    macro means, per-city sample counts, ``sweep`` (None without the
    sweep), each sample's confusion counts and the sweep's (T, N, 4)
    counts; None when no samples, no checkpoint or no artifact are found,
    or an artifact is given with an ensemble.  Under ``data_cfg.stream``
    the samples come from a ``StreamingSource``, one batch on the device at
    a time."""
    dev = resolve_device(device)
    output_dir = os.path.join(data_cfg.root_dir, eval_cfg.output_dir)
    os.makedirs(output_dir, exist_ok=True)

    # The reference evaluates ALL cities despite 'validation' naming
    # (evaluate.py:315-320) — quirk preserved.
    samples = create_sample_lists(
        data_cfg.root_dir, data_cfg.dataset_subdir,
        data_cfg.synthetic_data_dir, mode="all", verbose=verbose,
    )
    if not samples:
        print("Error: No validation samples found. Check dataset paths and "
              "structure.")
        return None
    ds = _open_dataset(samples, eval_cfg.target_size, data_cfg, verbose)
    with _closing(ds):
        return _evaluate(ds, data_cfg, eval_cfg, output_dir, dev, verbose)


def _evaluate(ds, data_cfg: DataConfig, eval_cfg: EvalConfig,
              output_dir: str, dev, verbose: bool) -> Optional[Dict]:
    """``run_evaluation`` from its dataset on: the host cache, or the
    ``StreamingSource`` under ``--stream``."""
    if eval_cfg.serving_artifact:
        artifact = eval_cfg.serving_artifact
        if eval_cfg.ensemble_paths:
            print("Error: --serving-artifact and --ensemble are mutually "
                  "exclusive (export one artifact per model).")
            return None
        if not os.path.exists(artifact):
            print(f"Error: Serving artifact not found at {artifact}")
            return None
        header, serve_fn = serve.load_serving_fn(
            artifact, aot=eval_cfg.serving_aot, device=dev)
        if verbose:
            print(f"Serving artifact: {artifact} ({header['arch']}, "
                  f"{header['compute_dtype']}, quantize="
                  f"{header.get('quantize')}, aot=none)")
        paths = [artifact]
        probs_fn = artifact_fn(serve_fn)
    else:
        paths = checkpoint_paths(data_cfg, eval_cfg)
        models = load_models(paths, eval_cfg, dev,
                             "Error: Checkpoint file not found at {path}")
        if models is None:
            return None
        if verbose and len(models) > 1:
            print(f"Ensembling {len(models)} checkpoints (averaged sigmoid "
                  f"probabilities).")
        probs_fn = ensemble_fn(models, eval_cfg.compute_dtype)

    n_panels = min(max(eval_cfg.num_visualizations, 0), len(ds))
    keep = n_panels if have_matplotlib() else 0
    stream = isinstance(ds, StreamingSource)
    acc = evaluate_cached(
        probs_fn, ds if stream else DeviceCache.from_dataset(ds, dev),
        ds.cities, eval_cfg, keep_probs=keep, device=dev)
    if stream:
        # The panels come from the host batches (JAX pipelines.py:918-924);
        # without matplotlib only their number is needed.
        rows = acc["host"] or [(None, None, None)] * n_panels
    else:
        rows = [(ds.img1[i], ds.img2[i], ds.labels[i])
                for i in range(n_panels)]
    draw_panels([(*rows[i], acc["probs"][i] if keep else None,
                  ds.cities[i], i) for i in range(n_panels)], output_dir)
    total, per_city = acc["total"], acc["per_city"]
    per_city_counts = acc["per_city_counts"]
    n = sum(per_city_counts.values())
    overall = {k: v / n for k, v in total.items()} if n else {}
    sweep = None
    if eval_cfg.threshold_sweep and n:
        # The best threshold is the first of equal F1 maxima
        # (pipelines.py:928-937): 0.05 when post-processing ties them all.
        grid, f1 = sweep_thresholds(), acc["sweep_f1"]
        best = int(np.argmax(f1))
        sweep = {
            "thresholds": grid.tolist(),
            "f1": (f1 / n).tolist(),
            "iou": (acc["sweep_iou"] / n).tolist(),
            "best_threshold": float(grid[best]),
            "best_f1": float(f1[best] / n),
        }
        with open(os.path.join(output_dir, "threshold_sweep.json"), "w") as f:
            json.dump(sweep, f, indent=1)
    if verbose:
        print("\n--- Overall Evaluation Metrics ---")
        for k, v in overall.items():
            print(f"{k.capitalize()}: {v:.4f}")
        if sweep is not None:
            print("\n--- Threshold sweep (macro F1 / IoU) ---")
            for th, f1v, iouv in zip(sweep["thresholds"], sweep["f1"],
                                     sweep["iou"]):
                mark = "  <- best" if th == sweep["best_threshold"] else ""
                print(f"  t={th:.2f}  F1={f1v:.4f}  IoU={iouv:.4f}{mark}")
            print(f"Best operating point: t={sweep['best_threshold']:.2f} "
                  f"(F1={sweep['best_f1']:.4f})")
        print("\n--- Per-City Evaluation Metrics ---")
        for city, m in per_city.items():
            c = per_city_counts[city]
            print(f"City: {city} (Samples: {c})")
            for k in METRIC_KEYS:
                print(f"  {k.capitalize()}: {m[k] / c:.4f}")
    if eval_cfg.json_out:
        # The JAX package's report keys (pipelines.py:969-983).
        report = {
            "n_samples": n,
            "threshold": eval_cfg.threshold,
            "checkpoints": paths,
            "post_process": eval_cfg.post_process,
            "overall": overall,
            "per_city": {
                city: {k: m[k] / per_city_counts[city] for k in METRIC_KEYS}
                for city, m in per_city.items()
            },
            "per_city_counts": per_city_counts,
            "sweep": sweep,
        }
        parent = os.path.dirname(os.path.abspath(eval_cfg.json_out))
        os.makedirs(parent, exist_ok=True)
        with open(eval_cfg.json_out, "w") as f:
            json.dump(report, f, indent=1)
        if verbose:
            print(f"Metrics report written to {eval_cfg.json_out}")
    return {"overall": overall, "per_city": per_city,
            "per_city_counts": per_city_counts, "sweep": sweep,
            "counts": acc["counts"], "sweep_counts": acc["sweep_counts"]}


# ImageNet mean and std of the single-pair path (reference evaluate.py
# transform).
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def evaluate_single_pair(
    data_cfg: DataConfig,
    eval_cfg: EvalConfig,
    img1_path: str,
    img2_path: str,
    city_name: str,
    label_path: Optional[str] = None,
    verbose: bool = True,
    device="cuda",
) -> Optional[Dict]:
    """Single-pair evaluation (reference evaluate.py:216-283, JAX
    pipelines.py:994-1103), with the reference's quirks:

    * the images are resized with Pillow's BICUBIC (``data/pil_resize``,
      byte for byte) and normalized with the ImageNet mean and std, not to
      [-1, 1] as in training, and the model is applied to them directly
      under ``compute_precision`` (``predict`` would normalize again);
    * the label is read as PIL's ``convert("L")``, resized NEAREST and
      divided by 255, not binarised; its metrics are ``calculate_metrics``
      at 0.5, not at ``--threshold`` (the confusion-counts kernel for a
      {0, 255} label, the plain float sums for any other);
    * the panel shows the normalized images clipped to [0, 1], index
      ``single_eval``.

    Reads PNG files only: another format raises ``ValueError`` (PIL would
    read it).  ``eval_cfg.serving_artifact`` is ignored: the checkpoints
    are evaluated, as in the JAX package, whose single pair has no
    artifact path.  Returns ``{"pred": (1, H, W) probabilities}`` and, with a
    label, ``"metrics"``; None when an image or a checkpoint is missing."""
    dev = resolve_device(device)
    output_dir = os.path.join(data_cfg.root_dir, eval_cfg.output_dir)
    os.makedirs(output_dir, exist_ok=True)
    height, width = eval_cfg.target_size
    try:
        img1 = decode_rgb(img1_path)
        img2 = decode_rgb(img2_path)
    except FileNotFoundError:
        print(f"Error: One or both image paths not found: {img1_path}, "
              f"{img2_path}")
        return None

    def prep(im):
        arr = resize_bicubic_rgb(im, (width, height)).astype(np.float32)
        return (arr / 255.0 - IMAGENET_MEAN) / IMAGENET_STD

    x1 = prep(img1)[None]
    x2 = prep(img2)[None]

    label = None
    if label_path:
        try:
            lp = resize_nearest(decode_gray(label_path), (width, height))
            label = (lp.astype(np.float32) / 255.0)[None]
        except FileNotFoundError:
            print(f"Warning: Label path not found: {label_path}. Proceeding "
                  f"without metrics.")
            label_path = None

    models = load_models(
        checkpoint_paths(data_cfg, eval_cfg), eval_cfg, dev,
        "Error: Checkpoint not found at {path}. Cannot evaluate single "
        "pair.")
    if models is None:
        return None

    def on_device(x):
        return torch.from_numpy(x).to(dev).permute(0, 3, 1, 2)

    t1, t2 = on_device(x1), on_device(x2)
    prob_sum = None
    for model in models:
        p = predict_normalized(model, t1, t2, eval_cfg.compute_dtype)
        prob_sum = p if prob_sum is None else prob_sum + p
    probs = (prob_sum / len(models))[:, 0]
    if eval_cfg.post_process:
        probs = postprocess_prediction(
            probs, kernel_size=eval_cfg.post_process_kernel)
    pred = probs.cpu().numpy()

    draw_panels([(np.clip(x1[0], 0, 1), np.clip(x2[0], 0, 1),
                  label[0] if label is not None else None, pred[0],
                  city_name, "single_eval")], output_dir)
    result = {"pred": pred}
    if label is not None and label_path:
        m = calculate_metrics(probs, torch.from_numpy(label).to(dev))
        # JAX's device_get returns the dict with its keys sorted, and the
        # metrics are printed in that order.
        m = {k: float(m[k]) for k in sorted(m)}
        if verbose:
            print(f"\n--- Metrics for {city_name} ---")
            for k, v in m.items():
                print(f"{k.capitalize()}: {v:.4f}")
        result["metrics"] = m
    elif not label_path and verbose:
        print("No label path provided, skipping metrics calculation.")
    return result
