"""End-to-end pipelines.  Ported so far, on the device-resident cached
path: Siamese training with and without augmentation (the JAX package's
``run_siamese_training``, pipelines.py:88-392) and evaluation
(``run_evaluation``, pipelines.py:755-991).

Not ported yet: tuning, ``--stream``, the run log, the profiler and NaN
checks, deferred and background checkpoint writes, the SIGTERM handler;
for evaluation visualizations, ``--post-process``, ``--ensemble``,
``--threshold-sweep``, serving artifacts and single-pair evaluation.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import checkpoint as ckpt
from .config import DataConfig, EvalConfig, SiameseTrainConfig
from .data.loader import (
    CachedDataset,
    PaddedNativeDataset,
    build_cached_dataset,
    build_padded_native_dataset,
)
from .data.scanner import create_sample_lists
from .device import resolve_device
from .metrics import METRIC_KEYS, metrics_from_counts
from .models.siamese_unet import SiameseUNet
from .ops.kernels.confusion_counts import confusion_counts_batch
from .train.optim import get_learning_rate
from .train.plateau import EarlyStopping, make_plateau_scheduler
from .train.siamese import SiameseTrainer, predict


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


def run_siamese_training(
    data_cfg: DataConfig,
    train_cfg: SiameseTrainConfig,
    verbose: bool = True,
    device="cuda",
    initial_state_dict: Optional[Dict[str, torch.Tensor]] = None,
) -> Optional[Dict]:
    """Train the SiameseUNet on the train cities, validating on the val
    cities each epoch (reference train.py:258-322).  ``initial_state_dict``
    replaces the seeded init (a JAX init carried across with
    ``interop.siamese_state_dict_from_jax``, say).  Returns the history
    {"train_loss", "val_loss", "best_val_loss", "trainer"}, or None when
    the train split is empty."""
    dev = resolve_device(device)
    checkpoint_dir = os.path.join(data_cfg.root_dir, train_cfg.checkpoint_dir)
    os.makedirs(checkpoint_dir, exist_ok=True)

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
    if native:
        train_ds = build_padded_native_dataset(train_samples, verbose=verbose)
    else:
        train_ds = build_cached_dataset(train_samples, data_cfg.target_size,
                                        verbose=verbose)
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
    if train_cfg.resume:
        path = ckpt.find_checkpoint(checkpoint_dir, "last_state")
        if path:
            extra = ckpt.restore_train_state(
                path, trainer.model, trainer.optimizer, scheduler, stopper)
            start_epoch = extra["epoch"] + 1
            best_val_loss = extra["best_val_loss"]
            if verbose:
                print(f"Resumed from {path} at epoch {start_epoch}.")

    dev_train = (NativeDeviceCache if native else DeviceCache).from_dataset(
        train_ds, dev)
    dev_val = DeviceCache.from_dataset(val_ds, dev) if len(val_ds) else None
    # The epoch order's and the augmentation's only sources; a resumed run
    # starts both afresh, as the JAX package restarts its epoch order and
    # PRNGKey(seed) (pipelines.py:148, 180).
    epoch_rng = np.random.RandomState(train_cfg.seed)
    trainer.generator.manual_seed(train_cfg.seed)
    history = {"train_loss": [], "val_loss": []}
    history["best_val_loss"] = _run_siamese_epochs(
        trainer, train_cfg, scheduler, stopper, start_epoch, best_val_loss,
        dev_train, dev_val, epoch_rng, checkpoint_dir, history, verbose)
    history["trainer"] = trainer
    if verbose:
        print("Training finished.")
    return history


def _run_siamese_epochs(trainer, train_cfg, scheduler, stopper, start_epoch,
                        best_val_loss, dev_train, dev_val, epoch_rng,
                        checkpoint_dir, history, verbose) -> float:
    """The epoch loop (pipelines.py:221-392 without the deferred, async,
    preemption and run-log paths).  Returns the best validation loss."""
    for epoch in range(start_epoch, train_cfg.num_epochs + 1):
        lr_now = get_learning_rate(trainer.optimizer)
        if verbose:
            print(f"\nEpoch {epoch}/{train_cfg.num_epochs} - LR: {lr_now:.1e}")
        t0 = time.perf_counter()
        train_loss = trainer.train_epoch(dev_train, epoch_rng)
        val_loss = trainer.validate(dev_val) if dev_val is not None else 0.0
        dt = time.perf_counter() - t0
        history["train_loss"].append(train_loss)
        history["val_loss"].append(val_loss)
        if verbose:
            print(f"Epoch {epoch} - Train Loss: {train_loss:.4f}, "
                  f"Val Loss: {val_loss:.4f} ({dt:.2f}s)")
        scheduler.step(val_loss)
        early_stopped = dev_val is not None and stopper.step(val_loss)
        if val_loss < best_val_loss:
            best_val_loss = val_loss
            path = os.path.join(checkpoint_dir,
                                ckpt.checkpoint_name("best_model"))
            ckpt.save_model(path, trainer.model)
            if verbose:
                print(f"Best model saved to {path} (Val Loss: "
                      f"{best_val_loss:.4f})")
        if epoch % train_cfg.save_every == 0:
            path = os.path.join(
                checkpoint_dir, ckpt.checkpoint_name(f"model_epoch_{epoch}"))
            ckpt.save_model(path, trainer.model)
            if verbose:
                print(f"Checkpoint saved to {path}")
        # The resume state, on the save_every cadence, at the last epoch
        # and on early stop.
        if (epoch % train_cfg.save_every == 0
                or epoch == train_cfg.num_epochs or early_stopped):
            ckpt.save_train_state(
                os.path.join(checkpoint_dir,
                             ckpt.checkpoint_name("last_state")),
                trainer.model, trainer.optimizer, scheduler, stopper, epoch,
                best_val_loss)
        if early_stopped:
            if verbose:
                print(f"Early stopping at epoch {epoch}: no val-loss "
                      f"improvement in {stopper.patience} epochs (best "
                      f"{best_val_loss:.4f}).")
            break
    return best_val_loss


def evaluate_cached(model: torch.nn.Module, cache: DeviceCache,
                    cities: List[str], eval_cfg: EvalConfig) -> Dict:
    """Per-sample metrics over contiguous batches of the device cache,
    accumulated overall and per city in sample order (pipelines.py:872-916).
    Returns the sums, the per-city sample counts, and each sample's
    (tp, fp, fn, tn) as an (N, 4) array."""
    bs = eval_cfg.batch_size
    total = {k: 0.0 for k in METRIC_KEYS}
    per_city: Dict[str, Dict[str, float]] = {}
    per_city_counts: Dict[str, int] = {}
    counts = []
    for start in range(0, len(cache), bs):
        stop = min(start + bs, len(cache))
        probs = predict(
            model, cache.img1[start:stop].permute(0, 2, 3, 1),
            cache.img2[start:stop].permute(0, 2, 3, 1),
            eval_cfg.compute_dtype,
        )[..., 0]
        c = confusion_counts_batch(probs, cache.labels[start:stop],
                                   eval_cfg.threshold)
        m = metrics_from_counts(c[:, 0], c[:, 1], c[:, 2], c[:, 3])
        # One device->host copy per batch: the metrics and the counts.
        host = torch.cat(
            [torch.stack([m[k] for k in METRIC_KEYS], dim=1), c], dim=1
        ).cpu().numpy()
        counts.append(host[:, len(METRIC_KEYS):])
        for k_in_batch, sample_i in enumerate(range(start, stop)):
            city = cities[sample_i]
            if city not in per_city:
                per_city[city] = {k: 0.0 for k in METRIC_KEYS}
                per_city_counts[city] = 0
            for j, key in enumerate(METRIC_KEYS):
                v = float(host[k_in_batch, j])
                per_city[city][key] += v
                total[key] += v
            per_city_counts[city] += 1
    return {
        "total": total, "per_city": per_city,
        "per_city_counts": per_city_counts,
        "counts": (np.concatenate(counts) if counts
                   else np.zeros((0, 4), np.float32)),
    }


def run_evaluation(
    data_cfg: DataConfig,
    eval_cfg: EvalConfig,
    verbose: bool = True,
    device="cuda",
) -> Optional[Dict]:
    """Evaluate ``best_model.pth`` (or ``eval_cfg.checkpoint_path``) over
    every OSCD city.  Returns overall and per-city macro means, per-city
    sample counts, ``sweep`` (None: not ported) and each sample's confusion
    counts; None when no samples or no checkpoint are found."""
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
    ds = build_cached_dataset(samples, eval_cfg.target_size, verbose=verbose)

    checkpoint_path = eval_cfg.checkpoint_path or os.path.join(
        data_cfg.root_dir, "siamese_checkpoints",
        ckpt.checkpoint_name("best_model"),
    )
    if not os.path.exists(checkpoint_path):
        print(f"Error: Checkpoint file not found at {checkpoint_path}")
        return None
    # The batched encoder computes the same eval-mode function as the
    # two-pass form in one pass over 2B images.
    model = SiameseUNet(eval_cfg.n_channels, eval_cfg.n_classes,
                        batched_encoder=True)
    ckpt.restore_model_only(checkpoint_path, model)
    model.to(dev).eval()

    acc = evaluate_cached(model, DeviceCache.from_dataset(ds, dev),
                          ds.cities, eval_cfg)
    total, per_city = acc["total"], acc["per_city"]
    per_city_counts = acc["per_city_counts"]
    n = sum(per_city_counts.values())
    overall = {k: v / n for k, v in total.items()} if n else {}
    if verbose:
        print("\n--- Overall Evaluation Metrics ---")
        for k, v in overall.items():
            print(f"{k.capitalize()}: {v:.4f}")
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
            "checkpoints": [checkpoint_path],
            "post_process": False,
            "overall": overall,
            "per_city": {
                city: {k: m[k] / per_city_counts[city] for k in METRIC_KEYS}
                for city, m in per_city.items()
            },
            "per_city_counts": per_city_counts,
            "sweep": None,
        }
        parent = os.path.dirname(os.path.abspath(eval_cfg.json_out))
        os.makedirs(parent, exist_ok=True)
        with open(eval_cfg.json_out, "w") as f:
            json.dump(report, f, indent=1)
        if verbose:
            print(f"Metrics report written to {eval_cfg.json_out}")
    return {"overall": overall, "per_city": per_city,
            "per_city_counts": per_city_counts, "sweep": None,
            "counts": acc["counts"]}
