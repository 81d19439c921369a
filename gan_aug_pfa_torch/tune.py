"""Optuna-style hyperparameter tuning of the Siamese model (the JAX
package's ``tune.py``; reference train.py:167-255, 338-374).

Search space, the same ``suggest_*`` calls in the same order as the JAX
package's, so that one sampler draw gives both packages the same trial:
  lr            ~ log-uniform [1e-5, 5e-3]
  batch_size    in {2, 4, 8}
  optimizer     in {AdamW, Adam}
  weight_decay  ~ log-uniform [1e-6, 1e-3]
  focal_alpha   ~ uniform [0.1, 0.9]
  focal_gamma   ~ uniform [1.0, 3.0]
  loss_beta     ~ uniform [0.3, 0.7]
  dice_smooth   ~ log-uniform [1e-7, 1e-4]
15 epochs a trial of augmented training (native resolution unless
``native_aug=False``), a per-epoch report and median pruning, study
'siamese_unet_tuning_v3' in sqlite:///optuna_study.db, 50 trials.

A trial's model is initialized from ``trial.number``, its augmentation
generator seeded with ``1000 + trial.number`` and its epoch order drawn
from ``np.random.RandomState(trial.number)``, as the JAX package seeds
its PRNGKeys and epoch order (tune.py:145-172).  The datasets are decoded
once a study and put on each worker's device once, shared by its trials;
each trial's model, optimizer and trainer are released before the next
trial starts.

Parallel trials run one worker thread per device of the requested kind
(the JAX package runs one per device-slice partition), each with its own
objective, all writing the shared study.  Two workers never share a
device: the kernels' workspaces are kept per (device, stream).
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from .config import DataConfig, SiameseTrainConfig
from .data.loader import build_cached_dataset, build_padded_native_dataset
from .data.scanner import create_sample_lists
from .device import resolve_device
from .pipelines import DeviceCache, NativeDeviceCache
from .train.siamese import SiameseTrainer
from .tuning import MedianPruner, TrialPruned, TrialState, create_study

TRIAL_EPOCHS = 15  # reference train.py:183
STUDY_NAME = "siamese_unet_tuning_v3"  # reference train.py:341
STORAGE = "sqlite:///optuna_study.db"  # reference train.py:340
N_TRIALS = 50  # reference train.py:354


def load_tuning_datasets(data_cfg: DataConfig, verbose: bool = True,
                         native_aug: bool = True):
    """Decode and cache once for the whole study (the reference re-scans
    and re-decodes per trial).  ``native_aug=True`` caches the train set
    at native resolution (``PaddedNativeDataset``), so that trials augment
    and then resize as the reference chain does (dataset.py:172-193);
    validation is always the target-size cache."""
    train_samples = create_sample_lists(
        data_cfg.root_dir, data_cfg.dataset_subdir,
        data_cfg.synthetic_data_dir, mode="train",
        use_synthetic=data_cfg.use_synthetic, verbose=verbose,
    )
    val_samples = create_sample_lists(
        data_cfg.root_dir, data_cfg.dataset_subdir,
        data_cfg.synthetic_data_dir, mode="val", verbose=verbose,
    )
    if native_aug:
        train_ds = build_padded_native_dataset(train_samples,
                                               verbose=verbose)
    else:
        train_ds = build_cached_dataset(train_samples, data_cfg.target_size,
                                        verbose=verbose)
    val_ds = build_cached_dataset(val_samples, data_cfg.target_size,
                                  verbose=verbose)
    return train_ds, val_ds


def make_objective(data_cfg: DataConfig, verbose: bool = True,
                   trial_epochs: int = TRIAL_EPOCHS, device="cuda",
                   datasets=None, name: str = "",
                   native_aug: bool = True):
    """The Optuna objective, training on ``device``.

    datasets: optional pre-built (train_ds, val_ds) shared by workers; they
    go on ``device`` once, here, and every trial of this objective reads
    them there.  native_aug: augment trials at native resolution (see
    ``load_tuning_datasets``)."""
    dev = resolve_device(device)
    train_ds, val_ds = (
        datasets if datasets is not None
        else load_tuning_datasets(data_cfg, verbose, native_aug=native_aug)
    )
    cache_cls = NativeDeviceCache if native_aug else DeviceCache
    dev_train = cache_cls.from_dataset(train_ds, dev) if len(train_ds) \
        else None
    dev_val = DeviceCache.from_dataset(val_ds, dev) if len(val_ds) else None

    def objective(trial) -> float:
        lr = trial.suggest_loguniform("lr", 1e-5, 5e-3)
        batch_size = trial.suggest_categorical("batch_size", [2, 4, 8])
        optimizer_name = trial.suggest_categorical(
            "optimizer", ["AdamW", "Adam"])
        weight_decay = trial.suggest_loguniform("weight_decay", 1e-6, 1e-3)
        focal_alpha = trial.suggest_float("focal_alpha", 0.1, 0.9)
        focal_gamma = trial.suggest_float("focal_gamma", 1.0, 3.0)
        loss_beta = trial.suggest_float("loss_beta", 0.3, 0.7)
        dice_smooth = trial.suggest_loguniform("dice_smooth", 1e-7, 1e-4)

        if dev_train is None:
            raise TrialPruned("Empty training dataset")
        if dev_val is None:
            raise TrialPruned("Empty validation dataset")

        cfg = SiameseTrainConfig(
            batch_size=batch_size,
            learning_rate=lr,
            weight_decay=weight_decay,
            focal_alpha=focal_alpha,
            focal_gamma=focal_gamma,
            loss_beta=loss_beta,
            dice_smooth=dice_smooth,
            optimizer=optimizer_name.lower(),
            seed=trial.number,
        )
        # augment=True per reference train.py:201.
        trainer = SiameseTrainer(
            cfg, dev, augment=True,
            native_out_size=data_cfg.target_size if native_aug else None)
        try:
            if verbose:
                print(
                    f"{name}Trial {trial.number}: lr={lr:.2e}, "
                    f"batch={batch_size}, opt={optimizer_name}, "
                    f"wd={weight_decay:.2e}, f_alpha={focal_alpha:.2f}, "
                    f"f_gamma={focal_gamma:.2f}, loss_beta={loss_beta:.2f}, "
                    f"dice_smooth={dice_smooth:.2e}"
                )
            trainer.generator.manual_seed(1000 + trial.number)
            epoch_rng = np.random.RandomState(trial.number)
            best = float("inf")
            for epoch in range(1, trial_epochs + 1):
                train_loss = trainer.train_epoch(dev_train, epoch_rng,
                                                 epoch=epoch)
                val_loss = trainer.validate(dev_val)
                trial.report(val_loss, epoch)
                if trial.should_prune():
                    if verbose:
                        print(f"Trial {trial.number} pruned at epoch "
                              f"{epoch}.")
                    raise TrialPruned()
                best = min(best, val_loss)
                if verbose:
                    print(
                        f"  Epoch {epoch}/{trial_epochs} - Train Loss: "
                        f"{train_loss:.4f}, Val Loss: {val_loss:.4f}"
                    )
            return best
        finally:
            # An exception's traceback keeps this frame, and so the
            # trainer, alive until the study has handled it: drop the
            # trial's model and optimizer here, before the next trial.
            del trainer

    return objective


def tuning_devices(device, n_parallel: int,
                   devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices of ``n_parallel`` workers: ``devices`` when given (each
    CUDA device at most once), else ``device`` for one worker and every
    device of its kind (``torch.cuda.device_count()`` cards; one CPU) for
    more, capped at ``n_parallel``."""
    if devices is None:
        dev = resolve_device(device)
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" and n_parallel > 1 else [dev])
    devs = [resolve_device(d) for d in devices]
    cuda = [d.index if d.index is not None else torch.cuda.current_device()
            for d in devs if d.type == "cuda"]
    if len(set(cuda)) != len(cuda):
        raise ValueError(f"two tuning workers on one card: {devices}")
    return devs[:max(1, n_parallel)]


def run_tuning(
    data_cfg: DataConfig,
    n_trials: int = N_TRIALS,
    storage: str = STORAGE,
    study_name: str = STUDY_NAME,
    trial_epochs: Optional[int] = None,
    verbose: bool = True,
    n_parallel: int = 1,
    native_aug: bool = True,
    device="cuda",
    devices: Optional[Sequence] = None,
):
    """Run the study (``trial_epochs`` defaults to ``TRIAL_EPOCHS``).
    ``n_parallel > 1`` runs that many trials at once, one worker thread
    per device (``tuning_devices``), every trial landing in the same
    study; one device runs its worker in this thread."""
    if trial_epochs is None:
        trial_epochs = TRIAL_EPOCHS
    study = create_study(
        study_name=study_name,
        storage=storage,
        direction="minimize",
        load_if_exists=True,
        pruner=MedianPruner(
            n_startup_trials=5, n_warmup_steps=5, interval_steps=1
        ),
    )
    devs = tuning_devices(device, n_parallel, devices)
    datasets = load_tuning_datasets(data_cfg, verbose, native_aug=native_aug)
    shares = [n_trials // len(devs)] * len(devs)
    for k in range(n_trials % len(devs)):
        shares[k] += 1
    errors = []

    def worker(k):
        try:
            with (torch.cuda.device(devs[k]) if devs[k].type == "cuda"
                  else contextlib.nullcontext()):
                objective = make_objective(
                    data_cfg, verbose=verbose, trial_epochs=trial_epochs,
                    device=devs[k], datasets=datasets,
                    # The JAX package names workers only when asked for
                    # parallel trials.
                    name=f"[w{k}] " if n_parallel > 1 else "",
                    native_aug=native_aug,
                )
                study.optimize(objective, n_trials=shares[k], n_jobs=1)
        except Exception as e:  # noqa: BLE001 — raised after the join
            errors.append((k, e))

    if len(devs) == 1:
        worker(0)
    else:
        threads = [threading.Thread(target=worker, args=(k,), daemon=True)
                   for k in range(len(devs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0][1]
    if verbose:
        print("\n--- Tuning Study Complete ---")
        print(f"Study name: {study_name}")
        print(f"Number of finished trials: {len(study.trials)}")
        best = study.best_trial
        print(f"Best trial number: {best.number}")
        print(f"Best validation loss: {best.value:.4f}")
        print("Best hyperparameters:")
        for key, value in best.params.items():
            if isinstance(value, float):
                print(f"  {key}: {value:.4e}")
            else:
                print(f"  {key}: {value}")
    return study


def display_study_results(storage: str = STORAGE,
                          study_name: str = STUDY_NAME) -> None:
    """Print the study report (reference show_optuna_results.py:10-66)."""
    from .tuning import load_study

    try:
        study = load_study(study_name=study_name, storage=storage)
    except Exception as e:  # noqa: BLE001
        print(f"Error loading study '{study_name}' from {storage}: {e}")
        return
    trials = study.trials
    print(f"Study: {study_name}")
    print(f"Number of trials: {len(trials)}")
    completed = [t for t in trials if t.state == TrialState.COMPLETE]
    print(f"Completed trials: {len(completed)}")
    if not completed:
        print("No completed trials.")
        return
    best = study.best_trial
    print("\n--- Best Trial ---")
    print(f"Trial number: {best.number}")
    print(f"Value (val loss): {best.value:.5f}")
    print("Params:")
    for k, v in best.params.items():
        print(f"  {k}: {v}")
    print("\n--- All Completed Trials ---")
    for t in completed:
        print(f"Trial {t.number}: value={t.value:.5f} params={t.params}")
