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

Parallel trials (``n_parallel`` k > 1) split the devices as the JAX
package does (its tune.py:232-244, ``partition_devices``): k partitions
of ``n_devices // k`` devices, trials shared out among them, every trial
landing in one study.

  * One device a partition: one worker thread a device, each with its
    own objective.  Two workers never share a device: the kernels'
    workspaces are kept per (device, stream).
  * Several: each partition is a data mesh (``parallel/mesh.py``), one
    process a device, and a trial trains data-parallel over it
    (``tune_on_ranks``).  The partition's rank 0 alone talks to the
    study: it draws the trial, broadcasts its number and its eight
    values, reports each epoch and decides on pruning, and its decision
    stops every rank of the partition after the same epoch.  A single
    process spawns one rank a card (``run_tuning``); under ``torchrun``'s
    variables, or on the ranks of an existing group, each process is one
    rank.  ``data_parallel=False`` keeps one worker thread a device.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .config import DataConfig, SiameseTrainConfig
from .data.loader import build_cached_dataset, build_padded_native_dataset
from .data.scanner import create_sample_lists
from .device import resolve_device
from .parallel.mesh import (
    DataMesh,
    LaunchError,
    maybe_distributed_init,
    rank_device,
    spawn,
    torchrun_env,
)
from .pipelines import DeviceCache, NativeDeviceCache
from .train.siamese import SiameseTrainer
from .tuning import MedianPruner, TrialPruned, TrialState, create_study

TRIAL_EPOCHS = 15  # reference train.py:183
STUDY_NAME = "siamese_unet_tuning_v3"  # reference train.py:341
STORAGE = "sqlite:///optuna_study.db"  # reference train.py:340
N_TRIALS = 50  # reference train.py:354
# The categorical choices of the search space (reference train.py:170-176).
CHOICES = {"batch_size": [2, 4, 8], "optimizer": ["AdamW", "Adam"]}
# The search space's values, in the order ``suggest`` draws them.
PARAM_NAMES = ("lr", "batch_size", "optimizer", "weight_decay",
               "focal_alpha", "focal_gamma", "loss_beta", "dice_smooth")
# How long the ranks of a study's process group wait in a collective: a
# partition that has run its share waits at the end for the slowest one.
GROUP_TIMEOUT = datetime.timedelta(days=1)


def suggest(trial) -> Dict:
    """The trial's eight values, drawn in the JAX package's order."""
    return {
        "lr": trial.suggest_loguniform("lr", 1e-5, 5e-3),
        "batch_size": trial.suggest_categorical("batch_size",
                                                CHOICES["batch_size"]),
        "optimizer": trial.suggest_categorical("optimizer",
                                               CHOICES["optimizer"]),
        "weight_decay": trial.suggest_loguniform("weight_decay", 1e-6,
                                                 1e-3),
        "focal_alpha": trial.suggest_float("focal_alpha", 0.1, 0.9),
        "focal_gamma": trial.suggest_float("focal_gamma", 1.0, 3.0),
        "loss_beta": trial.suggest_float("loss_beta", 0.3, 0.7),
        "dice_smooth": trial.suggest_loguniform("dice_smooth", 1e-7, 1e-4),
    }


def encode_trial(number: int, params: Dict) -> List[float]:
    """A trial as floats for ``DataMesh.broadcast_values``: 1 (a trial
    follows), its number, then each value in ``PARAM_NAMES`` order (a
    categorical as its index among the choices).  Float64 carries every
    value exactly."""
    return [1.0, float(number)] + [
        float(CHOICES[k].index(params[k])) if k in CHOICES
        else float(params[k]) for k in PARAM_NAMES]


STOP = [0.0] * (2 + len(PARAM_NAMES))  # no more trials


def decode_trial(values: Sequence[float]):
    """(number, params) of ``encode_trial``'s floats; None for ``STOP``."""
    if not values[0]:
        return None
    params = {k: CHOICES[k][int(v)] if k in CHOICES else v
              for k, v in zip(PARAM_NAMES, values[2:])}
    return int(values[1]), params


class SharedTrial:
    """A partition rank's view of the trial that its rank 0 drew: the same
    number and values, no study.  Its reports go nowhere and it never
    prunes by itself: rank 0's decision reaches it through
    ``DataMesh.agree``."""

    def __init__(self, number: int, params: Dict):
        self.number = number
        self.params = dict(params)

    def _get(self, name, *args, **kwargs):
        return self.params[name]

    suggest_loguniform = suggest_float = suggest_categorical = _get

    def report(self, value: float, step: int) -> None:
        pass

    def should_prune(self) -> bool:
        return False


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
                   native_aug: bool = True, mesh: Optional[DataMesh] = None):
    """The Optuna objective, training on ``device``, or data-parallel over
    ``mesh`` (a ``DataMesh`` of the partition's ranks, on its device), as
    the JAX package's takes ``mesh=``.

    datasets: optional pre-built (train_ds, val_ds) shared by workers; they
    go on the device once, here, and every trial of this objective reads
    them there.  native_aug: augment trials at native resolution (see
    ``load_tuning_datasets``).  Under a mesh of several ranks, rank 0's
    objective takes a study trial and broadcasts it; the other ranks'
    take the ``SharedTrial`` that ``follow_trials`` makes of it.

    ``objective.trials`` lists what each trial ran: its number, values,
    epoch losses and how it ended."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    if mesh is not None and mesh.world_size == 1:
        mesh = None  # one rank: a plain trial on its device
    train_ds, val_ds = (
        datasets if datasets is not None
        else load_tuning_datasets(data_cfg, verbose, native_aug=native_aug)
    )
    cache_cls = NativeDeviceCache if native_aug else DeviceCache
    dev_train = cache_cls.from_dataset(train_ds, dev) if len(train_ds) \
        else None
    dev_val = DeviceCache.from_dataset(val_ds, dev) if len(val_ds) else None
    trials = []

    def objective(trial) -> float:
        params = suggest(trial)
        if mesh is not None and mesh.is_main:
            mesh.broadcast_values(*encode_trial(trial.number, params))
        record = {"number": trial.number, "params": params,
                  "train_loss": [], "val_loss": [], "state": "RUNNING"}
        trials.append(record)
        try:
            value = run_trial(trial, params, record)
        except TrialPruned:
            record["state"] = "PRUNED"
            raise
        except BaseException:
            record["state"] = "FAIL"
            raise
        record["state"] = "COMPLETE"
        return value

    def run_trial(trial, params, record) -> float:
        if dev_train is None:
            raise TrialPruned("Empty training dataset")
        if dev_val is None:
            raise TrialPruned("Empty validation dataset")

        cfg = SiameseTrainConfig(
            batch_size=params["batch_size"],
            learning_rate=params["lr"],
            weight_decay=params["weight_decay"],
            focal_alpha=params["focal_alpha"],
            focal_gamma=params["focal_gamma"],
            loss_beta=params["loss_beta"],
            dice_smooth=params["dice_smooth"],
            optimizer=params["optimizer"].lower(),
            seed=trial.number,
        )
        # augment=True per reference train.py:201.
        trainer = SiameseTrainer(
            cfg, dev, augment=True,
            native_out_size=data_cfg.target_size if native_aug else None,
            **({"mesh": mesh} if mesh is not None else {}))
        try:
            if verbose:
                print(
                    f"{name}Trial {trial.number}: lr={params['lr']:.2e}, "
                    f"batch={params['batch_size']}, "
                    f"opt={params['optimizer']}, "
                    f"wd={params['weight_decay']:.2e}, "
                    f"f_alpha={params['focal_alpha']:.2f}, "
                    f"f_gamma={params['focal_gamma']:.2f}, "
                    f"loss_beta={params['loss_beta']:.2f}, "
                    f"dice_smooth={params['dice_smooth']:.2e}"
                )
            trainer.generator.manual_seed(1000 + trial.number)
            epoch_rng = np.random.RandomState(trial.number)
            best = float("inf")
            for epoch in range(1, trial_epochs + 1):
                train_loss = trainer.train_epoch(dev_train, epoch_rng,
                                                 epoch=epoch)
                val_loss = trainer.validate(dev_val)
                record["train_loss"].append(train_loss)
                record["val_loss"].append(val_loss)
                trial.report(val_loss, epoch)
                prune = trial.should_prune()
                if mesh is not None:  # rank 0's decision, on every rank
                    prune = mesh.agree(prune)
                if prune:
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

    objective.trials = trials
    return objective


def follow_trials(objective, mesh: DataMesh) -> None:
    """A partition rank other than 0: run each trial that rank 0
    broadcasts through ``objective`` (``make_objective`` on ``mesh``),
    until it broadcasts ``STOP``.  A pruned trial goes on to the next; an
    error ends the loop with it."""
    while True:
        got = decode_trial(mesh.broadcast_values(*STOP))
        if got is None:
            return
        with contextlib.suppress(TrialPruned):
            objective(SharedTrial(*got))


def partition_devices(n_devices: int, n_parallel: int) -> List[List[int]]:
    """The device indices of each parallel-trial worker, by the JAX
    package's rule (its tune.py:218-244): ``n_parallel`` <= 1 is one
    worker on device 0; else k = min(n_parallel, n_devices) workers,
    worker j on devices j*per ... (j+1)*per - 1 with per = n_devices // k
    (the devices past k*per stay idle).  A worker of one device trains
    alone on it; one of several trains data-parallel over them."""
    if n_devices < 1:
        raise ValueError(f"no devices to tune on: {n_devices}")
    if n_parallel <= 1:
        return [[0]]
    k = min(n_parallel, n_devices)
    per = n_devices // k
    return [list(range(j * per, (j + 1) * per)) for j in range(k)]


def trial_shares(n_trials: int, n_workers: int) -> List[int]:
    """Trials a worker runs: ``n_trials // n_workers``, one more for the
    first ``n_trials % n_workers`` (the JAX package's rule)."""
    shares = [n_trials // n_workers] * n_workers
    for k in range(n_trials % n_workers):
        shares[k] += 1
    return shares


def tuning_devices(device, n_parallel: int,
                   devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices of ``n_parallel`` worker threads: ``devices`` when given
    (each CUDA device at most once), else ``device`` for one worker and
    every device of its kind (``torch.cuda.device_count()`` cards; one
    CPU) for more, capped at ``n_parallel``."""
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


def _study(study_name: str, storage: str):
    return create_study(
        study_name=study_name,
        storage=storage,
        direction="minimize",
        load_if_exists=True,
        pruner=MedianPruner(
            n_startup_trials=5, n_warmup_steps=5, interval_steps=1
        ),
    )


def _print_summary(study, study_name: str) -> None:
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


def tune_on_ranks(
    data_cfg: DataConfig,
    n_trials: int = N_TRIALS,
    storage: str = STORAGE,
    study_name: str = STUDY_NAME,
    trial_epochs: Optional[int] = None,
    verbose: bool = True,
    n_parallel: int = 1,
    native_aug: bool = True,
    device="cuda",
) -> Dict:
    """This rank's part of a study run by every rank of the default
    process group (each rank calls it with the same arguments).  The
    world is partitioned by ``partition_devices(world_size, n_parallel)``
    into data meshes, each with its own ``torch.distributed.new_group``
    (made by every rank, in one order); a rank past the partitions stays
    idle.  Each partition runs its ``trial_shares`` share of the trials,
    one at a time over all its ranks; its rank 0 alone opens the study.
    Every rank then waits for every partition (a barrier: the group's
    timeout must outlast the longest share), and global rank 0 prints the
    summary.  Returns {"partition", "mesh", "trials" (what each of this
    rank's trials ran), "study" (on a partition's rank 0, else None)}."""
    if trial_epochs is None:
        trial_epochs = TRIAL_EPOCHS
    world, rank = dist.get_world_size(), dist.get_rank()
    parts = partition_devices(world, n_parallel)
    groups = [dist.new_group(p) if len(p) > 1 else None for p in parts]
    j = next((j for j, p in enumerate(parts) if rank in p), None)
    report = {"partition": j, "mesh": None, "trials": [], "study": None}
    if j is not None:
        mesh = report["mesh"] = DataMesh(
            len(parts[j]), parts[j].index(rank), rank_device(device),
            dist.get_backend(), groups[j])
        objective = make_objective(
            data_cfg, verbose=verbose and mesh.is_main,
            trial_epochs=trial_epochs,
            datasets=load_tuning_datasets(data_cfg, verbose and rank == 0,
                                          native_aug=native_aug),
            name=f"[w{j}] " if n_parallel > 1 else "",
            native_aug=native_aug, mesh=mesh)
        report["trials"] = objective.trials
        if mesh.is_main:
            study = report["study"] = _study(study_name, storage)
            study.optimize(objective, n_trials=trial_shares(
                n_trials, len(parts))[j], n_jobs=1)
            if mesh.world_size > 1:
                mesh.broadcast_values(*STOP)
        else:
            follow_trials(objective, mesh)
    dist.barrier()
    if verbose and rank == 0:
        _print_summary(report["study"], study_name)
    # Only here: after an error the partition's other ranks wait in their
    # collectives until the launcher ends them, so that the run ends with
    # this rank's error, not with theirs about a closed connection.
    if j is not None and groups[j] is not None:
        dist.destroy_process_group(groups[j])
    return report


def _tune_rank(kwargs: Dict) -> Dict:
    """A spawned rank of ``run_tuning``: its part of the study, without
    the mesh and the study, which do not pickle."""
    report = tune_on_ranks(**kwargs)
    return {"partition": report["partition"], "trials": report["trials"]}


def _n_devices(device, n_parallel: int, devices) -> int:
    """The devices ``run_tuning`` partitions in this process: those
    given, else every card for a CUDA study of several workers, else
    one."""
    if devices is not None:
        return len(devices)
    if resolve_device(device).type == "cuda" and n_parallel > 1:
        return torch.cuda.device_count()
    return 1


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
    data_parallel: bool = True,
):
    """Run the study (``trial_epochs`` defaults to ``TRIAL_EPOCHS``).
    ``n_parallel > 1`` runs that many trials at once on the partitions of
    ``partition_devices``, every trial landing in the same study:

      * in a process group of several ranks (one that exists, or one that
        ``torchrun``'s variables describe, which this joins and leaves):
        ``tune_on_ranks``, over the ranks; returns this rank's report;
      * else, partitions of several cards (and ``data_parallel``): one
        rank a card of the partitions, spawned (``parallel.mesh.spawn``),
        then the study read back from ``storage``;
      * else one worker thread a device (``tuning_devices``, or the
        ``devices`` given); one device runs its worker in this thread.

    ``data_parallel`` False under a ``torchrun`` world of several ranks
    raises ``LaunchError``: each rank would run the whole study alone."""
    kwargs = dict(data_cfg=data_cfg, n_trials=n_trials, storage=storage,
                  study_name=study_name, trial_epochs=trial_epochs,
                  verbose=verbose, n_parallel=n_parallel,
                  native_aug=native_aug, device=device)
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return tune_on_ranks(**kwargs)
    if torchrun_env() and int(os.environ["WORLD_SIZE"]) > 1:
        if not data_parallel:
            raise LaunchError(
                "--no-data-parallel tunes with one worker thread a device "
                f"in one process, not in {os.environ['WORLD_SIZE']} ranks")
        maybe_distributed_init(device, GROUP_TIMEOUT)
        # Left only after a success, as tune_on_ranks leaves its groups.
        report = tune_on_ranks(**kwargs)
        dist.destroy_process_group()
        return report
    parts = partition_devices(_n_devices(device, n_parallel, devices),
                              n_parallel)
    if len(parts[0]) > 1 and data_parallel and devices is None:
        spawn(_tune_rank, (kwargs,), sum(map(len, parts)), device,
              GROUP_TIMEOUT)
        study = _study(study_name, storage)
        if verbose:
            _print_summary(study, study_name)
        return study
    if trial_epochs is None:
        trial_epochs = TRIAL_EPOCHS
    study = _study(study_name, storage)
    devs = tuning_devices(device, n_parallel, devices)
    datasets = load_tuning_datasets(data_cfg, verbose, native_aug=native_aug)
    shares = trial_shares(n_trials, len(devs))
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
        _print_summary(study, study_name)
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
