"""The child-process side of tests/test_torch_tune_submesh.py: what a rank
of a sub-mesh study runs, and the study-file writers of the race test.
It imports torch and the port only (no JAX), so that a child starts
fast.

  * ``cli_rank``: ``python -m gan_aug_pfa_torch.train --tune`` as one rank
    under ``torchrun``'s variables, at float64 (``Float64Trainer``,
    ``float64_datasets``), ``TRIAL_EPOCHS`` epochs a trial, rank 2 (the
    second partition's rank 0) pruning its first trial at epoch 1; each
    rank writes what its trials ran to ``rank<R>.json``;
  * ``failing_rank``: a spawned rank whose rank 3 raises in its first
    epoch;
  * ``race_writer``: trials of a trivial objective into one study file,
    with a pause after each read of ``MAX(number)``.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np

from gan_aug_pfa_torch import tune
from gan_aug_pfa_torch.config import DataConfig
from gan_aug_pfa_torch.train.optim import make_optimizer
from gan_aug_pfa_torch.train.siamese import SiameseTrainer

TRIAL_EPOCHS = 2
SIZE = (32, 32)
FAIL_RANK = 3
RACE_PAUSE_S = 0.02


class Float64Trainer(SiameseTrainer):
    """The tuning trainer at float64: no autocast, the model and its
    optimizer in float64 (PR 14's rule needs float64 to hold two orders
    of sums within 1e-8)."""

    def __init__(self, cfg, device, **kw):
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
        super().__init__(cfg, device, **kw)
        self.model.double()
        self.optimizer = make_optimizer(cfg.optimizer,
                                        self.model.parameters(),
                                        cfg.learning_rate, cfg.weight_decay)


LOAD = tune.load_tuning_datasets


def float64_datasets(data_cfg, verbose=True, native_aug=True):
    """``tune.load_tuning_datasets`` with float64 images."""
    return tuple(dataclasses.replace(ds, img1=ds.img1.astype(np.float64),
                                     img2=ds.img2.astype(np.float64))
                 for ds in LOAD(data_cfg, verbose, native_aug=native_aug))


class PruneFirst:
    """Prunes the first trial it is asked about, at its first report."""

    def __init__(self, *args, **kwargs):
        self.first = None

    def should_prune(self, study, trial):
        if self.first is None:
            self.first = trial.number
        return trial.number == self.first


def at_float64():
    tune.SiameseTrainer = Float64Trainer
    tune.load_tuning_datasets = float64_datasets
    tune.TRIAL_EPOCHS = TRIAL_EPOCHS


def cli_rank():
    """``python -c 'import torch_tune_ranks as r; r.cli_rank()' OUT ARGV``:
    the training CLI on ``ARGV`` as this rank; ``OUT/rank<R>.json`` holds
    the partition, each trial's record and the type ``main`` returned."""
    from gan_aug_pfa_torch.train import __main__ as train_cli

    out, argv = sys.argv[1], sys.argv[2:]
    rank = int(os.environ["RANK"])
    at_float64()
    if rank == 2:
        tune.MedianPruner = PruneFirst
    made, make = [], tune.make_objective

    def recorded(*args, **kwargs):
        objective = make(*args, **kwargs)
        made.append((kwargs["mesh"], objective))
        return objective

    tune.make_objective = recorded
    result = train_cli.main(argv)
    (mesh, objective), = made
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"mesh": [mesh.world_size, mesh.rank],
                   "returned": type(result).__name__,
                   "trials": objective.trials}, f)


class _Failing(Float64Trainer):
    def train_epoch(self, *args, **kwargs):
        if int(os.environ["RANK"]) == FAIL_RANK:
            raise RuntimeError(f"rank {FAIL_RANK} failed")
        return super().train_epoch(*args, **kwargs)


def failing_rank(tree, storage):
    """A rank of ``parallel.mesh.spawn``: a sub-mesh study whose rank
    ``FAIL_RANK`` raises in its first epoch."""
    at_float64()
    tune.SiameseTrainer = _Failing
    return tune.run_tuning(DataConfig(root_dir=tree, target_size=SIZE),
                           n_trials=2, storage=storage, verbose=False,
                           n_parallel=2, device="cpu")


class _PausedConnection:
    """A sqlite3 connection that pauses after each read of a new trial's
    number: another process then has time to read the same one, unless
    the write lock is held across the read and the insert."""

    def __init__(self, conn):
        self._conn = conn

    def execute(self, sql, *args):
        cur = self._conn.execute(sql, *args)
        if sql.startswith("SELECT COALESCE(MAX(number)"):
            time.sleep(RACE_PAUSE_S)
        return cur

    def __getattr__(self, name):
        return getattr(self._conn, name)


def race_writer(path, study_name, n_trials, start):
    """``n_trials`` trials of a trivial objective into the study file
    ``path`` once ``start`` (an event) is set, through
    ``_PausedConnection``s."""
    import sqlite3
    import types

    from gan_aug_pfa_torch.tuning import ministudy

    ministudy.sqlite3 = types.SimpleNamespace(
        connect=lambda *a, **k: _PausedConnection(sqlite3.connect(*a, **k)),
        Error=sqlite3.Error, OperationalError=sqlite3.OperationalError)
    study = ministudy.create_study(study_name=study_name,
                                   storage=f"sqlite:///{path}",
                                   load_if_exists=True)
    start.wait()
    study.optimize(lambda trial: trial.suggest_float("x", 0.0, 1.0),
                   n_trials=n_trials)
