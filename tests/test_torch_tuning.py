"""The port's tuning (``gan_aug_pfa_torch/tune.py``, ``tuning/``) against
the JAX package's on the CPU.

  * the port's ``ministudy`` copy and the JAX one, with one sampler seed
    and one scripted objective, draw the same parameters, prune at the
    same steps and store the same rows;
  * both ``make_objective``s, with the trainer replaced by a recording
    stub (no training, no JAX compile), build the same per-trial configs,
    draw the same epoch orders, report, prune and return the same values
    and print the same lines;
  * a study file written by either package is read by the other's
    ``display_study_results`` with the same report, and the port reads a
    file in real Optuna's schema;
  * ``python -m gan_aug_pfa_torch.train --tune`` runs a real two-trial
    study at 32x32 on the CPU and ``show_optuna_results`` reports it;
    parallel trials run one worker thread a device into one study; each
    trial's trainer is released when the trial ends.
"""

import contextlib
import io
import json
import math
import sqlite3
import threading
import weakref

import numpy as np
import pytest
import torch

from gan_aug_pfa_torch import show_optuna_results as show_cli
from gan_aug_pfa_torch import tune as ttune
from gan_aug_pfa_torch.config import DataConfig
from gan_aug_pfa_torch.train import __main__ as train_cli
from gan_aug_pfa_torch.tuning import ministudy as tms
from gan_aug_pfa_tpu import tune as jtune
from gan_aug_pfa_tpu.config import DataConfig as JaxDataConfig
from gan_aug_pfa_tpu.tuning import ministudy as jms
from torch_tmp import drop_tmp_path  # noqa: F401

SIZE = (32, 32)
STUDY = "s"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Full-width trials on the CPU: two torch threads, so that Tier-1's
    workers stay off each other's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _pruner(ms):
    return ms.MedianPruner(n_startup_trials=5, n_warmup_steps=5,
                           interval_steps=1)


def _space(trial):
    """tune.make_objective's suggest calls, in its order."""
    return {
        "lr": trial.suggest_loguniform("lr", 1e-5, 5e-3),
        "batch_size": trial.suggest_categorical("batch_size", [2, 4, 8]),
        "optimizer": trial.suggest_categorical("optimizer",
                                               ["AdamW", "Adam"]),
        "weight_decay": trial.suggest_loguniform("weight_decay", 1e-6,
                                                 1e-3),
        "focal_alpha": trial.suggest_float("focal_alpha", 0.1, 0.9),
        "focal_gamma": trial.suggest_float("focal_gamma", 1.0, 3.0),
        "loss_beta": trial.suggest_float("loss_beta", 0.3, 0.7),
        "dice_smooth": trial.suggest_loguniform("dice_smooth", 1e-7, 1e-4),
    }


def _scripted(ms, log, steps=7):
    """An objective whose per-step values depend on the drawn parameters,
    so that guided sampling and pruning both act."""
    def objective(trial):
        p = _space(trial)
        score = (abs(math.log10(p["lr"]) + 3.5)
                 + abs(p["focal_alpha"] - 0.6) + 0.1 * p["batch_size"] / 8
                 + 0.05 * (p["optimizer"] == "Adam"))
        value = None
        for step in range(1, steps + 1):
            value = score + 1.0 / step
            trial.report(value, step)
            if trial.should_prune():
                log.append((trial.number, step))
                raise ms.TrialPruned()
        return value
    return objective


def _rows(study):
    """Every stored row but the clock's."""
    c = study._conn
    return {
        "studies": c.execute("SELECT * FROM studies").fetchall(),
        "trials": c.execute("SELECT trial_id, study_id, number, state, "
                            "value FROM trials ORDER BY trial_id").fetchall(),
        "params": c.execute("SELECT * FROM trial_params").fetchall(),
        "intermediate": c.execute(
            "SELECT * FROM intermediate_values").fetchall(),
    }


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_ministudy_sampler_and_pruner_match_jax(seed):
    """16 trials (past the 8-completed-trial gate of guided sampling)."""
    out = {}
    for side, ms in (("port", tms), ("jax", jms)):
        log = []
        study = ms.create_study(study_name=STUDY, storage=None,
                                pruner=_pruner(ms), sampler_seed=seed)
        study.optimize(_scripted(ms, log), n_trials=16)
        out[side] = (
            [(t.number, t.state.value, t.value, t.params,
              t.intermediate_values) for t in study.trials],
            log, _rows(study))
    assert out["port"] == out["jax"]
    trials, pruned, _ = out["port"]
    assert pruned  # the pruner acted ...
    assert sum(t[1] == "COMPLETE" for t in trials) >= 9  # ... and the
    # guided sampler too


# -- the objective, with the trainer stubbed ------------------------------


def _val_loss(seed, epoch):
    """Trials 5-7 are worse than the first five's median from epoch 5."""
    return 0.5 + 0.05 * ((seed * 3) % 5) - 0.01 * epoch + (
        0.2 if seed >= 5 and seed % 2 else 0.0)


class _Recorder:
    def __init__(self):
        self.configs, self.orders, self.seeds = [], [], []

    def config(self, cfg, augment, native_out_size):
        self.configs.append({k: getattr(cfg, k) for k in (
            "batch_size", "learning_rate", "weight_decay", "focal_alpha",
            "focal_gamma", "loss_beta", "dice_smooth", "optimizer", "seed")}
            | {"augment": augment,
               "native_out_size": tuple(native_out_size)})


def _jax_stub(rec):
    class Stub:
        def __init__(self, cfg, mesh=None, augment=False,
                     native_out_size=None):
            rec.config(cfg, augment, native_out_size)
            self.seed, self.epoch = cfg.seed, 0

        def init_state(self, rng, size):
            return None

        def _device_arrays(self, ds):
            return None

        def train_epoch(self, state, dev, n, erng, epoch_rng):
            self.epoch += 1
            rec.orders.append(epoch_rng.permutation(n).tolist())
            return state, 1.0 / self.epoch

        def validate(self, state, dev, n):
            return _val_loss(self.seed, self.epoch)

    return Stub


def _port_stub(rec):
    class Generator:
        def manual_seed(self, seed):
            rec.seeds.append(seed)

    class Stub:
        def __init__(self, cfg, device, augment=False, native_out_size=None):
            rec.config(cfg, augment, native_out_size)
            self.seed, self.epoch = cfg.seed, 0
            self.generator = Generator()

        def train_epoch(self, cache, epoch_rng, epoch=None):
            self.epoch += 1
            assert epoch == self.epoch
            rec.orders.append(epoch_rng.permutation(len(cache)).tolist())
            return 1.0 / self.epoch

        def validate(self, cache):
            return _val_loss(self.seed, self.epoch)

    return Stub


def _run_objective(side, root, monkeypatch, n_trials=8, epochs=6):
    rec = _Recorder()
    if side == "jax":
        ms, module = jms, jtune
        monkeypatch.setattr(jtune, "SiameseTrainer", _jax_stub(rec))
        data = JaxDataConfig(root_dir=root, target_size=SIZE)
        kw = {}
    else:
        ms, module = tms, ttune
        monkeypatch.setattr(ttune, "SiameseTrainer", _port_stub(rec))
        data = DataConfig(root_dir=root, target_size=SIZE)
        kw = {"device": "cpu"}
    datasets = module.load_tuning_datasets(data, verbose=False)
    objective = module.make_objective(data, trial_epochs=epochs,
                                      datasets=datasets, **kw)
    study = ms.create_study(study_name=STUDY, storage=None,
                            pruner=_pruner(ms), sampler_seed=3)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        study.optimize(objective, n_trials=n_trials)
    trials = [(t.number, t.state.value, t.value, t.intermediate_values)
              for t in study.trials]
    return rec, trials, buf.getvalue().splitlines(), len(datasets[0])


def test_objective_matches_jax_with_stub_trainer(oscd_tree, monkeypatch):
    got = _run_objective("port", str(oscd_tree), monkeypatch)
    want = _run_objective("jax", str(oscd_tree), monkeypatch)
    rec, trials, lines, n_train = got
    assert rec.configs == want[0].configs
    assert [c["seed"] for c in rec.configs] == list(range(8))
    assert all(c["augment"] and c["native_out_size"] == SIZE
               for c in rec.configs)
    assert rec.orders == want[0].orders
    assert rec.orders[0] == np.random.RandomState(0).permutation(
        n_train).tolist()
    assert rec.seeds == [1000 + n for n in range(8)]
    assert trials == want[1]
    states = [t[1] for t in trials]
    assert "PRUNED" in states and "COMPLETE" in states
    # A completed trial returns its best validation loss.
    for number, state, value, inter in trials:
        if state == "COMPLETE":
            assert value == min(inter.values())
    assert lines == want[2]
    assert any("pruned at epoch" in line for line in lines)


# -- the study file between the packages ------------------------------------


def _report(display, storage, study_name=STUDY):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        display(storage=storage, study_name=study_name)
    return buf.getvalue()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_study_file_read_by_the_other_package(writer, tmp_path):
    ms = tms if writer == "port" else jms
    storage = f"sqlite:///{tmp_path / 'study.db'}"
    study = ms.create_study(study_name=STUDY, storage=storage,
                            pruner=_pruner(ms), sampler_seed=5,
                            load_if_exists=True)
    study.optimize(_scripted(ms, []), n_trials=9)
    port = _report(ttune.display_study_results, storage)
    assert port == _report(jtune.display_study_results, storage)
    assert "Number of trials: 9" in port and "--- Best Trial ---" in port
    # Each package's study object reads the other's file the same way.
    other = (jms if writer == "port" else tms).load_study(STUDY, storage)
    assert [(t.number, t.state.value, t.value, t.params,
             t.intermediate_values) for t in other.trials] == [
        (t.number, t.state.value, t.value, t.params, t.intermediate_values)
        for t in study.trials]


def test_reads_a_real_optuna_schema_file(tmp_path):
    """A file in real Optuna's schema (tests/test_tuning.py's): categorical
    choice indices decoded, the same report as the JAX package's; writing
    into it is refused."""
    db = str(tmp_path / "real_optuna.db")
    c = sqlite3.connect(db)
    c.executescript(
        """
        CREATE TABLE studies (study_id INTEGER PRIMARY KEY, study_name TEXT);
        CREATE TABLE study_directions (study_direction_id INTEGER PRIMARY
          KEY, direction TEXT, study_id INTEGER, objective INTEGER);
        CREATE TABLE trials (trial_id INTEGER PRIMARY KEY, number INTEGER,
          study_id INTEGER, state TEXT, datetime_start TEXT,
          datetime_complete TEXT);
        CREATE TABLE trial_params (param_id INTEGER PRIMARY KEY,
          trial_id INTEGER, param_name TEXT, param_value REAL,
          distribution_json TEXT);
        CREATE TABLE trial_values (trial_value_id INTEGER PRIMARY KEY,
          trial_id INTEGER, objective INTEGER, value REAL, value_type TEXT);
        CREATE TABLE trial_intermediate_values (trial_intermediate_value_id
          INTEGER PRIMARY KEY, trial_id INTEGER, step INTEGER,
          intermediate_value REAL, intermediate_value_type TEXT);
        """
    )
    c.execute("INSERT INTO studies VALUES (1, 's')")
    c.execute("INSERT INTO study_directions VALUES (1, 'MINIMIZE', 1, 0)")
    c.execute("INSERT INTO trials VALUES (1, 0, 1, 'COMPLETE', 't0', 't1')")
    c.execute("INSERT INTO trials VALUES (2, 1, 1, 'PRUNED', 't0', 't1')")
    cat = json.dumps({"name": "CategoricalDistribution",
                      "attributes": {"choices": ["AdamW", "Adam"]}})
    flt = json.dumps({"name": "FloatDistribution",
                      "attributes": {"low": 1e-5, "high": 1e-2}})
    c.execute("INSERT INTO trial_params VALUES (1, 1, 'optimizer', 1, ?)",
              (cat,))
    c.execute("INSERT INTO trial_params VALUES (2, 1, 'lr', 3e-4, ?)",
              (flt,))
    c.execute("INSERT INTO trial_values VALUES (1, 1, 0, 0.42, 'FINITE')")
    c.execute("INSERT INTO trial_intermediate_values VALUES (1, 1, 1, 0.5, "
              "'FINITE')")
    c.commit()
    c.close()
    storage = f"sqlite:///{db}"
    study = tms.load_study(STUDY, storage)
    assert [t.state for t in study.trials] == [tms.TrialState.COMPLETE,
                                               tms.TrialState.PRUNED]
    best = study.best_trial
    assert best.value == pytest.approx(0.42)
    assert best.params == {"optimizer": "Adam", "lr": pytest.approx(3e-4)}
    assert best.intermediate_values == {1: 0.5}
    report = _report(ttune.display_study_results, storage)
    assert report == _report(jtune.display_study_results, storage)
    assert "Trial 0: value=0.42000" in report
    with pytest.raises(ValueError, match="real Optuna"):
        tms.create_study(study_name=STUDY, storage=storage,
                         load_if_exists=True)


# -- the CLI and real trials ----------------------------------------------


def test_cli_tunes_on_the_cpu_and_show_results_reports(oscd_tree, tmp_path,
                                                       monkeypatch, capsys):
    """Two real trials of one epoch at 32x32 (TRIAL_EPOCHS patched), with
    JAX's note for ``--stream``; the study file lands in the working
    directory and ``show_optuna_results`` reports both trials."""
    monkeypatch.setattr(ttune, "TRIAL_EPOCHS", 1)
    monkeypatch.chdir(tmp_path)
    study = train_cli.main(["--root-dir", str(oscd_tree), "--tune",
                            "--n-trials", "2", "--device", "cpu",
                            "--target-size", "32x32", "--stream", "host"])
    out = capsys.readouterr().out
    assert (tmp_path / "optuna_study.db").exists()
    assert "--stream applies only to main training" in out
    assert "Trial 0: lr=" in out and "Trial 1: lr=" in out
    assert "  Epoch 1/1 - Train Loss: " in out
    assert "--- Tuning Study Complete ---" in out
    assert "Number of finished trials: 2" in out
    states = [t.state for t in study.trials]
    assert states == [tms.TrialState.COMPLETE] * 2
    assert all(np.isfinite(t.value) for t in study.trials)
    show_cli.main([])
    report = capsys.readouterr().out
    assert "Study: siamese_unet_tuning_v3" in report
    assert "Number of trials: 2" in report and "Completed trials: 2" in report
    # The JAX package's report of the port's file is the same.
    assert report == _report(jtune.display_study_results, jtune.STORAGE,
                             jtune.STUDY_NAME)


def test_cli_tune_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--root-dir", str(tmp_path), "--tune",
                        "--n-trials", "1"])


def test_parallel_trials_one_worker_thread_a_device(oscd_tree, tmp_path,
                                                    monkeypatch, capsys):
    """Two CPU devices given explicitly: two worker threads, each with its
    own objective on its own device, write five trials into one study."""
    seen = []

    class Stub:
        def __init__(self, cfg, device, augment=False, native_out_size=None):
            seen.append((cfg.seed, threading.get_ident(), device))
            self.generator = torch.Generator()

        def train_epoch(self, cache, epoch_rng, epoch=None):
            return 0.5

        def validate(self, cache):
            return 0.25

    monkeypatch.setattr(ttune, "SiameseTrainer", Stub)
    study = ttune.run_tuning(
        DataConfig(root_dir=str(oscd_tree), target_size=SIZE), n_trials=5,
        storage=f"sqlite:///{tmp_path / 'p.db'}", trial_epochs=1,
        n_parallel=2, device="cpu", devices=["cpu", "cpu"])
    out = capsys.readouterr().out
    assert len(study.trials) == 5
    assert sorted(s for s, _, _ in seen) == list(range(5))
    assert len({t for _, t, _ in seen}) == 2
    assert threading.get_ident() not in {t for _, t, _ in seen}
    assert out.count("[w0] Trial") == 3 and out.count("[w1] Trial") == 2
    # Without an explicit list the CPU is one device: one worker.
    assert ttune.tuning_devices("cpu", 4) == [torch.device("cpu")]


def test_each_trials_trainer_is_released(oscd_tree, monkeypatch):
    """The real trainer at 32x32 for one epoch: after a completed trial and
    after a pruned one, nothing holds the trial's trainer or model."""
    refs = []

    class Tracked(ttune.SiameseTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            refs.append((weakref.ref(self), weakref.ref(self.model)))

    class PruneSecond:
        def should_prune(self, study, trial):
            return trial.number == 1

    monkeypatch.setattr(ttune, "SiameseTrainer", Tracked)
    data = DataConfig(root_dir=str(oscd_tree), target_size=SIZE)
    objective = ttune.make_objective(data, verbose=False, trial_epochs=1,
                                     device="cpu")
    study = tms.create_study(study_name=STUDY, storage=None,
                             pruner=PruneSecond(), sampler_seed=0)
    for state in ("COMPLETE", "PRUNED"):
        study.optimize(objective, n_trials=1)
        assert study.trials[-1].state.value == state
        assert all(r() is None for pair in refs for r in pair), state
    assert len(refs) == 2
