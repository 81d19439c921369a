"""Tuning over data-parallel sub-meshes (``gan_aug_pfa_torch/tune.py``
``tune_on_ranks``, ``tuning/ministudy.py``) on the CPU.

One module-scoped run starts four ``python -m gan_aug_pfa_torch.train
--tune --n-trials 4 --parallel-trials 2 --device cpu`` processes under
``torchrun``'s variables (gloo; ``tests/torch_tune_ranks.py`` sets them
to float64 and 2 epochs a trial, and makes the second partition's rank 0
prune its first trial at epoch 1).  The world splits into two partitions
of two ranks, each training its trials data-parallel with the real
``SiameseTrainer`` at 32x32:

  * each trial's epoch losses, and the value the study holds for it,
    equal the same trial run in one process with the same values within
    1e-8 (float64), and both ranks of a partition ran the same epochs
    with equal losses;
  * the study holds trials 0..3, each once, COMPLETE or PRUNED, with each
    trial's values and per-epoch validation losses; the JAX package's
    engine reads the file the same; the pruned trial stopped both of its
    ranks after epoch 1;
  * a rank that raises ends a spawned study with its error (not with the
    closed connection its partner meets);
  * the partition rule equals the meshes the JAX package's ``run_tuning``
    builds on 1-8 of the 8 virtual CPU devices for 1-8 parallel trials,
    and so do the shares of trials;
  * in a single process, partitions of several devices spawn one rank a
    device, and one device a partition (or ``--no-data-parallel``) keeps
    the worker threads;
  * two processes taking trials from one study file at once get distinct
    numbers, even with a pause between reading ``MAX(number)`` and
    inserting the trial's row.
"""

import json
import multiprocessing
import os
import subprocess
import sys
import threading

import pytest
import torch

from gan_aug_pfa_torch import tune
from gan_aug_pfa_torch.config import DataConfig
from gan_aug_pfa_torch.parallel import mesh as pm
from gan_aug_pfa_torch.train import __main__ as train_cli
from gan_aug_pfa_torch.tuning import ministudy as tms
from gan_aug_pfa_tpu import tune as jtune
from gan_aug_pfa_tpu.tuning import ministudy as jms
import torch_tune_ranks as ranks
from torch_tmp import drop_tmp_path, dropped  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
WORLD, PARALLEL, N_TRIALS = 4, 2, 4
RTOL = 1e-8
LEADERS = (0, 2)  # each partition's rank 0


def _rank_env(rank, port):
    return dict(os.environ, WORLD_SIZE=str(WORLD), RANK=str(rank),
                LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(WORLD),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                OMP_NUM_THREADS="2",
                PYTHONPATH=os.pathsep.join(
                    [REPO, TESTS, os.environ.get("PYTHONPATH", "")]))


def _single(data, datasets, trial):
    """The trial of a rank's record, run in this process without a mesh at
    float64 for as many epochs: its record (``make_objective``'s) and the
    value returned."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tune, "SiameseTrainer", ranks.Float64Trainer)
        objective = tune.make_objective(
            data, verbose=False, trial_epochs=len(trial["train_loss"]),
            device="cpu", datasets=datasets)
        value = objective(tune.SharedTrial(trial["number"],
                                           trial["params"]))
    return objective.trials[0], value


@pytest.fixture(scope="module")
def study(oscd_tree, tmp_path_factory):
    """The four ranks' reports and outputs, the study file read by both
    engines, and each trial run in one process."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    with dropped(tmp_path_factory.mktemp("tune_submesh")) as tmp:
        port = str(pm.free_port())
        argv = ["--root-dir", str(oscd_tree), "--device", "cpu",
                "--target-size", "32x32", "--tune", "--n-trials",
                str(N_TRIALS), "--parallel-trials", str(PARALLEL)]
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             "import torch_tune_ranks as r; r.cli_rank()", str(tmp), *argv],
            cwd=tmp, env=_rank_env(rank, port), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for rank in range(WORLD)]
        try:
            outs = [p.communicate(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for p, (_, err) in zip(procs, outs):
            assert p.returncode == 0, err[-3000:]
        reports = []
        for rank in range(WORLD):
            with open(tmp / f"rank{rank}.json") as f:
                reports.append(json.load(f))
        storage = f"sqlite:///{tmp / 'optuna_study.db'}"
        trials = {side: [(t.number, t.state.value, t.value, t.params,
                          t.intermediate_values)
                         for t in ms.load_study(tune.STUDY_NAME,
                                                storage).trials]
                  for side, ms in (("port", tms), ("jax", jms))}
        data = DataConfig(root_dir=str(oscd_tree), target_size=ranks.SIZE)
        datasets = ranks.float64_datasets(data, verbose=False)
        single = {t["number"]: _single(data, datasets, t)
                  for rank in LEADERS for t in reports[rank]["trials"]}
        yield {"reports": reports, "outs": [out for out, _ in outs],
               "trials": trials, "single": single}
    torch.set_num_threads(before)


def _close(got, want, what):
    assert len(got) == len(want), what
    for a, b in zip(got, want):
        assert abs(a - b) <= RTOL * abs(b), f"{what}: {a} vs {b}"


def test_each_submesh_trial_equals_the_trial_in_one_process(study):
    reports, single = study["reports"], study["single"]
    for leader in LEADERS:
        for got in reports[leader]["trials"]:
            want, value = single[got["number"]]
            assert got["params"] == want["params"]
            for k in ("train_loss", "val_loss"):
                _close(got[k], want[k], f"trial {got['number']} {k}")
            stored = {t[0]: t for t in study["trials"]["port"]}[
                got["number"]]
            if stored[1] == "COMPLETE":
                _close([stored[2]], [value], f"trial {got['number']} value")
            else:
                assert stored[2] == got["val_loss"][-1]
        # The partition's other rank ran the same trials, epochs and
        # losses: the same global values.
        assert reports[leader + 1]["trials"] == reports[leader]["trials"]
    assert [r["mesh"] for r in reports] == [[2, 0], [2, 1], [2, 0], [2, 1]]
    assert {r["returned"] for r in reports} == {"dict"}


def test_study_rows_unique_complete_and_read_by_jax(study):
    rows = study["trials"]["port"]
    assert rows == study["trials"]["jax"]
    assert [r[0] for r in rows] == list(range(N_TRIALS))
    assert {r[1] for r in rows} <= {"COMPLETE", "PRUNED"}
    recorded = {t["number"]: t for leader in LEADERS
                for t in study["reports"][leader]["trials"]}
    assert sorted(recorded) == list(range(N_TRIALS))
    for number, state, value, params, inter in rows:
        t = recorded[number]
        assert params == t["params"] and state == t["state"]
        assert inter == {e: v for e, v in enumerate(t["val_loss"], 1)}
    # Each partition's rank 0 prints its trials, global rank 0 the summary;
    # the other ranks print nothing.
    outs = study["outs"]
    assert "[w0] Trial" in outs[0] and "[w1] Trial" in outs[2]
    assert "--- Tuning Study Complete ---" in outs[0]
    assert "Number of finished trials: 4" in outs[0]
    assert outs[1] == outs[3] == ""


def test_a_forced_prune_stops_both_ranks_of_its_partition(study):
    first = [r["trials"][0] for r in study["reports"][2:]]
    for t in first:
        assert t["state"] == "PRUNED" and len(t["val_loss"]) == 1
    assert "pruned at epoch 1" in study["outs"][2]
    others = [t for r in study["reports"] for t in r["trials"]
              if t["number"] != first[0]["number"]]
    assert all(t["state"] == "COMPLETE"
               and len(t["val_loss"]) == ranks.TRIAL_EPOCHS for t in others)


def test_a_raised_error_on_one_rank_ends_the_run(oscd_tree, tmp_path):
    """The other ranks are stopped, and the run raises the failing rank's
    error, not the closed connection that its partner then meets."""
    with pytest.raises(RuntimeError, match=f"rank {ranks.FAIL_RANK} of "
                       f"{WORLD} failed first") as exc:
        pm.spawn(ranks.failing_rank,
                 (str(oscd_tree), f"sqlite:///{tmp_path / 'f.db'}"), WORLD,
                 "cpu")
    assert f"RuntimeError: rank {ranks.FAIL_RANK} failed" in str(exc.value)


def _jax_meshes(monkeypatch, n_devices, n_parallel, n_trials):
    """What the JAX package's ``run_tuning`` gives each worker on the first
    ``n_devices`` of the 8 virtual CPU devices: [(mesh device ids or None,
    trials)] by worker, with the study and the objective stubbed (the
    meshes are built; nothing compiles)."""
    import jax

    devices = jax.devices()[:n_devices]
    seen, lock = {}, threading.Lock()

    class Study:
        def optimize(self, objective, n_trials, n_jobs=1):
            name, mesh = objective
            ids = (None if mesh is None
                   else [d.id for d in mesh.devices.flat])
            with lock:
                seen[name] = (ids, n_trials)

    def make_objective(data_cfg, verbose=True, trial_epochs=1, mesh=None,
                       datasets=None, name="", native_aug=True):
        return name, mesh

    monkeypatch.setattr(jax, "devices", lambda: devices)
    monkeypatch.setattr(jtune, "create_study", lambda **kw: Study())
    monkeypatch.setattr(jtune, "make_objective", make_objective)
    monkeypatch.setattr(jtune, "load_tuning_datasets",
                        lambda *a, **k: (None, None))
    jtune.run_tuning(None, n_trials=n_trials, verbose=False,
                     n_parallel=n_parallel)
    return [seen[name] for name in sorted(seen)]


@pytest.mark.parametrize("n_trials", [3, 11])
def test_partition_rule_equals_the_jax_meshes(monkeypatch, n_trials):
    for n_devices in range(1, 9):
        for n_parallel in range(1, 9):
            with monkeypatch.context() as mp:
                want = _jax_meshes(mp, n_devices, n_parallel, n_trials)
            parts = tune.partition_devices(n_devices, n_parallel)
            shares = tune.trial_shares(n_trials, len(parts))
            got = [(p if len(p) > 1 else None, s)
                   for p, s in zip(parts, shares)]
            assert got == want, (n_devices, n_parallel)
            if n_parallel > 1:  # a worker of one device: devices 0, 1, ...
                assert all(p == [k] for k, p in enumerate(parts)
                           if len(p) == 1)


class _Threads(Exception):
    pass


def _no_threads(*args, **kwargs):
    raise _Threads()


def test_one_process_spawns_ranks_for_partitions_of_several_devices(
        oscd_tree, tmp_path, monkeypatch):
    spawned = []
    monkeypatch.setattr(tune, "_n_devices", lambda *a: 4)
    monkeypatch.setattr(tune, "spawn", lambda *a: spawned.append(a))
    monkeypatch.setattr(tune, "tuning_devices", _no_threads)
    data = DataConfig(root_dir=str(oscd_tree), target_size=ranks.SIZE)
    storage = f"sqlite:///{tmp_path / 's.db'}"
    for n_parallel in (2, 3):  # partitions of 2 cards: 4 ranks; of 1: none
        kw = dict(n_trials=3, storage=storage, verbose=False,
                  n_parallel=n_parallel, device="cpu")
        if n_parallel == 3:
            with pytest.raises(_Threads):
                tune.run_tuning(data, **kw)
            continue
        study = tune.run_tuning(data, **kw)
        assert study.trials == []
        with pytest.raises(_Threads):
            tune.run_tuning(data, **kw, data_parallel=False)
    (fn, (kwargs,), nprocs, device, timeout), = spawned
    assert (fn, nprocs, device, timeout) == (tune._tune_rank, 4, "cpu",
                                             tune.GROUP_TIMEOUT)
    assert kwargs["n_parallel"] == 2 and kwargs["n_trials"] == 3
    # Under torchrun's variables of several ranks, --no-data-parallel is
    # refused before any group is joined.
    for var, value in (("WORLD_SIZE", "4"), ("RANK", "0"),
                       ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(var, value)
    with pytest.raises(SystemExit) as exc:
        train_cli.main(["--root-dir", str(oscd_tree), "--device", "cpu",
                        "--tune", "--parallel-trials", "2",
                        "--no-data-parallel"])
    assert exc.value.code == 2


def test_concurrent_processes_take_distinct_trial_numbers(tmp_path):
    """The parent's ``ministudy`` read the number and inserted the row in
    two statements: with the pause between them, two processes took the
    same numbers."""
    path, n = str(tmp_path / "race.db"), 12
    tms.create_study(study_name="race", storage=f"sqlite:///{path}")
    ctx = multiprocessing.get_context("spawn")
    start = ctx.Event()
    procs = [ctx.Process(target=ranks.race_writer,
                         args=(path, "race", n, start)) for _ in range(2)]
    for p in procs:
        p.start()
    start.set()
    try:
        for p in procs:
            p.join(timeout=300)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    trials = tms.load_study("race", f"sqlite:///{path}").trials
    assert sorted(t.number for t in trials) == list(range(2 * n))
    assert all(t.state == tms.TrialState.COMPLETE and "x" in t.params
               for t in trials)
