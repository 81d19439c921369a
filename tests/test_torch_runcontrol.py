"""The port's run control on the CPU: the SIGTERM guard, the JSONL run log
and the step timer, trace and finite checks case for case with the JAX
package's tests (tests/test_signals.py, test_runlog.py,
test_profiling.py); Siamese training preempted in epoch 2 and resumed, in
process; the deferred best model and background writes against the
immediate, synchronous ones (the same files, tensors equal exactly); the
NaN check; and the run log's events and keys against the JAX pipeline's
for the same preempted 4-epoch run."""

import importlib.util
import json
import os
import pathlib
import shutil
import signal
import threading
import time

import numpy as np
import pytest
import torch

from gan_aug_pfa_torch import pipelines as tp
from gan_aug_pfa_torch.config import DataConfig, SiameseTrainConfig
from gan_aug_pfa_torch.train import __main__ as train_cli
from gan_aug_pfa_torch.train.siamese import SiameseTrainer
from gan_aug_pfa_torch.utils.profiling import (
    StepTimer,
    annotate,
    enable_nan_checks,
    nan_guard,
    step_guard,
    trace,
)
from gan_aug_pfa_torch.utils.runlog import JsonlRunLog, open_run_log
from gan_aug_pfa_torch.utils.signals import GracefulShutdown
from torch_tmp import drop_tmp_path  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
SIZE = (32, 32)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs six test processes on the host's cores at once; two
    threads for this file's full-width CPU work keep them from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """A full-width run writes about 1 GB of checkpoints: free them when
    the test ends, not when pytest prunes its old temporary trees."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _summarize_module():
    spec = importlib.util.spec_from_file_location(
        "summarize_runlog", REPO / "scripts" / "summarize_runlog.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- utils/signals.py (tests/test_signals.py:15-50) --------------------------


def test_guard_latches_first_signal():
    with GracefulShutdown(signals=(signal.SIGTERM,)) as stop:
        assert not stop.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert stop.requested
        assert stop.signum == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) != stop._handle


def test_second_signal_falls_through_to_previous_handler():
    hits = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: hits.append(s))
    try:
        with GracefulShutdown(signals=(signal.SIGTERM,)) as stop:
            os.kill(os.getpid(), signal.SIGTERM)
            assert stop.requested and not hits
            os.kill(os.getpid(), signal.SIGTERM)
            assert hits == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_guard_is_inert_off_main_thread():
    results = {}

    def run():
        with GracefulShutdown() as stop:
            results["installed"] = bool(stop._previous)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert results["installed"] is False


# -- utils/runlog.py (tests/test_runlog.py:19-82) ----------------------------


def test_events_one_json_object_per_line(tmp_path):
    path = str(tmp_path / "run.jsonl")
    with JsonlRunLog(path) as log:
        log.log("run_start", kind="test", config={"lr": 1e-3, "bs": 4})
        log.log("epoch", epoch=1, train_loss=0.5)
    events = _read(path)
    assert [e["event"] for e in events] == ["run_start", "epoch"]
    assert events[0]["config"] == {"lr": 1e-3, "bs": 4}
    assert events[1]["epoch"] == 1
    assert all(e["ts"] > 0 for e in events)


def test_numpy_scalars_and_tensors_coerced(tmp_path):
    path = str(tmp_path / "run.jsonl")
    with JsonlRunLog(path) as log:
        log.log("epoch", f32=np.float32(0.25), i64=np.int64(7),
                arr=np.arange(3), t0=torch.tensor(1.5),
                t1=torch.arange(3), t2=torch.ones(2, 2, dtype=torch.int32),
                other=object.__new__(type("Opaque", (), {
                    "__str__": lambda self: "opaque"})))
    (e,) = _read(path)
    assert e["f32"] == 0.25 and e["i64"] == 7 and e["arr"] == [0, 1, 2]
    assert e["t0"] == 1.5 and e["t1"] == [0, 1, 2]
    assert e["t2"] == [[1, 1], [1, 1]] and e["other"] == "opaque"


def test_append_mode_preserves_previous_run(tmp_path):
    path = str(tmp_path / "run.jsonl")
    with JsonlRunLog(path) as log:
        log.log("run_start")
    with JsonlRunLog(path, append=True) as log:
        log.log("run_start", resumed=True)
    events = _read(path)
    assert len(events) == 2 and events[1]["resumed"] is True
    with JsonlRunLog(path) as log:
        log.log("run_start", fresh=True)
    events = _read(path)
    assert len(events) == 1 and events[0]["fresh"] is True


def test_flushed_per_event_and_creates_parent_dirs(tmp_path):
    path = str(tmp_path / "nested" / "dir" / "run.jsonl")
    log = JsonlRunLog(path)
    log.log("epoch", epoch=1)
    assert _read(path)[0]["epoch"] == 1  # readable before close
    log.close()
    log.close()  # idempotent


def test_open_run_log_disabled_when_path_none(tmp_path):
    assert open_run_log(None) is None
    log = open_run_log(str(tmp_path / "x.jsonl"))
    assert isinstance(log, JsonlRunLog)
    log.close()
    assert os.path.exists(tmp_path / "x.jsonl")


def test_summarize_runlog_script(tmp_path):
    """scripts/summarize_runlog.py, unchanged, renders both log kinds as
    the port writes them and survives a truncated last line."""
    mod = _summarize_module()
    path = str(tmp_path / "run.jsonl")
    with JsonlRunLog(path) as log:
        log.log("run_start", kind="siamese_train", start_epoch=1)
        log.log("epoch", epoch=1, train_loss=torch.tensor(0.9),
                val_loss=0.8, lr=1e-4, wall_s=2.0)
        log.log("epoch", epoch=2, train_loss=0.7, val_loss=0.6,
                lr=1e-4, wall_s=1.5)
        log.log("checkpoint", kind="best_model", path="/ck/best_model.pth",
                epoch=2, val_loss=0.6)
        log.log("run_end", best_val_loss=0.6)
    with open(path, "a") as f:
        f.write('{"ts": 1, "event": "epo')
    text = mod.summarize(mod.load_events(path))
    assert "siamese_train" in text
    assert "best val loss: 0.6000 (epoch 2)" in text
    assert "best_model.pth" in text

    path2 = str(tmp_path / "gan.jsonl")
    with JsonlRunLog(path2) as log:
        log.log("run_start", kind="gan_train", start_epoch=1)
        log.log("epoch", epoch=1, loss_d=0.5, loss_g=40.0, wall_s=1.0)
        log.log("preemption", epoch=1)
    text2 = mod.summarize(mod.load_events(path2))
    assert "gan_train" in text2 and "loss_g 40.0000" in text2
    assert "preempted at epoch 1" in text2 and "no run_end" in text2


# -- utils/profiling.py (tests/test_profiling.py:14-62) ----------------------


def test_step_timer_stats():
    timer = StepTimer(items_per_step=4, skip_first=1)
    for _ in range(6):
        with timer.step():
            time.sleep(0.002)
    s = timer.summary()
    assert s["steps"] == 5
    assert s["mean_s"] >= 0.002
    assert s["p95_s"] >= s["p50_s"] > 0
    assert s["items_per_s"] == pytest.approx(4 / s["mean_s"])
    assert set(s) == {"steps", "mean_s", "p50_s", "p95_s", "total_s",
                      "items_per_s", "compile_s"}
    text = timer.format_summary("Step timing: ")
    assert text.startswith("Step timing: 5 steps: mean ")
    assert "items/s (first-step compile " in text


def test_step_timer_empty():
    s = StepTimer().summary()
    assert s["steps"] == 0 and np.isnan(s["mean_s"])


def test_trace_noop_when_disabled(tmp_path):
    with trace(None):
        x = torch.ones(4) * 2
    assert float(x.sum()) == 8.0
    with trace(""):
        pass
    assert os.listdir(tmp_path) == []


def test_trace_writes_profile(tmp_path):
    d = str(tmp_path / "prof")
    with trace(d):
        with annotate("my_phase"):
            torch.ones(64, 64).sum()
    (name,) = os.listdir(d)
    assert name.endswith(".pt.trace.json")
    with open(os.path.join(d, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "my_phase" for e in events)


def test_nan_guard_passes_on_finite():
    nan_guard({"a": torch.ones(3), "b": {"c": torch.zeros(2, 2)}})


def test_nan_guard_raises_on_nan():
    bad = {"w": torch.tensor([1.0, float("nan")]), "ok": torch.ones(2),
           "v": torch.tensor([float("inf")])}
    with pytest.raises(FloatingPointError,
                       match=r"non-finite values in test: \['w', 'v'\]"):
        nan_guard(bad, where="test")


def test_nan_guard_ignores_int_leaves():
    nan_guard({"idx": torch.arange(5), "x": torch.ones(2), "n": 3})


def test_step_guard_names_loss_and_first_bad_gradients():
    model = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.Linear(2, 1))
    model(torch.ones(1, 2)).sum().backward()
    step_guard(torch.tensor(1.0), model, "epoch 1, step 1")
    model[1].weight.grad[0, 0] = float("nan")
    with pytest.raises(FloatingPointError,
                       match=r"in epoch 3, step 2: \['grad 1.weight'\]"):
        step_guard(torch.tensor(1.0), model, "epoch 3, step 2")
    with pytest.raises(FloatingPointError, match=r"\['loss', 'grad 1"):
        step_guard(torch.tensor(float("nan")), model, "x")


# -- checkpoint.AsyncCheckpointWriter ---------------------------------------


def test_async_writer_snapshots_before_training_moves_on(tmp_path):
    """What a background save writes is the payload as it was at the save:
    tensors changed in place and dicts changed afterwards do not reach the
    file.  Many saves in a row, with a short switch interval so that the
    worker thread and this one interleave often."""
    import sys

    from gan_aug_pfa_torch import checkpoint as tck

    writer = tck.AsyncCheckpointWriter()
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        w = torch.zeros(256, 256)
        sched = {"best": 1.0, "num_bad_epochs": 0}
        for i in range(20):
            w.fill_(i)
            sched["num_bad_epochs"] = i
            writer.save(str(tmp_path / f"s{i}.pth"),
                        {"w": w, "sched": sched, "list": [w, (i, w)]})
            w.fill_(-1.0)  # training moves on before the write is done
            sched["num_bad_epochs"] = -1
        writer.wait()
    finally:
        sys.setswitchinterval(prev)
        writer.close()
    for i in range(20):
        got = torch.load(tmp_path / f"s{i}.pth", weights_only=True)
        assert torch.equal(got["w"], torch.full((256, 256), float(i)))
        assert got["sched"]["num_bad_epochs"] == i
        assert got["list"][1][0] == i
        assert torch.equal(got["list"][1][1], got["w"])
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_async_writer_raises_a_write_error_on_the_next_call(tmp_path):
    from gan_aug_pfa_torch import checkpoint as tck

    blocker = tmp_path / "file"
    blocker.write_text("")
    writer = tck.AsyncCheckpointWriter()
    try:
        writer.wait()  # nothing in flight
        writer.save(str(blocker / "x.pth"), {"a": torch.ones(2)})
        with pytest.raises(OSError):
            writer.save(str(tmp_path / "ok.pth"), {"a": torch.ones(2)})
        writer.save(str(tmp_path / "ok.pth"), {"a": torch.ones(2)})
        writer.save(str(blocker / "y.pth"), {"a": torch.ones(2)})
        with pytest.raises(OSError):
            writer.wait()
        writer.wait()  # the error was raised once
    finally:
        writer.close()
    assert torch.equal(torch.load(tmp_path / "ok.pth")["a"], torch.ones(2))


# -- the NaN check and the step timer in the trainer -------------------------


def _cache(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return tp.DeviceCache(
        torch.from_numpy(rng.rand(n, 3, *SIZE).astype(np.float32)),
        torch.from_numpy(rng.rand(n, 3, *SIZE).astype(np.float32)),
        torch.from_numpy((rng.rand(n, *SIZE) > 0.7).astype(np.float32)))


@pytest.mark.parametrize("checks", [True, False])
def test_debug_nans_raises_naming_epoch_and_step(checks):
    """A NaN conv weight: with the check the step raises before the
    optimizer step, naming the epoch, step 1, the loss and the first
    non-finite gradient; without it the epoch runs on to a NaN loss."""
    trainer = SiameseTrainer(SiameseTrainConfig(batch_size=2,
                                                compute_dtype="float32"),
                             "cpu")
    if checks:
        enable_nan_checks(trainer)
    with torch.no_grad():
        trainer.model.dconv_down1[0].weight[0, 0, 0, 0] = float("nan")
    before = trainer.model.conv_last.weight.detach().clone()
    if checks:
        with pytest.raises(FloatingPointError) as exc:
            trainer.train_epoch(_cache(), np.random.RandomState(0), epoch=7)
        msg = str(exc.value)
        assert "in epoch 7, step 1:" in msg
        assert "['loss', 'grad dconv_down1.0.weight'" in msg
        assert torch.equal(trainer.model.conv_last.weight, before)
    else:
        assert np.isnan(trainer.train_epoch(_cache(),
                                            np.random.RandomState(0)))


def test_step_timer_times_every_step_and_keeps_the_losses():
    """With a step timer the epoch's loss is the one without it, and every
    step is timed (3 samples at batch 2: 2 steps, both warm-up)."""
    losses = []
    for timed in (False, True):
        trainer = SiameseTrainer(SiameseTrainConfig(
            batch_size=2, compute_dtype="float32"), "cpu")
        if timed:
            trainer.step_timer = StepTimer(items_per_step=2, skip_first=1)
        losses.append(trainer.train_epoch(_cache(), np.random.RandomState(0)))
    assert losses[0] == losses[1]
    timer = trainer.step_timer
    assert len(timer.warmup_times) == 1 and timer.summary()["steps"] == 1


# -- the Siamese pipeline under run control ----------------------------------


def _sigterm_in_epoch(monkeypatch, cls, n, replace=None):
    """Wrap ``cls.train_epoch`` (or ``replace`` it) to send SIGTERM to this
    process at the start of its ``n``-th call (tests/test_signals.py:
    52-95)."""
    orig = replace or cls.train_epoch
    calls = []

    def wrapped(self, *a, **k):
        calls.append(1)
        if len(calls) == n:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(self, *a, **k)

    monkeypatch.setattr(cls, "train_epoch", wrapped)
    return calls


def _port_cfg(ckpt_dir, **kw):
    kw.setdefault("compute_dtype", "float32")
    return SiameseTrainConfig(batch_size=2, checkpoint_dir=str(ckpt_dir),
                              **kw)


def test_siamese_preempts_and_resumes(oscd_tree, tmp_path, monkeypatch,
                                      capsys):
    """SIGTERM in epoch 2 of 50: the epoch finishes, last_state.pth holds
    epoch 2, the run returns with the guard gone; --resume runs only the
    remaining epoch, appending a second run_start to the log, which
    scripts/summarize_runlog.py reads."""
    data = DataConfig(root_dir=str(oscd_tree), target_size=SIZE)
    ckpt_dir = tmp_path / "ckpt"
    log = str(tmp_path / "run.jsonl")
    calls = _sigterm_in_epoch(monkeypatch, SiameseTrainer, 2)
    before = signal.getsignal(signal.SIGTERM)
    hist = tp.run_siamese_training(
        data, _port_cfg(ckpt_dir, num_epochs=50, save_every=10,
                        log_jsonl=log), verbose=True, device="cpu")
    assert len(hist["train_loss"]) == 2 and len(calls) == 2
    assert signal.getsignal(signal.SIGTERM) == before
    out = capsys.readouterr().out
    assert "Preemption requested: resume state saved at epoch 2" in out
    state = torch.load(ckpt_dir / "last_state.pth", weights_only=True)
    assert state["epoch"] == 2
    assert sorted(os.listdir(ckpt_dir)) == ["best_model.pth",
                                            "last_state.pth"]

    monkeypatch.undo()
    resumed = tp.run_siamese_training(
        data, _port_cfg(ckpt_dir, num_epochs=3, save_every=10, resume=True,
                        log_jsonl=log), verbose=False, device="cpu")
    assert len(resumed["train_loss"]) == 1
    assert np.isfinite(resumed["train_loss"][0])
    events = _read(log)
    starts = [e for e in events if e["event"] == "run_start"]
    assert [s["start_epoch"] for s in starts] == [1, 3]
    assert [e["epoch"] for e in events if e["event"] == "epoch"] == [1, 2, 3]
    assert [e["event"] for e in events].count("preemption") == 1
    assert events[-1]["event"] == "run_end"
    assert starts[0]["kind"] == "siamese_train"
    assert starts[0]["n_train"] == 4 and starts[0]["n_val"] == 1
    assert starts[0]["config"]["log_jsonl"] == log
    assert starts[0]["data"]["target_size"] == list(SIZE)
    mod = _summarize_module()
    text = mod.summarize(mod.load_events(log))
    assert "resumed 1x" in text and "preempted at epoch 2" in text
    assert "epochs: 1..3 (3 logged" in text


def _ckpt_tensors(ckpt_dir):
    """Every tensor of every file in ``ckpt_dir``, by file and key path."""
    out = {}

    def walk(prefix, v):
        if isinstance(v, torch.Tensor):
            out[prefix] = v
        elif isinstance(v, dict):
            for k, x in v.items():
                walk(f"{prefix}/{k}", x)
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(f"{prefix}/{i}", x)
        else:
            out[prefix] = v

    for name in sorted(os.listdir(ckpt_dir)):
        walk(name, torch.load(os.path.join(ckpt_dir, name),
                              weights_only=True))
    return out


@pytest.fixture(scope="module")
def immediate_sync_run(oscd_tree, tmp_path_factory):
    ckpt_dir = tmp_path_factory.mktemp("immediate_sync")
    data = DataConfig(root_dir=str(oscd_tree), target_size=SIZE)
    tp.run_siamese_training(data, _port_cfg(ckpt_dir, num_epochs=3,
                                            save_every=2),
                            verbose=False, device="cpu")
    tensors = _ckpt_tensors(ckpt_dir)
    shutil.rmtree(ckpt_dir)
    return data, tensors


@pytest.mark.parametrize("defer,background", [(True, False), (False, True)])
def test_deferred_and_async_writes_equal_immediate_sync(
        immediate_sync_run, tmp_path, defer, background):
    """The same seeded 3-epoch run writes the same files with equal
    tensors (and equal other leaves: epochs, schedules, the best loss)
    whether the best model is deferred and whether writes run on the
    background thread."""
    data, want = immediate_sync_run
    ckpt_dir = tmp_path / "ckpt"
    tp.run_siamese_training(
        data, _port_cfg(ckpt_dir, num_epochs=3, save_every=2,
                        defer_best_ckpt=defer, async_ckpt=background),
        verbose=False, device="cpu")
    got = _ckpt_tensors(ckpt_dir)
    assert sorted(got) == sorted(want)
    assert {k.split("/")[0] for k in got} == {
        "best_model.pth", "last_state.pth", "model_epoch_2.pth"}
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        else:
            assert got[k] == v, k


# -- the CLI -------------------------------------------------------------------


@pytest.mark.parametrize("flags", [
    ["--defer-best-ckpt"], ["--async-ckpt"], ["--debug-nans"],
    ["--profile-dir", "prof"], ["--log-jsonl", "run.jsonl"]])
def test_cli_accepts_run_control_flags(flags, tmp_path, capsys):
    """Ported: on an empty root the run parses, finds no train split and
    returns None."""
    assert train_cli.main(["--root-dir", str(tmp_path), "--device", "cpu",
                           *flags]) is None
    out = capsys.readouterr()
    assert "not ported yet" not in out.err
    assert "Training dataset is empty" in out.out


def test_cli_resume_from_jax_train_state_exits_2(oscd_tree, tmp_path,
                                                 capsys):
    """A JAX-written ``last_state.msgpack`` (the JAX trainer's init state
    at epoch 2, saved by the JAX package): cut in half, ``--resume`` exits
    2 naming the file; whole, the run continues at epoch 3 from its
    weights."""
    import jax

    from gan_aug_pfa_tpu import checkpoint as jck
    from gan_aug_pfa_tpu import config as jcfg
    from gan_aug_pfa_tpu.train.siamese import SiameseTrainer as JaxTrainer

    ckpt_dir = tmp_path / "siamese_checkpoints"
    path = ckpt_dir / "last_state.msgpack"
    trainer = JaxTrainer(jcfg.SiameseTrainConfig(data_parallel=False,
                                                 compute_dtype="float32"))
    state = jax.jit(lambda k: trainer.init_state(k, SIZE))(
        jax.random.PRNGKey(5))
    jck.save_checkpoint(str(path), state, extra={
        "epoch": 2, "best_val_loss": 0.75,
        "scheduler": {"lr": 1e-4, "best": 0.75, "num_bad_epochs": 1,
                      "cooldown_counter": 0}})
    full = path.read_bytes()
    path.write_bytes(full[:len(full) // 2])
    argv = ["--root-dir", str(oscd_tree), "--device", "cpu", "--resume",
            "--target-size", "32x32", "--batch-size", "2", "--num-epochs",
            "3", "--compute-dtype", "float32", "--checkpoint-dir",
            str(ckpt_dir)]
    with pytest.raises(SystemExit) as exc:
        train_cli.main(argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "last_state.msgpack: cannot read it to resume" in err
    assert "truncated" in err
    path.write_bytes(full)
    del full
    hist = train_cli.main(argv)
    out = capsys.readouterr().out
    assert f"Resumed from {path} at epoch 3." in out
    assert "Epoch 3/3 - LR: 1.0e-04" in out and "Epoch 2/3" not in out
    assert len(hist["train_loss"]) == 1
    assert np.isfinite(hist["train_loss"] + hist["val_loss"]).all()
    assert hist["best_val_loss"] == min(0.75, hist["val_loss"][0])
    resumed = torch.load(ckpt_dir / "last_state.pth", weights_only=True)
    assert resumed["epoch"] == 3
    assert resumed["scheduler"]["last_epoch"] == 3
    # 4 train pairs at batch 2 from JAX's count 0: step 2.
    assert all(float(s["step"]) == 2
               for s in resumed["optimizer"]["state"].values())


# -- the run log against the JAX pipeline's ------------------------------------


def _events_and_keys(path):
    """(event, sorted keys) per line, without ``ts``, ``wall_s`` and the
    values."""
    return [(e["event"], sorted(k for k in e if k not in ("ts", "wall_s",
                                                          "event")))
            for e in _read(path)]


def test_run_log_events_match_jax(oscd_tree, tmp_path, monkeypatch):
    """The same 4-epoch run (save_every 2, deferred best model, SIGTERM in
    epoch 3) through the JAX pipeline and the port's: the same events
    with the same keys in the same order.  Both sides' epochs are stubbed
    (as tests/test_signals.py does: the events do not depend on training)
    and their validation returns the same scripted losses (improve,
    worsen, improve)."""
    from gan_aug_pfa_tpu import config as jcfg
    from gan_aug_pfa_tpu import pipelines as jp
    from gan_aug_pfa_tpu.train import SiameseTrainer as JaxTrainer

    val = [0.5, 0.6, 0.4]
    logs = {}
    for side, trainer_cls in (("jax", JaxTrainer), ("port", SiameseTrainer)):
        seen = []

        def scripted(self, *a, **k):
            seen.append(1)
            return val[len(seen) - 1]

        monkeypatch.setattr(trainer_cls, "validate", scripted)
        _sigterm_in_epoch(
            monkeypatch, trainer_cls, 3,
            replace=(lambda self, state, *a: (state, 0.5)) if side == "jax"
            else (lambda self, *a, **k: 0.5))
        logs[side] = str(tmp_path / f"{side}.jsonl")
        common = dict(batch_size=2, num_epochs=4, save_every=2,
                      defer_best_ckpt=True, compute_dtype="float32",
                      checkpoint_dir=str(tmp_path / side),
                      log_jsonl=logs[side])
        if side == "jax":
            hist = jp.run_siamese_training(
                jcfg.DataConfig(root_dir=str(oscd_tree), target_size=SIZE),
                jcfg.SiameseTrainConfig(data_parallel=False, **common),
                verbose=False)
        else:
            hist = tp.run_siamese_training(
                DataConfig(root_dir=str(oscd_tree), target_size=SIZE),
                SiameseTrainConfig(**common), verbose=False, device="cpu")
        assert hist["val_loss"] == val
        monkeypatch.undo()
    want = _events_and_keys(logs["jax"])
    assert [e for e, _ in want] == [
        "run_start", "epoch", "best_snapshot", "epoch", "checkpoint",
        "checkpoint", "checkpoint", "epoch", "best_snapshot", "checkpoint",
        "checkpoint", "preemption", "run_end"]
    assert _events_and_keys(logs["port"]) == want
