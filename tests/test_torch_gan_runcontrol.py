"""Run control of the port's GAN training on the CPU, at 32x32 and
``num_downs`` 5: SIGTERM in epoch 2, in process, writes the epoch's
checkpoints and the resume pair at it and returns, and ``--resume``
continues; background writes equal synchronous ones; the NaN checks of
both optimizer steps; the step timer; the CLI flags; resuming from the
JAX package's train state (the committed pair of
tools/make_gan_resume_fixture.py) against the JAX pipeline resuming it;
and the run log's events and keys against the JAX pipeline's for the same
preempted run."""

import json
import os
import shutil
import signal

import numpy as np
import pytest
import torch

from gan_aug_pfa_torch import checkpoint as tck
from gan_aug_pfa_torch import interop as ti
from gan_aug_pfa_torch import pipelines as tp
from gan_aug_pfa_torch import train_gan as gan_cli
from gan_aug_pfa_torch.config import DataConfig, GANTrainConfig
from gan_aug_pfa_torch.models import UNetGenerator
from gan_aug_pfa_torch.train.gan import GANTrainer
from gan_aug_pfa_torch.utils.profiling import StepTimer, enable_nan_checks
from torch_tmp import drop_tmp_path  # noqa: F401

SIZE = (32, 32)
ARCH = dict(num_downs=5, ngf=8, ndf=8)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "jax_gan_state_nd5_ngf4")
FIXTURE_ARCH = dict(num_downs=5, ngf=4, ndf=8, n_layers=2)
RESUME_RTOL = 1e-3  # fp32 losses of a resumed epoch, port vs JAX


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs six test processes on the host's cores at once; two
    threads for this file's full-width CPU work keep them from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _cfg(tmp_path, **kw):
    kw.setdefault("compute_dtype", "float32")
    return GANTrainConfig(target_size=SIZE,
                          checkpoint_dir=str(tmp_path / "ckpt"),
                          output_dir=str(tmp_path / "samples"), **ARCH, **kw)


def _sigterm_in_epoch(monkeypatch, cls, n, replace=None):
    """Wrap ``cls.train_epoch`` (or ``replace`` it) to send SIGTERM to this
    process at the start of its ``n``-th call."""
    orig = replace or cls.train_epoch
    calls = []

    def wrapped(self, *a, **k):
        calls.append(1)
        if len(calls) == n:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(self, *a, **k)

    monkeypatch.setattr(cls, "train_epoch", wrapped)
    return calls


def test_gan_preempts_and_resumes(oscd_tree, tmp_path, monkeypatch, capsys):
    data = DataConfig(root_dir=str(oscd_tree), target_size=SIZE)
    log = str(tmp_path / "gan.jsonl")
    calls = _sigterm_in_epoch(monkeypatch, GANTrainer, 2)
    before = signal.getsignal(signal.SIGTERM)
    hist = tp.run_gan_training(
        data, _cfg(tmp_path, num_epochs=5, save_every=10, sample_every=99,
                   ema_decay=0.9, async_ckpt=True, log_jsonl=log),
        device="cpu")
    assert len(hist["loss_d"]) == 2 and len(calls) == 2
    assert signal.getsignal(signal.SIGTERM) == before
    out = capsys.readouterr().out
    assert "Preemption requested: GAN resume state saved at epoch 2" in out
    ckpt_dir = tmp_path / "ckpt"
    assert sorted(os.listdir(ckpt_dir)) == [
        "discriminator_epoch_2.pth", "generator_ema_epoch_2.pth",
        "generator_epoch_2.pth", "last_discriminator.pth",
        "last_generator.pth"]
    for name in ("last_generator.pth", "last_discriminator.pth"):
        assert torch.load(ckpt_dir / name, weights_only=True)["epoch"] == 2
    events = _read(log)
    (ck,) = [e for e in events if e["event"] == "checkpoint"]
    assert ck["kind"] == "gan_epoch" and ck["epoch"] == 2
    assert ck["ema"] == str(ckpt_dir / "generator_ema_epoch_2.pth")

    monkeypatch.undo()
    resumed = tp.run_gan_training(
        data, _cfg(tmp_path, num_epochs=3, save_every=10, sample_every=99,
                   ema_decay=0.9, resume=True, log_jsonl=log),
        verbose=True, device="cpu")
    assert len(resumed["loss_d"]) == 1
    assert "Resumed GAN from epoch 3." in capsys.readouterr().out
    events = _read(log)
    assert [e["start_epoch"] for e in events
            if e["event"] == "run_start"] == [1, 3]
    assert [e["epoch"] for e in events if e["event"] == "epoch"] == [1, 2, 3]
    assert [e["event"] for e in events][-3:] == ["sample", "checkpoint",
                                                 "run_end"]
    assert events[0]["kind"] == "gan_train" and events[0]["n_train"] == 5
    assert "n_val" not in events[0]
    assert torch.load(ckpt_dir / "last_generator.pth",
                      weights_only=True)["epoch"] == 3


def _files(ckpt_dir):
    out = {}
    for name in sorted(os.listdir(ckpt_dir)):
        state = torch.load(os.path.join(ckpt_dir, name), weights_only=True)
        flat = {}

        def walk(prefix, v):
            if isinstance(v, dict):
                for k, x in v.items():
                    walk(f"{prefix}/{k}", x)
            elif isinstance(v, (list, tuple)):
                for i, x in enumerate(v):
                    walk(f"{prefix}/{i}", x)
            else:
                flat[prefix] = v

        walk(name, state)
        out.update(flat)
    return out


def test_gan_async_writes_equal_sync(oscd_tree, tmp_path):
    """Two seeded epochs with an EMA, writing every epoch: the same files,
    tensors equal exactly, with and without the background writer."""
    data = DataConfig(root_dir=str(oscd_tree), target_size=SIZE)
    got = []
    for background in (False, True):
        run_dir = tmp_path / str(background)
        tp.run_gan_training(
            data, _cfg(run_dir, num_epochs=2, save_every=1, sample_every=99,
                       ema_decay=0.9, async_ckpt=background),
            verbose=False, device="cpu")
        got.append(_files(run_dir / "ckpt"))
    sync, background = got
    assert sorted(sync) == sorted(background)
    assert len({k.split("/")[0] for k in sync}) == 8
    for k, v in sync.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(background[k], v), k
        else:
            assert background[k] == v, k


@pytest.mark.parametrize("which", ["discriminator", "generator"])
def test_debug_nans_names_the_step(which):
    """A NaN weight in D fails the D step, one in G (whose output D reads)
    fails it too, naming the epoch, step 1 and the optimizer step; the
    weights are not stepped."""
    trainer = GANTrainer(GANTrainConfig(compute_dtype="float32", **ARCH),
                         "cpu")
    enable_nan_checks(trainer)
    model = getattr(trainer, which)
    with torch.no_grad():
        next(model.parameters()).view(-1)[0] = float("nan")
    rng = np.random.RandomState(0)
    cache = tp.DeviceCache(
        torch.from_numpy(rng.rand(2, 3, *SIZE).astype(np.float32)),
        torch.from_numpy(rng.rand(2, 3, *SIZE).astype(np.float32)),
        torch.zeros(2, *SIZE))
    last = trainer.discriminator.model[-1].weight.detach().clone()
    with pytest.raises(FloatingPointError,
                       match=r"in epoch 4, step 1 \(D step\): \['loss'"):
        trainer.train_epoch(cache, np.random.RandomState(0), epoch=4)
    assert torch.equal(trainer.discriminator.model[-1].weight, last)


def test_step_timer_times_gan_steps():
    trainer = GANTrainer(GANTrainConfig(compute_dtype="float32", **ARCH),
                         "cpu")
    trainer.step_timer = StepTimer(skip_first=1)
    rng = np.random.RandomState(0)
    cache = tp.DeviceCache(
        torch.from_numpy(rng.rand(3, 3, *SIZE).astype(np.float32)),
        torch.from_numpy(rng.rand(3, 3, *SIZE).astype(np.float32)),
        torch.zeros(3, *SIZE))
    loss_d, loss_g = trainer.train_epoch(cache, np.random.RandomState(0))
    assert np.isfinite([loss_d, loss_g]).all()
    assert trainer.step_timer.summary()["steps"] == 2


@pytest.mark.parametrize("flags", [
    ["--async-ckpt"], ["--debug-nans"], ["--profile-dir", "prof"],
    ["--log-jsonl", "run.jsonl"]])
def test_cli_accepts_run_control_flags(flags, tmp_path, capsys):
    """Ported: on an empty root the run parses and finds no sample."""
    assert gan_cli.main(["--root-dir", str(tmp_path), "--device", "cpu",
                         *flags]) is None
    out = capsys.readouterr()
    assert "not ported yet" not in out.err
    assert "GAN Training dataset is empty" in out.out


@pytest.fixture(scope="module")
def jax_resumed(oscd_tree, tmp_path_factory):
    """The JAX pipeline resuming the committed JAX pair (epoch 1, an EMA of
    decay 0.9) for epoch 2 at float32: its losses and its epoch-2 EMA."""
    from gan_aug_pfa_tpu import config as jcfg
    from gan_aug_pfa_tpu import pipelines as jp

    d = tmp_path_factory.mktemp("jax_gan_resume")
    shutil.copytree(FIXTURE, d / "ckpt")
    hist = jp.run_gan_training(
        jcfg.DataConfig(root_dir=str(oscd_tree)),
        jcfg.GANTrainConfig(
            data_parallel=False, checkpoint_dir=str(d / "ckpt"),
            output_dir=str(d / "samples"), num_epochs=2, target_size=SIZE,
            compute_dtype="float32", ema_decay=0.9, save_every=1,
            sample_every=100, resume=True, **FIXTURE_ARCH),
        verbose=False)
    ema = tck.restore_model_only(
        str(d / "ckpt" / "generator_ema_epoch_2.msgpack"),
        UNetGenerator(num_downs=5, ngf=4)).state_dict()
    shutil.rmtree(d)
    return {"loss_d": hist["loss_d"], "loss_g": hist["loss_g"], "ema": ema}


@pytest.mark.parametrize("stem", ["last_generator", "last_discriminator"])
def test_cli_resume_from_jax_train_state_exits_2(stem, oscd_tree, tmp_path,
                                                 capsys, jax_resumed):
    """The committed JAX-written resume pair: with ``stem`` cut in half the
    CLI exits 2 naming the file; whole, it continues at epoch 2 with the
    JAX pipeline's losses (within 1e-3 relative at float32) and an EMA
    carried on from the file's ``ema_params``."""
    ckpt = tmp_path / "ckpt"
    shutil.copytree(FIXTURE, ckpt)
    full = (ckpt / f"{stem}.msgpack").read_bytes()
    (ckpt / f"{stem}.msgpack").write_bytes(full[:len(full) // 2])
    argv = ["--root-dir", str(oscd_tree), "--device", "cpu", "--resume",
            "--num-epochs", "2", "--target-size", "32x32",
            "--compute-dtype", "float32", "--ema-decay", "0.9",
            "--save-every", "1", "--sample-every", "100",
            "--checkpoint-dir", str(ckpt),
            "--output-dir", str(tmp_path / "samples"),
            "--num-downs", "5", "--ngf", "4", "--ndf", "8", "--n-layers",
            "2"]
    with pytest.raises(SystemExit) as exc:
        gan_cli.main(argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"{stem}.msgpack: cannot read it to resume" in err
    assert "truncated" in err
    (ckpt / f"{stem}.msgpack").write_bytes(full)
    got = gan_cli.main(argv)
    assert "Resumed GAN from epoch 2." in capsys.readouterr().out
    for key in ("loss_d", "loss_g"):
        assert len(got[key]) == len(jax_resumed[key]) == 1
        assert got[key][0] == pytest.approx(jax_resumed[key][0],
                                            rel=RESUME_RTOL)
    assert {"generator_epoch_2.pth", "discriminator_epoch_2.pth",
            "generator_ema_epoch_2.pth"} <= set(os.listdir(ckpt))
    # The EMA went on from the JAX ema_params, not from the weights: its
    # gap to JAX's is a small part of how far it moved in the epoch.
    ema = torch.load(ckpt / "generator_ema_epoch_2.pth", weights_only=True)
    first = ti.variables_from_msgpack(str(ckpt / "last_generator.msgpack"))
    start = ti.generator_state_dict_from_jax(
        {"params": first["ema_params"], "batch_stats": first["batch_stats"]})
    for key in dict(UNetGenerator(num_downs=5, ngf=4).named_parameters()):
        want = jax_resumed["ema"][key]
        moved = float((want - start[key]).abs().max())
        assert float((ema[key] - want).abs().max()) <= max(
            1e-2 * moved, 1e-7), key


def test_run_log_events_match_jax(oscd_tree, tmp_path, monkeypatch):
    """The same 4-epoch run (save_every 2, sample_every 2, an EMA, SIGTERM
    in epoch 3) through the JAX pipeline (its epoch stubbed, as
    tests/test_signals.py does: the events do not depend on the losses)
    and the port's: the same events with the same keys in the same
    order."""
    from gan_aug_pfa_tpu import config as jcfg
    from gan_aug_pfa_tpu import pipelines as jp
    from gan_aug_pfa_tpu.train import GANTrainer as JaxTrainer

    logs = {side: str(tmp_path / f"{side}.jsonl")
            for side in ("jax", "port")}
    common = dict(num_epochs=4, save_every=2, sample_every=2, ema_decay=0.9,
                  compute_dtype="float32", target_size=SIZE, **ARCH)
    _sigterm_in_epoch(monkeypatch, JaxTrainer, 3,
                      replace=lambda self, sg, sd, *a: (sg, sd, 0.5, 40.0))
    jp.run_gan_training(
        jcfg.DataConfig(root_dir=str(oscd_tree)),
        jcfg.GANTrainConfig(data_parallel=False, log_jsonl=logs["jax"],
                            checkpoint_dir=str(tmp_path / "jax_ckpt"),
                            output_dir=str(tmp_path / "jax_samples"),
                            **common),
        verbose=False)
    monkeypatch.undo()
    _sigterm_in_epoch(monkeypatch, GANTrainer, 3)
    tp.run_gan_training(
        DataConfig(root_dir=str(oscd_tree)),
        GANTrainConfig(log_jsonl=logs["port"],
                       checkpoint_dir=str(tmp_path / "port_ckpt"),
                       output_dir=str(tmp_path / "port_samples"), **common),
        verbose=False, device="cpu")

    def events_and_keys(path):
        return [(e["event"], sorted(k for k in e
                                    if k not in ("ts", "wall_s", "event")))
                for e in _read(path)]

    want = events_and_keys(logs["jax"])
    assert [e for e, _ in want] == [
        "run_start", "epoch", "epoch", "sample", "checkpoint", "epoch",
        "checkpoint", "preemption", "run_end"]
    assert ("checkpoint", ["discriminator", "ema", "epoch", "generator",
                           "kind"]) in want
    assert events_and_keys(logs["port"]) == want
