"""The streaming data path of the port (``gan_aug_pfa_torch/data/
stream.py``, ``--stream host|decode``) against its resident path and the
JAX package's streaming path, on the CPU at 32x32: the sources' batches,
the prefetcher's order and bound, the trainers' streamed epochs, and the
four CLIs (the cases of JAX tests/test_stream.py and more)."""

import copy
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from gan_aug_pfa_torch import checkpoint as tck
from gan_aug_pfa_torch import evaluate as eval_cli
from gan_aug_pfa_torch import generate_synthetic as synth_cli
from gan_aug_pfa_torch import interop as ti
from gan_aug_pfa_torch import pipelines as tp
from gan_aug_pfa_torch import train_gan as gan_cli
from gan_aug_pfa_torch.config import (
    DataConfig,
    EvalConfig,
    GANTrainConfig,
    GenerateConfig,
    SiameseTrainConfig,
)
from gan_aug_pfa_torch.data import png
from gan_aug_pfa_torch.data.loader import build_cached_dataset
from gan_aug_pfa_torch.data.scanner import create_sample_lists
from gan_aug_pfa_torch.data.stream import (
    BatchPut,
    StreamingSource,
    prefetch_batches,
)
from gan_aug_pfa_torch.data.transforms import sample_augment_params
from gan_aug_pfa_torch.models import SiameseUNet
from gan_aug_pfa_torch.train import __main__ as train_cli
from gan_aug_pfa_torch.train.gan import GANTrainer
from gan_aug_pfa_torch.train.siamese import SiameseTrainer
from gan_aug_pfa_tpu import config as jcfg
from gan_aug_pfa_tpu import pipelines as jp
from gan_aug_pfa_tpu.data.stream import StreamingSource as JaxSource
from torch_port_helpers import jax_pix2pix_variables, jax_siamese_variables

SIZE = (32, 32)
SUBDIR = "Onera Satellite Change Detection Dataset"
# Evaluation weights whose probabilities on oscd_tree all lie more than
# 1e-4 from 0.5 (tests/test_torch_eval.py), so no pixel flips between the
# frameworks.
EVAL_WEIGHT_SEED = 1
SMALL_GAN = dict(num_downs=5, ngf=8, ndf=8, n_layers=2)


@pytest.fixture(scope="module")
def samples(oscd_tree):
    return create_sample_lists(str(oscd_tree), SUBDIR, mode="train",
                               verbose=False)


def _as_float64(source):
    """Make ``source`` hand out float64 images (labels stay int32)."""
    batch = source.batch

    def batch64(idx):
        img1, img2, labels = batch(idx)
        return img1.astype(np.float64), img2.astype(np.float64), labels

    source.batch = batch64  # what submit() runs on the staging threads
    return source


# -- the sources and the prefetcher --------------------------------------


def test_source_modes_match_resident_cache_and_jax(samples):
    """Both cache modes hand out the resident cache's rows bit for bit, and
    the JAX package's StreamingSource's batches."""
    ds = build_cached_dataset(samples, SIZE, verbose=False)
    idx = np.array([2, 0, 3])
    for mode in ("host", "decode"):
        src = StreamingSource(samples, SIZE, cache=mode, verbose=False)
        jsrc = JaxSource(samples, SIZE, cache=mode, verbose=False)
        try:
            assert len(src) == len(ds) == len(jsrc)
            assert src.has_labels and src.cities == ds.cities
            got, want = src.batch(idx), jsrc.batch(idx)
        finally:
            src.close()
            jsrc.close()
        for a, b, c in zip(got, (ds.img1[idx], ds.img2[idx],
                                 ds.labels[idx]), want):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
            assert a.dtype == c.dtype


def test_decode_mode_raises_naming_the_file(samples, tmp_path):
    """A streamed epoch cannot skip a sample: an unreadable file raises a
    RuntimeError naming its city and path when its batch is assembled."""
    bad = dataclasses.replace(samples[0], img1=str(tmp_path / "gone.png"),
                              city="badcity")
    src = StreamingSource([bad] + samples, SIZE, cache="decode",
                          verbose=False)
    try:
        assert len(src) == len(samples) + 1  # nothing decoded up front
        with pytest.raises(RuntimeError, match="badcity.*gone.png"):
            src.batch(np.array([0]))
    finally:
        src.close()


def test_decode_mode_one_worker_does_not_deadlock(samples):
    """Staging and decoding have pools of their own: one decode thread and
    depth 2 still make progress."""
    src = StreamingSource(samples, SIZE, cache="decode", workers=1,
                          verbose=False)
    try:
        seen = list(prefetch_batches(
            src, [np.array([0, 1]), np.array([2]), np.array([3])],
            lambda b: b, depth=2))
    finally:
        src.close()
    assert [len(b[0]) for _, b in seen] == [2, 1, 1]


def test_prefetch_keeps_order_and_depth_bounds_staged(samples):
    """Batches come out in order, and at most ``depth`` are staged (put)
    ahead of the consumer."""
    src = StreamingSource(samples, SIZE, cache="host", verbose=False)
    batches = [np.array([i % len(src), (i + 1) % len(src)])
               for i in range(12)]
    depth, puts, consumed = 2, 0, 0

    def put(b):
        nonlocal puts
        puts += 1
        assert puts - consumed <= depth, "staged beyond the depth bound"
        return b

    try:
        for want, (idx, batch) in zip(batches, prefetch_batches(
                src, batches, put, depth=depth)):
            np.testing.assert_array_equal(idx, want)
            np.testing.assert_array_equal(batch[0], src.batch(want)[0])
            consumed += 1
    finally:
        src.close()
    assert consumed == puts == 12


def test_batch_put_gives_device_cache_rows(samples):
    """A put batch equals the device cache's rows: NCHW contiguous images
    and float32 labels; ``labels=False`` and absent arrays give None."""
    ds = build_cached_dataset(samples, SIZE, verbose=False)
    cache = tp.DeviceCache.from_dataset(ds, "cpu")
    idx = np.array([3, 1])
    img1, img2, labels = BatchPut("cpu")(
        (ds.img1[idx], ds.img2[idx], ds.labels[idx])).get()
    t = torch.from_numpy(idx)
    for got, want in ((img1, cache.img1), (img2, cache.img2),
                      (labels, cache.labels)):
        assert got.is_contiguous() and got.dtype == want.dtype
        assert torch.equal(got, want.index_select(0, t))
    assert BatchPut("cpu", labels=False)(
        (ds.img1[idx], None, ds.labels[idx])).get()[1:] == (None, None)


# -- the trainers ---------------------------------------------------------


def test_streamed_siamese_epoch_equals_resident(samples):
    """The same init, order and batch step: a streamed epoch (partial last
    batch included) gives the resident epoch's loss and weights exactly,
    in both cache modes."""
    cfg = SiameseTrainConfig(batch_size=3, compute_dtype="float32")
    ds = build_cached_dataset(samples, SIZE, verbose=False)
    resident = SiameseTrainer(cfg, "cpu")
    fresh = copy.deepcopy(resident)  # the same init, optimizer and draws
    want = resident.train_epoch(tp.DeviceCache.from_dataset(ds, "cpu"),
                                np.random.RandomState(7))
    for mode in ("host", "decode"):
        trainer = copy.deepcopy(fresh)
        src = StreamingSource(samples, SIZE, cache=mode, verbose=False)
        try:
            got = trainer.train_epoch_streaming(src, np.random.RandomState(7))
        finally:
            src.close()
        assert got == want, mode
        for (name, a), b in zip(trainer.model.state_dict().items(),
                                resident.model.state_dict().values()):
            assert torch.equal(a, b), (mode, name)


class _Float32Is64:
    """A module's namespace in which ``float32`` names float64: each
    package's FocalDice, which casts the logits to float32, then runs at
    float64 (the modules themselves are unchanged)."""

    def __init__(self, module, float64):
        self._module = module
        self.float32 = float64

    def __getattr__(self, name):
        return getattr(self._module, name)


def test_streamed_epoch_matches_jax_streamed_epoch_at_float64(samples,
                                                              monkeypatch):
    """The port's streamed epoch and the JAX package's
    ``train_epoch_streaming`` from one init, the same order and batches,
    at float64 (models, inputs and each package's own FocalDice): the
    epoch losses within 1e-6.  Two batches of 2 from an unscaled head: a
    batch of one, or logits of tens, would make BatchNorm over the 2x2
    bottleneck and Adam's first steps amplify the JAX upsample's float32
    weights (about 1e-8) past 1e-6 (tests/test_torch_train.py)."""
    import jax.numpy as jnp

    from gan_aug_pfa_torch import losses as tlosses
    from gan_aug_pfa_tpu import losses as jlosses
    from gan_aug_pfa_tpu.models.siamese_unet import SiameseUNet as JaxModel
    from gan_aug_pfa_tpu.train.siamese import SiameseTrainer as JaxTrainer
    from gan_aug_pfa_tpu.train.siamese import TrainState

    monkeypatch.setattr(jlosses, "jnp", _Float32Is64(jnp, jnp.float64))
    monkeypatch.setattr(tlosses, "torch", _Float32Is64(torch, torch.float64))
    init = jax_siamese_variables(seed=2, size=SIZE[0], head_scale=1.0)
    jsrc = _as_float64(JaxSource(samples, SIZE, cache="host", verbose=False))
    with jax.enable_x64(True):
        trainer = JaxTrainer(jcfg.SiameseTrainConfig(
            batch_size=2, compute_dtype="float32", data_parallel=False))
        v64 = jax.tree.map(lambda a: jnp.asarray(a, np.float64), init)
        state = TrainState.create(
            apply_fn=JaxModel(3, 1, dtype=np.float64).apply,
            params=v64["params"], tx=trainer.tx,
            batch_stats=v64["batch_stats"])
        try:
            _, want = trainer.train_epoch_streaming(
                state, jsrc, jax.random.PRNGKey(0), np.random.RandomState(7))
        finally:
            jsrc.close()
    port = SiameseTrainer(SiameseTrainConfig(batch_size=2,
                                             compute_dtype="float32"), "cpu")
    port.model.load_state_dict(ti.siamese_state_dict_from_jax(init))
    port.model.double()
    port.loss = lambda logits, labels: tlosses.focal_dice_loss(
        logits, labels, **port.loss_kwargs)
    src = _as_float64(StreamingSource(samples, SIZE, cache="host",
                                      verbose=False))
    try:
        got = port.train_epoch_streaming(src, np.random.RandomState(7))
    finally:
        src.close()
    assert got == pytest.approx(want, rel=1e-6)


def test_streamed_augmented_step_equals_gather_step(samples):
    """Augmented (the fixed-size chain, the only one a stream has): the
    batch step on a put batch equals the gather step on the same rows,
    with given draws and with draws from the trainer's generator."""
    cfg = SiameseTrainConfig(batch_size=4, compute_dtype="float32")
    ds = build_cached_dataset(samples, SIZE, verbose=False)
    idx = np.array([1, 3, 0, 2])
    sizes = torch.tensor([SIZE] * len(idx))
    params = sample_augment_params(torch.Generator().manual_seed(5), sizes)
    batch = BatchPut("cpu")((ds.img1[idx], ds.img2[idx], ds.labels[idx]))
    img1, img2, labels = batch.get()
    fresh = SiameseTrainer(cfg, "cpu", augment=True)
    for p in (params, None):
        gather, stream = copy.deepcopy(fresh), copy.deepcopy(fresh)
        want = gather.train_step(tp.DeviceCache.from_dataset(ds, "cpu"),
                                 torch.from_numpy(idx), p)
        got = stream.train_batch(img1, img2, labels, p)
        assert torch.equal(got, want)


def test_streamed_gan_epoch_equals_resident(samples):
    """Full batches in the same order through ``train_batch``: the streamed
    GAN epoch gives the resident epoch's losses and generator exactly."""
    cfg = GANTrainConfig(batch_size=2, target_size=SIZE,
                         compute_dtype="float32", **SMALL_GAN)
    ds = build_cached_dataset(samples, SIZE, verbose=False)
    resident = GANTrainer(cfg, "cpu")
    streamed = copy.deepcopy(resident)
    want = resident.train_epoch(tp.DeviceCache.from_dataset(ds, "cpu"),
                                np.random.RandomState(3))
    src = StreamingSource(samples, SIZE, cache="decode", verbose=False)
    try:
        got = streamed.train_epoch_streaming(src, np.random.RandomState(3))
    finally:
        src.close()
    assert got == want
    for a, b in zip(streamed.generator.state_dict().values(),
                    resident.generator.state_dict().values()):
        assert torch.equal(a, b)


# -- the pipelines against the resident path and JAX ----------------------


@pytest.fixture
def jax_inits_jitted(monkeypatch):
    """The JAX pipelines' eager model inits (most of a JAX run's seconds on
    the CPU at full width), each compiled as one program instead: the
    pipelines overwrite every leaf from the checkpoint, so the values do
    not matter."""
    from gan_aug_pfa_tpu.train import gan as jgan
    from gan_aug_pfa_tpu.train import siamese as jsiamese

    for cls, name, static in ((jgan.GANTrainer, "init_states", (0,)),
                              (jsiamese.SiameseTrainer, "init_state",
                               (0, 2))):
        fn = jax.jit(getattr(cls, name), static_argnums=static)
        monkeypatch.setattr(cls, name,
                            lambda self, *args, fn=fn: fn(self, *args))


@pytest.fixture(scope="module")
def eval_pth(tmp_path_factory):
    model = SiameseUNet()
    model.load_state_dict(ti.siamese_state_dict_from_jax(
        jax_siamese_variables(seed=EVAL_WEIGHT_SEED, size=SIZE[0])),
        strict=True)
    pth = str(tmp_path_factory.mktemp("stream_eval") / "model.pth")
    tck.save_model(pth, model)
    return pth


def test_streamed_evaluation_equals_resident_and_jax(oscd_tree, eval_pth,
                                                     tmp_path,
                                                     jax_inits_jitted):
    """``--stream host`` and ``decode`` reports (with the sweep and
    post-processing) equal the resident report, and the JAX package's
    streamed report within 1e-6."""
    root = str(oscd_tree)
    kw = dict(target_size=SIZE, checkpoint_path=eval_pth,
              num_visualizations=0, compute_dtype="float32",
              threshold_sweep=True, post_process=True)
    reports = {}
    for mode in ("hbm", "host", "decode"):
        path = str(tmp_path / f"{mode}.json")
        tp.run_evaluation(DataConfig(root_dir=root, stream=mode),
                          EvalConfig(output_dir=str(tmp_path / mode),
                                     json_out=path, **kw),
                          verbose=False, device="cpu")
        with open(path) as f:
            reports[mode] = json.load(f)
    assert reports["host"] == reports["hbm"] == reports["decode"]
    jax_path = str(tmp_path / "jax.json")
    jp.run_evaluation(jcfg.DataConfig(root_dir=root, stream="decode"),
                      jcfg.EvalConfig(output_dir=str(tmp_path / "jax"),
                                      json_out=jax_path, **kw),
                      verbose=False)
    with open(jax_path) as f:
        want = json.load(f)
    got = reports["decode"]
    for key in ("n_samples", "threshold", "checkpoints", "per_city_counts"):
        assert got[key] == want[key], key
    assert got["overall"] == pytest.approx(want["overall"], rel=0, abs=1e-6)
    for city, m in want["per_city"].items():
        assert got["per_city"][city] == pytest.approx(m, rel=0, abs=1e-6)
    assert got["sweep"]["best_threshold"] == want["sweep"]["best_threshold"]
    assert got["sweep"]["f1"] == pytest.approx(want["sweep"]["f1"], rel=0,
                                               abs=1e-6)


def test_streamed_synthesis_equals_resident_and_jax(oscd_tree, tmp_path,
                                                    jax_inits_jitted):
    """``--stream decode`` synthesis writes the resident run's files byte
    for byte, and the JAX package's streamed run's img1 and label files
    byte for byte (img2 within the frameworks' generator rounding, 1 LSB
    on at most 0.5% of pixels, as tests/test_torch_synthesis.py holds)."""
    root = str(oscd_tree)
    gan_dir = str(tmp_path / "gan")
    vg, _ = jax_pix2pix_variables(seed=4, size=SIZE[0])
    tck.save_state_dict(os.path.join(gan_dir, "generator_epoch_1.pth"),
                        ti.generator_state_dict_from_jax(vg))
    common = dict(target_size=SIZE, num_downs=5, ngf=8,
                  generator_checkpoint_name="generator_epoch_1.pth",
                  gan_checkpoint_dir=gan_dir)
    out = {side: str(tmp_path / side) for side in ("hbm", "decode", "jax")}
    for mode in ("hbm", "decode"):
        assert tp.run_generate_synthetic(
            DataConfig(root_dir=root, synthetic_data_dir=out[mode],
                       stream=mode),
            GenerateConfig(synthetic_data_dir=out[mode], **common),
            verbose=False, device="cpu") == 5
    assert jp.run_generate_synthetic(
        jcfg.DataConfig(root_dir=root, synthetic_data_dir=out["jax"],
                        stream="decode"),
        jcfg.GenerateConfig(synthetic_data_dir=out["jax"],
                            compute_dtype="float32", **common),
        verbose=False) == 5

    def files(base):
        return {os.path.relpath(os.path.join(d, f), base):
                open(os.path.join(d, f), "rb").read()
                for d, _, fs in os.walk(base) for f in fs}

    got, resident, want = (files(out[s]) for s in ("decode", "hbm", "jax"))
    assert got == resident
    assert sorted(got) == sorted(want) and len(got) == 15
    diffs = []
    for name, data in got.items():
        if "img2_" not in name:
            assert data == want[name], name
        else:
            a, b = (png.decode_rgb(os.path.join(out[s], name))
                    for s in ("decode", "jax"))
            diffs.append(np.abs(a.astype(int) - b).ravel())
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 1 and (diffs > 0).mean() <= 0.005


@pytest.mark.parametrize("mode", ["host", "decode"])
def test_four_clis_run_with_stream(oscd_tree, eval_pth, tmp_path, mode,
                                   capsys):
    """train (with --augment, which streams the fixed-size chain),
    train_gan, generate_synthetic and evaluate each run with --stream
    host and --stream decode on the CPU."""
    root = str(oscd_tree)
    common = ["--root-dir", root, "--device", "cpu", "--stream", mode]
    history = train_cli.main([
        *common, "--target-size", "32x32", "--num-epochs", "1",
        "--augment", "--checkpoint-dir", str(tmp_path / "siamese")])
    out = capsys.readouterr().out
    assert "streaming the fixed-size chain instead" in out
    assert "Streaming source: 4 samples" in out
    assert np.isfinite(history["train_loss"] + history["val_loss"]).all()
    small = ["--target-size", "32x32", "--num-downs", "5", "--ngf", "8"]
    gan = gan_cli.main([*common, *small, "--ndf", "8", "--num-epochs", "1",
                        "--checkpoint-dir", str(tmp_path / "gan"),
                        "--output-dir", str(tmp_path / "gan_samples")])
    assert np.isfinite(gan["loss_d"] + gan["loss_g"]).all()
    assert len(os.listdir(tmp_path / "gan_samples")) == 1  # the strip
    assert synth_cli.main([
        *common, *small, "--gan-checkpoint-dir", str(tmp_path / "gan"),
        "--generator-checkpoint-name", "generator_epoch_1.pth",
        "--synthetic-data-dir", str(tmp_path / "synth")]) == 5
    report = str(tmp_path / "r.json")
    result = eval_cli.main([*common, "--target-size", "32x32",
                            "--checkpoint-path", eval_pth, "--json-out",
                            report, "--output-dir", str(tmp_path / "ev")])
    assert sum(result["per_city_counts"].values()) == 5
    assert "not ported yet" not in capsys.readouterr().err
