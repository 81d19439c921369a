"""The port's Pix2Pix GAN slice against the JAX package's on the CPU, at a
small size (``num_downs`` 5 at 32x32, ``ngf``/``ndf`` 8, JAX at float32 or
float64): the models' parameter counts, weights interop and forwards; one
D+G step and the EMA at float64 against ``GANTrainer._gan_batch_impl``; one
float32 epoch of ``run_gan_training`` against the JAX pipeline's from the
same init; the port's checkpoints in JAX; resume; the CLI.

Tolerances, and why:
  * forwards within 1e-5 of JAX (float32, train and eval mode);
  * the float64 step within 1e-6: losses relative, parameters and
    BatchNorm statistics absolute.  The JAX models cast their outputs to
    float32 (pix2pix.py:144, :198) and both sides take the losses in
    float32, so the losses and the gradients behind them carry float32
    rounding (about 6e-8 relative), which Adam's normalized update turns
    into parameter differences of up to 2e-7 (measured), against moves of
    about lr = 1e-4; the losses differ by up to 6e-7 relative (measured,
    step 2's loss_G).  BatchNorm running_var follows torch's unbiased update:
    (rv_torch - m^K rv0) = N/(N-1) (rv_flax - m^K rv0), K the layer's
    updates in the step (2 in G, 3 in D), N = B*H*W at its input; at batch
    1 the innermost upnorm sees a 2x2 map, N/(N-1) = 4/3 (ROADMAP C1);
  * one float32 epoch (5 steps at batch 1): epoch losses within 1e-5
    relative (measured 1.7e-7 and 0).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_aug_pfa_torch import interop as ti
from gan_aug_pfa_torch import pipelines as tp
from gan_aug_pfa_torch import train_gan as gan_cli
from gan_aug_pfa_torch.config import DataConfig, GANTrainConfig
from gan_aug_pfa_torch.data import png
from gan_aug_pfa_torch.models import NLayerDiscriminator, UNetGenerator
from gan_aug_pfa_torch.pipelines import DeviceCache
from gan_aug_pfa_torch.train.gan import GANTrainer
from gan_aug_pfa_tpu import config as jcfg
from gan_aug_pfa_tpu import interop as ji
from gan_aug_pfa_tpu import pipelines as jp
from gan_aug_pfa_tpu.train.gan import GANState
from gan_aug_pfa_tpu.train.gan import GANTrainer as JaxGANTrainer
from torch_port_helpers import jax_pix2pix_models, jax_pix2pix_variables
from torch_tmp import drop_tmp_path  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
ARCH = {"num_downs": 5, "ngf": 8, "ndf": 8, "n_layers": 3}
BN_MOMENTUM = 0.9  # flax momentum; torch's 0.1
EMA_DECAY = 0.9
SMALL = ["--target-size", "32x32", "--num-downs", "5", "--ngf", "8",
         "--ndf", "8"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs six test processes on the host's cores at once; two
    threads for this file's CPU work keep them from oversubscribing the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_cfg(**kw):
    return GANTrainConfig(target_size=(SIZE, SIZE), compute_dtype="float32",
                          **ARCH, **kw)


def _jax_cfg(**kw):
    return jcfg.GANTrainConfig(target_size=(SIZE, SIZE),
                               compute_dtype="float32", data_parallel=False,
                               **ARCH, **kw)


def _port_models():
    return (UNetGenerator(num_downs=ARCH["num_downs"], ngf=ARCH["ngf"]),
            NLayerDiscriminator(ndf=ARCH["ndf"], n_layers=ARCH["n_layers"]))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def variables():
    return jax_pix2pix_variables(seed=3, size=SIZE, **ARCH)


# -- models and interop --------------------------------------------------


def test_full_width_parameter_counts_and_patch_map():
    """The reference's counts (BASELINE.md) and its (1, 30, 30, 1) patch
    map at 256x256, NCHW here."""
    g, d = UNetGenerator(), NLayerDiscriminator()
    assert sum(p.numel() for p in g.parameters()) == 41_828_995
    assert sum(p.numel() for p in d.parameters()) == 2_768_705
    with torch.no_grad():
        assert d(torch.zeros(1, 6, 256, 256)).shape == (1, 1, 30, 30)
        assert g.eval()(torch.zeros(1, 3, 256, 256)).shape == (1, 3, 256, 256)


@pytest.mark.parametrize("which", ["generator", "discriminator"])
def test_state_dict_matches_jax_interop(variables, which):
    """Key for key and value for value against the JAX package's
    generator_to_torch / discriminator_to_torch, and strict-loadable."""
    i = 0 if which == "generator" else 1
    port = (ti.generator_state_dict_from_jax,
            ti.discriminator_state_dict_from_jax)[i](variables[i])
    want = (ji.generator_to_torch, ji.discriminator_to_torch)[i](variables[i])
    assert list(port) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(port[k].numpy(), v, err_msg=k)
    model = _port_models()[i]
    assert set(model.state_dict()) == set(port)
    model.load_state_dict(port, strict=True)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("which", ["generator", "discriminator"])
def test_forward_matches_jax(variables, which, train):
    i = 0 if which == "generator" else 1
    jmodel = jax_pix2pix_models(**ARCH)[i]
    rng = np.random.RandomState(5)
    x = (rng.rand(2, SIZE, SIZE, 3 * (i + 1)) * 2 - 1).astype(np.float32)
    if train:
        want, _ = jax.jit(lambda v, a: jmodel.apply(
            v, a, train=True, mutable=["batch_stats"]))(variables[i], x)
    else:
        want = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
            variables[i], x)
    model = _port_models()[i]
    model.load_state_dict((ti.generator_state_dict_from_jax,
                           ti.discriminator_state_dict_from_jax)[i](
                               variables[i]))
    with torch.no_grad():
        got = model.train(train)(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


# -- one D+G step at float64 -----------------------------------------------


def _bn_sizes(model, x):
    """N = B*H*W at each BatchNorm's input for input ``x``."""
    sizes, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            hooks.append(m.register_forward_pre_hook(
                lambda m, i, name=name: sizes.__setitem__(
                    name, i[0].shape[0] * i[0].shape[2] * i[0].shape[3])))
    training = model.training
    with torch.no_grad():
        model.eval()(x)
    model.train(training)
    for h in hooks:
        h.remove()
    return sizes


@pytest.fixture(scope="module")
def fp64_steps(variables):
    """Two D+G steps with an EMA (decay 0.9) from one init, at float64 on
    both sides: the JAX trainer's ``_gan_batch_impl`` with float64 models,
    jitted once, and the port's ``train_batch``."""
    rng = np.random.RandomState(7)
    batches = [tuple(rng.rand(1, SIZE, SIZE, 3) for _ in range(2))
               for _ in range(2)]
    with jax.enable_x64(True):
        trainer = JaxGANTrainer(_jax_cfg(ema_decay=EMA_DECAY))
        trainer.generator, trainer.discriminator = jax_pix2pix_models(
            **ARCH, dtype=jnp.float64)
        v64 = [jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
               for v in variables]
        sg = GANState.create(
            apply_fn=None, params=v64[0]["params"], tx=trainer.tx_g,
            batch_stats=v64[0]["batch_stats"],
            ema_params=jax.tree.map(jnp.copy, v64[0]["params"]))
        sd = GANState.create(apply_fn=None, params=v64[1]["params"],
                             tx=trainer.tx_d,
                             batch_stats=v64[1]["batch_stats"])
        step = jax.jit(trainer._gan_batch_impl)
        jax_steps = []
        for a, b in batches:
            sg, sd, ld, lg = step(sg, sd, a, b)
            jax_steps.append(jax.tree.map(np.asarray, {
                "g": {"params": sg.params, "batch_stats": sg.batch_stats},
                "d": {"params": sd.params, "batch_stats": sd.batch_stats},
                "ema": {"params": sg.ema_params,
                        "batch_stats": sg.batch_stats},
                "loss": (ld, lg)}))

    port = GANTrainer(_port_cfg(ema_decay=EMA_DECAY), "cpu")
    port.generator.double()
    port.discriminator.double()
    port.load_state_dicts(
        ti.generator_state_dict_from_jax(variables[0], dtype=np.float64),
        ti.discriminator_state_dict_from_jax(variables[1], dtype=np.float64))
    start = {"g": dict(port.generator.state_dict()),
             "d": dict(port.discriminator.state_dict())}
    start = {k: {n: t.clone() for n, t in v.items()}
             for k, v in start.items()}
    port_steps = []
    for a, b in batches:
        ld, lg = port.train_batch(_nchw(a), _nchw(b))
        port_steps.append({
            "g": {k: v.clone() for k, v in port.generator.state_dict().items()},
            "d": {k: v.clone()
                  for k, v in port.discriminator.state_dict().items()},
            "loss": (float(ld), float(lg))})
    x = torch.zeros(1, 3, SIZE, SIZE, dtype=torch.float64)
    sizes = {"g": _bn_sizes(port.generator, x),
             "d": _bn_sizes(port.discriminator, torch.cat([x, x], dim=1))}
    return {"jax": jax_steps, "port": port_steps, "start": start,
            "sizes": sizes, "ema": port.ema_state_dict()}


def _jax_state_dicts(step):
    return {"g": ti.generator_state_dict_from_jax(step["g"], np.float64),
            "d": ti.discriminator_state_dict_from_jax(step["d"], np.float64)}


def test_fp64_step_losses_match_jax(fp64_steps):
    for j, p in zip(fp64_steps["jax"], fp64_steps["port"]):
        assert p["loss"][0] == pytest.approx(float(j["loss"][0]), rel=1e-6)
        assert p["loss"][1] == pytest.approx(float(j["loss"][1]), rel=1e-6)


def test_fp64_step_parameters_match_jax(fp64_steps):
    """Both models' parameters after the first step, and how far they
    moved: every one moved (lr 1e-4 an Adam step) and agrees within 1e-6."""
    want = _jax_state_dicts(fp64_steps["jax"][0])
    got = fp64_steps["port"][0]
    for net in ("g", "d"):
        for k, v in got[net].items():
            if "running" in k or "num_batches" in k:
                continue
            np.testing.assert_allclose(v.numpy(), want[net][k].numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)
            moved = (v - fp64_steps["start"][net][k]).abs().max()
            assert float(moved) > 1e-5, k


def test_fp64_step_batchnorm_statistics_match_jax(fp64_steps):
    want = _jax_state_dicts(fp64_steps["jax"][0])
    got = fp64_steps["port"][0]
    for net, updates in (("g", 2), ("d", 3)):
        decay = BN_MOMENTUM ** updates
        for name, n in fp64_steps["sizes"][net].items():
            mean, var = name + ".running_mean", name + ".running_var"
            assert int(got[net][name + ".num_batches_tracked"]) == updates
            np.testing.assert_allclose(got[net][mean], want[net][mean],
                                       rtol=0, atol=1e-6, err_msg=mean)
            rv0 = fp64_steps["start"][net][var]
            np.testing.assert_allclose(
                got[net][var] - decay * rv0,
                n / (n - 1) * (want[net][var] - decay * rv0),
                rtol=0, atol=1e-6, err_msg=var)
    assert min(fp64_steps["sizes"]["g"].values()) == 4  # the 2x2 upnorm


def test_ema_after_two_steps_matches_jax(fp64_steps):
    want = ti.generator_state_dict_from_jax(fp64_steps["jax"][1]["ema"],
                                            np.float64)
    got = fp64_steps["ema"]
    params = dict(UNetGenerator(**{k: ARCH[k] for k in ("num_downs", "ngf")})
                  .named_parameters())
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    # ema = p0 d^2 + p1 d (1-d) + p2 (1-d), d = 0.9.
    p0, p1, p2 = (s["g"] for s in (fp64_steps["start"],
                                   *fp64_steps["port"]))
    for k in params:
        closed = (p0[k] * EMA_DECAY ** 2 + p1[k] * EMA_DECAY * (1 - EMA_DECAY)
                  + p2[k] * (1 - EMA_DECAY))
        np.testing.assert_allclose(got[k].numpy(), closed.numpy(), rtol=0,
                                   atol=1e-12, err_msg=k)


# -- one float32 epoch through both pipelines ---------------------------


@pytest.fixture(scope="module")
def epoch_runs(oscd_tree, tmp_path_factory):
    """One float32 epoch of each package's ``run_gan_training`` on
    ``oscd_tree`` (5 cities, batch 1) from the JAX pipeline's own init
    (PRNGKey(seed)), carried across; checkpoints and strips in tmp."""
    root = str(oscd_tree)
    tmp = tmp_path_factory.mktemp("torch_gan")
    dirs = {side: {"checkpoint_dir": str(tmp / side / "ckpt"),
                   "output_dir": str(tmp / side / "samples")}
            for side in ("jax", "port")}
    jax_cfg = _jax_cfg(num_epochs=1, **dirs["jax"])
    sg, sd = JaxGANTrainer(jax_cfg).init_states(
        jax.random.PRNGKey(jax_cfg.seed))
    init = [jax.tree.map(np.asarray, {"params": s.params,
                                      "batch_stats": s.batch_stats})
            for s in (sg, sd)]
    want = jp.run_gan_training(
        jcfg.DataConfig(root_dir=root, target_size=(SIZE, SIZE)), jax_cfg,
        verbose=False)
    got = tp.run_gan_training(
        DataConfig(root_dir=root, target_size=(SIZE, SIZE)),
        _port_cfg(num_epochs=1, **dirs["port"]), verbose=False, device="cpu",
        initial_state_dicts=(ti.generator_state_dict_from_jax(init[0]),
                             ti.discriminator_state_dict_from_jax(init[1])))
    return {"root": root, "dirs": dirs, "jax": want, "port": got}


def test_epoch_losses_match_jax(epoch_runs):
    want, got = epoch_runs["jax"], epoch_runs["port"]
    for key in ("loss_d", "loss_g"):
        assert len(got[key]) == 1
        assert got[key][0] == pytest.approx(want[key][0], rel=1e-5), key


def test_epoch_writes_reference_names_and_strip(epoch_runs):
    """The JAX file set with ``.pth`` for ``.msgpack``, and the strip of
    the same preview pair, [A | G(A) | B] at 32x96, within 2 LSB of
    JAX's."""
    dirs = epoch_runs["dirs"]
    want = sorted(f.replace(".msgpack", ".pth")
                  for f in os.listdir(dirs["jax"]["checkpoint_dir"]))
    assert sorted(os.listdir(dirs["port"]["checkpoint_dir"])) == want == [
        "discriminator_epoch_1.pth", "generator_epoch_1.pth",
        "last_discriminator.pth", "last_generator.pth"]
    names = [os.listdir(dirs[s]["output_dir"]) for s in ("jax", "port")]
    assert names[0] == names[1] and len(names[0]) == 1
    assert names[0][0].endswith("_epoch_001.png")
    strips = [png.decode_rgb(os.path.join(dirs[s]["output_dir"], names[0][0]))
              for s in ("jax", "port")]
    assert strips[1].shape == (SIZE, 3 * SIZE, 3)
    assert np.abs(strips[0].astype(int) - strips[1]).max() <= 2


def test_port_generator_checkpoint_generates_in_jax(epoch_runs):
    """The port's ``generator_epoch_1.pth`` through the JAX package's
    interop.variables_from_torch_file: the JAX generator's eval output
    equals the port's within 1e-5."""
    path = os.path.join(epoch_runs["dirs"]["port"]["checkpoint_dir"],
                        "generator_epoch_1.pth")
    jvars = ji.variables_from_torch_file(path)
    gen = jax_pix2pix_models(**ARCH)[0]
    x = np.random.RandomState(2).rand(2, SIZE, SIZE, 3).astype(np.float32)
    want = jax.jit(lambda v, a: gen.apply(v, a * 2 - 1, train=False)
                   * 0.5 + 0.5)(jvars, x)
    got = epoch_runs["port"]["trainer"].generate(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# -- resume, epochs, config ----------------------------------------------


def test_resume_restores_models_optimizers_and_ema(oscd_tree, tmp_path):
    """``--resume`` from last_*.pth: a run whose epoch budget is already
    spent restores the saved models, optimizers and EMA exactly; one more
    epoch then runs alone and counts its Adam steps on."""
    data = DataConfig(root_dir=str(oscd_tree), target_size=(SIZE, SIZE))

    def run(epochs, resume):
        return tp.run_gan_training(
            data, _port_cfg(num_epochs=epochs, resume=resume,
                            ema_decay=EMA_DECAY,
                            checkpoint_dir=str(tmp_path / "ckpt"),
                            output_dir=str(tmp_path / "samples")),
            verbose=False, device="cpu")

    first = run(1, False)["trainer"]
    restored = run(1, True)
    assert restored["loss_d"] == []
    again = restored["trainer"]
    for a, b in ((first.generator, again.generator),
                 (first.discriminator, again.discriminator)):
        for (k, v), w in zip(a.state_dict().items(),
                             b.state_dict().values()):
            assert torch.equal(v, w), k
    for opt_a, opt_b in ((first.opt_g, again.opt_g),
                         (first.opt_d, again.opt_d)):
        for s_a, s_b in zip(opt_a.state_dict()["state"].values(),
                            opt_b.state_dict()["state"].values()):
            for field, v in s_a.items():
                assert torch.equal(v, s_b[field]), field
    for k, v in first.ema.items():
        assert torch.equal(v, again.ema[k]), k

    resumed = run(2, True)
    assert len(resumed["loss_g"]) == 1
    state = torch.load(tmp_path / "ckpt" / "last_generator.pth",
                       weights_only=True)
    assert state["epoch"] == 2 and set(state["ema"]) == set(first.ema)
    # 5 samples at batch 1: 5 Adam steps an epoch.
    assert all(float(s["step"]) == 10
               for s in state["optimizer"]["state"].values())
    assert sorted(os.listdir(tmp_path / "samples")) == [
        "sample_paris_epoch_001.png", "sample_paris_epoch_002.png"]


def test_train_epoch_drops_the_partial_batch():
    """One permutation an epoch from the epoch generator, full batches
    only (drop_last=True); the epoch losses are the batch means."""
    trainer = GANTrainer(_port_cfg(batch_size=2), "cpu")
    seen = []

    def fake_step(cache, idx):
        seen.append(idx.tolist())
        return torch.tensor(1.0 * len(seen)), torch.tensor(-1.0 * len(seen))

    trainer.train_step = fake_step
    cache = DeviceCache(torch.zeros(5, 3, 8, 8), torch.zeros(5, 3, 8, 8),
                        torch.zeros(5, 8, 8))
    assert trainer.train_epoch(cache, np.random.RandomState(0)) == (1.5, -1.5)
    perm = np.random.RandomState(0).permutation(5).tolist()
    assert seen == [perm[0:2], perm[2:4]]
    # No full batch: (0.0, 0.0), and the epoch's permutation is still
    # drawn, as in JAX (gan.py:354-357).
    one = DeviceCache(torch.zeros(1, 3, 8, 8), torch.zeros(1, 3, 8, 8),
                      torch.zeros(1, 8, 8))
    rng, want = np.random.RandomState(0), np.random.RandomState(0)
    assert trainer.train_epoch(one, rng) == (0.0, 0.0)
    want.permutation(1)
    assert rng.randint(1 << 30) == want.randint(1 << 30)


@pytest.mark.parametrize("decay", [-0.1, 1.0, 1.5])
def test_ema_decay_outside_unit_interval_raises(decay):
    with pytest.raises(ValueError, match="ema_decay"):
        GANTrainConfig(ema_decay=decay)


# -- the CLI --------------------------------------------------------------


def test_cli_trains_writes_reference_names_and_strip(oscd_tree, tmp_path):
    ckpt_dir, samples = tmp_path / "ckpt", tmp_path / "samples"
    proc = subprocess.run(
        [sys.executable, "-m", "gan_aug_pfa_torch.train_gan", "--device",
         "cpu", "--root-dir", str(oscd_tree), "--num-epochs", "1", *SMALL,
         "--checkpoint-dir", str(ckpt_dir), "--output-dir", str(samples),
         "--no-data-parallel", "--no-compile-cache"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert sorted(os.listdir(ckpt_dir)) == [
        "discriminator_epoch_1.pth", "generator_epoch_1.pth",
        "last_discriminator.pth", "last_generator.pth"]
    (strip,) = os.listdir(samples)
    assert strip == "sample_paris_epoch_001.png"
    assert png.decode_rgb(str(samples / strip)).shape == (SIZE, 3 * SIZE, 3)
    gen = torch.load(ckpt_dir / "generator_epoch_1.pth", weights_only=True)
    assert "model.model.0.weight" in gen  # a bare reference state_dict
    assert "Epoch 1 - Avg Loss D:" in proc.stdout


@pytest.mark.parametrize("flags", [
    ["--stream", "host", "--batched-disc"], ["--batched-disc"],
    ["--concat-free-disc"], ["--shared-gen-fwd"],
    ["--shared-gen-fwd", "--profile-dir", "prof"],
    ["--batched-disc", "--debug-nans"], ["--momentum-dtype", "bfloat16"],
    ["--flat-opt-state"],
    ["--stream", "decode", "--async-ckpt", "--flat-opt-state"],
    ["--concat-free-disc", "--log-jsonl", "run.jsonl"]])
def test_cli_rejects_flags_not_ported(flags, oscd_tree, tmp_path,
                                      monkeypatch):
    """The JAX package's GAN knobs, once not ported, now run: one epoch
    with each, also beside the run-control flags and ``--stream``."""
    monkeypatch.chdir(tmp_path)
    history = gan_cli.main([
        "--device", "cpu", "--root-dir", str(oscd_tree), "--num-epochs",
        "1", *SMALL, "--checkpoint-dir", str(tmp_path / "ckpt"),
        "--output-dir", str(tmp_path / "samples"), *flags])
    losses = history["loss_d"] + history["loss_g"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    cfg = history["trainer"].config
    for flag in flags:
        if flag.startswith("--") and flag not in (
                "--stream", "--profile-dir", "--debug-nans", "--async-ckpt",
                "--log-jsonl", "--momentum-dtype"):
            assert getattr(cfg, flag[2:].replace("-", "_").replace(
                "flat_opt_state", "opt_flat_state")), flag
    if "--momentum-dtype" in flags:
        assert cfg.opt_momentum_dtype == "bfloat16"


def test_cli_default_device_is_cuda_and_never_falls_back(oscd_tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gan_cli.main(["--root-dir", str(oscd_tree), "--num-epochs", "1",
                      *SMALL])
