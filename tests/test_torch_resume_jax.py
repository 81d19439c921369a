"""Resuming the port's trainers from a JAX train state, against the JAX
package on the CPU.

  * exact state mapping: a full Siamese train state written by the JAX
    package's ``checkpoint.save_checkpoint`` after one optax step, for
    ``adamw`` and ``adam``, with the extras of pipelines.py:351-362 (the
    plateau and early-stop state, the epoch, the best validation loss),
    restored by ``checkpoint.restore_train_state_from_jax``: the model and
    the moments equal JAX's ``params``/``mu``/``nu`` through the JAX
    package's own converter (exactly), ``step`` equals ``count``, the
    learning rate and weight decay are the injected ones, and the plateau
    and early-stop state, the epoch and the best loss are carried over;
  * one optimizer update in isolation at float64: from the restored state
    and one seeded gradient tree, optax's update and the port's optimizer
    step give parameters within 1e-6 relative (the Siamese net with AdamW
    and Adam; the JAX GAN fixture's generator, conv-transpose moments
    included, and discriminator with Adam's beta1 0.5);
  * CLI resume parity: ``python -m gan_aug_pfa_torch.train --resume``
    from the adamw file continues at the next epoch with losses within
    1e-3 relative of the JAX package resuming the same file at float32
    (the fp32 lockstep tolerance of tests/test_torch_train.py; the
    validation loss with the ROADMAP C1 running-variance factor taken out,
    as that file does).  ``train_gan --resume`` from the JAX GAN fixture is
    held against the JAX package in tests/test_torch_gan_runcontrol.py;
  * states in the optax layouts of the JAX package's optimizer knobs
    (flattened, bfloat16 first moments, MultiSteps) resume through the CLI
    with the knob's flag; an adam state under the adamw default exits 2.

The Siamese states are about 494 MB each (41.2M parameters and two
moments); they live in one temporary directory, removed with the module.
"""

import os
import shutil
import tempfile
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from gan_aug_pfa_torch import checkpoint as tck
from gan_aug_pfa_torch import interop as ti
from gan_aug_pfa_torch.config import SiameseTrainConfig
from gan_aug_pfa_torch.data.loader import build_cached_dataset
from gan_aug_pfa_torch.data.scanner import create_sample_lists
from gan_aug_pfa_torch.models import (
    NLayerDiscriminator,
    SiameseUNet,
    UNetGenerator,
)
from gan_aug_pfa_torch.pipelines import DeviceCache
from gan_aug_pfa_torch.train import __main__ as train_cli
from gan_aug_pfa_torch.train import optim as topt
from gan_aug_pfa_torch.train import plateau as tpl
from gan_aug_pfa_torch.train.siamese import SiameseTrainer
from gan_aug_pfa_tpu import checkpoint as jck
from gan_aug_pfa_tpu import config as jcfg
from gan_aug_pfa_tpu import interop as ji
from gan_aug_pfa_tpu import pipelines as jp
from gan_aug_pfa_tpu.train import optim as jopt
from gan_aug_pfa_tpu.models.siamese_unet import SiameseUNet as JaxSiamese
from gan_aug_pfa_tpu.train import plateau as jpl
from torch_port_helpers import _randomize_bn
from torch_tmp import drop_tmp_path  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAN_FIXTURE = os.path.join(REPO, "tests", "data", "jax_gan_state_nd5_ngf4")
GAN_ARCH = dict(num_downs=5, ngf=4, ndf=8, n_layers=2)
SUBDIR = "Onera Satellite Change Detection Dataset"
SIZE = (32, 32)
BS = 2
LR, WD = 3e-4, 1e-3
VAL_SERIES = [0.5, 0.6, 0.7, 0.8]  # one cut of the learning rate
EPOCH = len(VAL_SERIES)
BN_MOMENTUM = 0.9  # flax momentum; torch's 0.1
RESUME_RTOL = 1e-3
UPDATE_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: rng.standard_normal(p.shape, np.float32) * np.float32(1e-3),
        params)


def _write_state(path, tx, variables, extra, seed):
    """One optax step of ``tx`` from ``variables`` on seeded gradients,
    the learning rate set to the plateau's as the JAX pipeline sets it,
    saved through the JAX package's save_checkpoint.  Returns the params
    and the optimizer state it wrote."""
    params = variables["params"]
    state = tx.init(params)
    updates, state = jax.jit(tx.update)(_grads(params, seed), state, params)
    params = jax.tree.map(lambda p, u: np.asarray(p + u), params, updates)
    state = jopt.set_learning_rate(state, extra["scheduler"]["lr"])
    jck.save_checkpoint(path, SimpleNamespace(
        params=params, batch_stats=variables["batch_stats"],
        opt_state=state, step=1), extra=extra)
    return params, jax.tree.map(np.asarray, state)


@pytest.fixture(scope="module")
def siamese_states():
    """JAX-written Siamese train states, adamw and adam, after one step,
    at epoch 4 with a plateau that cut the learning rate once."""
    root = tempfile.mkdtemp(prefix="resume_jax_")
    x = jax.numpy.zeros((1, *SIZE, 3), jax.numpy.float32)
    variables = jax.jit(lambda k: JaxSiamese(3, 1).init(
        k, x, x, train=False))(jax.random.PRNGKey(1))
    rng = np.random.RandomState(1)
    variables = jax.tree.map(lambda a: np.asarray(a, np.float32), {
        k: _randomize_bn(jax.tree.map(np.asarray, variables[k]), rng)
        for k in ("params", "batch_stats")})
    plateau = jpl.ReduceLROnPlateau(LR, 0.2, patience=1)
    stopper = jpl.EarlyStopping(3)
    for v in VAL_SERIES:
        plateau.step(v)
        stopper.step(v)
    extra = {"epoch": EPOCH, "best_val_loss": min(VAL_SERIES),
             "scheduler": plateau.state_dict(),
             "early_stop": stopper.state_dict()}
    states = {"root": root, "init": variables, "extra": extra}
    for seed, name in enumerate(("adamw", "adam")):
        path = os.path.join(root, name, "last_state.msgpack")
        params, opt_state = _write_state(
            path, jopt.make_optimizer(name, LR, WD), variables, extra, seed)
        states[name] = {"path": path, "params": params,
                        "opt_state": opt_state}
    yield states
    shutil.rmtree(root, ignore_errors=True)


def _port_restore(path, name, dtype=torch.float32):
    model = SiameseUNet(3, 1).to(dtype)
    optimizer = topt.make_optimizer(name, model.parameters(), 1.0, 0.0)
    sched = tpl.make_plateau_scheduler(optimizer)
    stopper = tpl.EarlyStopping(3)
    extra = tck.restore_train_state_from_jax(path, model, optimizer, sched,
                                             stopper)
    return model, optimizer, sched, stopper, extra


def _adam(name, opt_state):
    return opt_state.inner_state[{"adamw": 0, "adam": 1}[name]]


@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_siamese_state_maps_exactly(siamese_states, name):
    s = siamese_states[name]
    model, optimizer, sched, stopper, extra = _port_restore(s["path"], name)
    bs = siamese_states["init"]["batch_stats"]
    want = ji.siamese_to_torch({"params": s["params"], "batch_stats": bs})
    for key, v in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v.numpy(), want[key], err_msg=key)
    adam = _adam(name, s["opt_state"])
    moments = {k: ji.siamese_to_torch({"params": getattr(adam, k),
                                       "batch_stats": bs})
               for k in ("mu", "nu")}
    names = dict(model.named_parameters())
    assert len(optimizer.state) == len(names) == 104
    for key, p in names.items():
        st = optimizer.state[p]
        assert float(st["step"]) == int(adam.count) == 1
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      moments["mu"][key], err_msg=key)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      moments["nu"][key], err_msg=key)
    hp = s["opt_state"].hyperparams
    group = optimizer.param_groups[0]
    assert group["lr"] == float(hp["learning_rate"]) == float(
        np.float32(LR * 0.2))
    assert group["weight_decay"] == float(hp["weight_decay"])
    if name == "adamw":
        assert group["betas"] == (float(hp["b1"]), float(hp["b2"]))
        assert isinstance(optimizer, torch.optim.AdamW)
    want = siamese_states["extra"]
    assert extra == {"epoch": EPOCH, "best_val_loss": min(VAL_SERIES)}
    assert (sched.best, sched.num_bad_epochs, sched.cooldown_counter) == (
        want["scheduler"]["best"], want["scheduler"]["num_bad_epochs"],
        want["scheduler"]["cooldown_counter"])
    assert sched.num_bad_epochs == 1
    assert sched.last_epoch == EPOCH
    assert sched.get_last_lr() == [group["lr"]]
    assert stopper.state_dict() == want["early_stop"]


# -- one update at float64 -------------------------------------------------


def _jax_update64(tx, opt_state, params, grads):
    def f64(a):
        a = np.asarray(a)
        return a.astype(np.float64) if a.dtype.kind == "f" else a

    with jax.enable_x64(True):
        opt_state, params, grads = (jax.tree.map(f64, t) for t in (
            opt_state, params, grads))
        updates, _ = jax.jit(tx.update)(grads, opt_state, params)
        return jax.tree.map(lambda p, u: np.asarray(p + u), params, updates)


def _port_step64(model, optimizer, to_torch, grads, batch_stats):
    g = to_torch({"params": grads, "batch_stats": batch_stats})
    for key, p in model.named_parameters():
        p.grad = torch.from_numpy(np.asarray(g[key], np.float64))
    optimizer.step()
    return model.state_dict()


def _assert_update_matches(got, want, before, params):
    for key in params:
        np.testing.assert_allclose(got[key].numpy(), want[key],
                                   rtol=UPDATE_RTOL, atol=0, err_msg=key)
        # The step itself, not only the parameters, agrees.
        delta = got[key].numpy() - before[key]
        jdelta = want[key] - before[key]
        scale = np.abs(jdelta).max()
        assert scale > 0, key
        assert np.abs(delta - jdelta).max() <= UPDATE_RTOL * scale, key


@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_siamese_update_at_float64_matches_optax(siamese_states, name):
    s = siamese_states[name]
    model, optimizer, *_ = _port_restore(s["path"], name, torch.float64)
    bs = siamese_states["init"]["batch_stats"]
    grads = _grads(s["params"], 10)
    before = ji.siamese_to_torch({"params": s["params"], "batch_stats": bs})
    want = ji.siamese_to_torch({"params": _jax_update64(
        jopt.make_optimizer(name, LR, WD), s["opt_state"], s["params"],
        grads), "batch_stats": bs})
    got = _port_step64(model, optimizer, ji.siamese_to_torch, grads, bs)
    _assert_update_matches(got, want, before,
                           dict(model.named_parameters()))


@pytest.mark.parametrize("which", ["generator", "discriminator"])
def test_gan_update_at_float64_matches_optax(which):
    """The committed JAX GAN state (tools/make_gan_resume_fixture.py)."""
    path = os.path.join(GAN_FIXTURE, f"last_{which}.msgpack")
    tree = ti.variables_from_msgpack(path)
    tx = jopt.make_optimizer("adam", 1e-4, b1=0.5)
    opt_state = serialization.from_state_dict(tx.init(tree["params"]),
                                              tree["opt_state"])
    if which == "generator":
        model = UNetGenerator(num_downs=GAN_ARCH["num_downs"],
                              ngf=GAN_ARCH["ngf"])
        to_torch = ji.generator_to_torch
    else:
        model = NLayerDiscriminator(6, ndf=GAN_ARCH["ndf"],
                                    n_layers=GAN_ARCH["n_layers"])
        to_torch = ji.discriminator_to_torch
    model = model.double()
    optimizer = topt.make_optimizer("adam", model.parameters(), 1e-4, b1=0.5)
    epoch = tck.restore_gan_state_from_jax(path, model, optimizer)
    assert epoch == 1 and int(opt_state.count) > 0
    bs = tree["batch_stats"]
    adam = opt_state.inner_state[1]
    mu = to_torch({"params": adam.mu, "batch_stats": bs})
    for key, p in model.named_parameters():
        np.testing.assert_array_equal(
            optimizer.state[p]["exp_avg"].numpy(),
            np.asarray(mu[key], np.float64), err_msg=key)
        assert float(optimizer.state[p]["step"]) == int(adam.count)
    grads = _grads(tree["params"], 11)
    before = to_torch({"params": tree["params"], "batch_stats": bs})
    want = to_torch({"params": _jax_update64(tx, opt_state, tree["params"],
                                             grads), "batch_stats": bs})
    got = _port_step64(model, optimizer, to_torch, grads, bs)
    _assert_update_matches(got, want, before,
                           dict(model.named_parameters()))


# -- the CLI resumes as the JAX package does ---------------------------------


def _bn_sizes(model):
    """N = B*H*W at each BatchNorm's input in a batch-BS forward."""
    sizes, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            hooks.append(m.register_forward_pre_hook(
                lambda m, i, name=name: sizes.__setitem__(
                    name, i[0].shape[0] * i[0].shape[2] * i[0].shape[3])))
    x = torch.zeros(BS, 3, *SIZE)
    with torch.no_grad():
        model.eval()(x, x)
    for h in hooks:
        h.remove()
    return sizes


def test_cli_resume_matches_jax_resuming_the_same_file(siamese_states,
                                                       oscd_tree):
    """One resumed epoch (epoch 5) of the adamw state at float32, batch 2,
    through the port's CLI and the JAX pipeline, each from its own link
    to the one file."""
    root = str(oscd_tree)
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = os.path.join(siamese_states["root"], "cli_" + side)
        os.makedirs(dirs[side])
        os.link(siamese_states["adamw"]["path"],
                os.path.join(dirs[side], "last_state.msgpack"))
    common = dict(batch_size=BS, num_epochs=EPOCH + 1, save_every=100,
                  compute_dtype="float32", resume=True)
    want = jp.run_siamese_training(
        jcfg.DataConfig(root_dir=root, target_size=SIZE),
        jcfg.SiameseTrainConfig(data_parallel=False,
                                checkpoint_dir=dirs["jax"], **common),
        verbose=False)
    got = train_cli.main([
        "--root-dir", root, "--device", "cpu", "--resume",
        "--num-epochs", str(EPOCH + 1), "--batch-size", str(BS),
        "--target-size", "32x32", "--compute-dtype", "float32",
        "--save-every", "100", "--checkpoint-dir", dirs["port"]])
    assert len(got["train_loss"]) == len(want["train_loss"]) == 1
    assert got["train_loss"][0] == pytest.approx(want["train_loss"][0],
                                                 rel=RESUME_RTOL)
    # ROADMAP C1: torch's running_var moved N/(N-1) times flax's each
    # update.  Take the factor out and validate again.
    model = got["trainer"].model
    start = ti.siamese_state_dict_from_jax(siamese_states["init"])
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    steps = -(-4 // BS)  # oscd_tree's 4 train pairs
    for name, n in _bn_sizes(model).items():
        k = 2 * steps if name.startswith(("dconv_down", "bottleneck")) \
            else steps
        var, decay = name + ".running_var", BN_MOMENTUM ** k
        sd[var] = decay * start[var] + (n - 1) / n * (
            sd[var] - decay * start[var])
    trainer = SiameseTrainer(SiameseTrainConfig(batch_size=BS,
                                                compute_dtype="float32"),
                             "cpu")
    trainer.model.load_state_dict(sd)
    val = build_cached_dataset(create_sample_lists(
        root, SUBDIR, mode="val", verbose=False), SIZE, verbose=False)
    val_loss = trainer.validate(DeviceCache.from_dataset(val, "cpu"))
    assert val_loss == pytest.approx(want["val_loss"][0], rel=RESUME_RTOL)
    assert got["val_loss"][0] == pytest.approx(want["val_loss"][0],
                                               rel=1e-2)
    assert got["best_val_loss"] == min(min(VAL_SERIES), got["val_loss"][0])
    state = torch.load(os.path.join(dirs["port"], "last_state.pth"),
                       weights_only=True)
    assert state["epoch"] == EPOCH + 1
    assert all(float(s["step"]) == 1 + steps
               for s in state["optimizer"]["state"].values())


# -- the optax layouts of the JAX package's optimizer knobs ------------------

# The knobs' flags on the port's CLI, by the case's layout name.
LAYOUT_FLAGS = {"--flat-opt-state": ["--flat-opt-state"],
                "--momentum-dtype bfloat16": ["--momentum-dtype", "bfloat16"],
                "--grad-accum > 1": ["--grad-accum", "2"]}


@pytest.mark.parametrize("layout,knobs,message", [
    ("flat", dict(flat_state=True), "--flat-opt-state"),
    ("bf16", dict(mu_dtype="bfloat16"), "--momentum-dtype bfloat16"),
    ("accum", dict(grad_accum=2), "--grad-accum > 1"),
    ("adam", dict(), "no adamw state"),
])
def test_cli_resume_unported_layout_exits_2(layout, knobs, message,
                                            siamese_states, oscd_tree,
                                            tmp_path, capsys):
    """The layouts of the knobs, once not ported, now resume: a full-width
    state written after one optax step (MultiSteps: one mini-step of two,
    the accumulation half full) and ``train --resume`` with the knob's
    flag continue for one epoch (2 steps), the resume file of that epoch
    in the knob's layout.  An adam state under the adamw default still
    exits 2 naming it (a small state: the check comes before the weights
    are read)."""
    name = "adam" if layout == "adam" else "adamw"
    ckpt = tmp_path / "ckpt"
    path = str(ckpt / "last_state.msgpack")
    if layout == "adam":
        params = {"w": np.ones((2, 3), np.float32)}
        tx = jopt.make_optimizer(name, LR, WD, **knobs)
        jck.save_checkpoint(path, SimpleNamespace(
            params=params, batch_stats={}, opt_state=tx.init(params),
            step=0), extra={"epoch": 1})
    else:
        _write_state(path, jopt.make_optimizer(name, LR, WD, **knobs),
                     siamese_states["init"], siamese_states["extra"], 12)
    argv = ["--root-dir", str(oscd_tree), "--device", "cpu", "--resume",
            "--target-size", "32x32", "--checkpoint-dir", str(ckpt),
            "--batch-size", str(BS), "--compute-dtype", "float32",
            "--num-epochs", str(EPOCH + 1), "--save-every", "100"]
    if layout == "adam":
        with pytest.raises(SystemExit) as exc:
            train_cli.main(argv)
        assert exc.value.code == 2
        assert message in capsys.readouterr().err
        return
    history = train_cli.main(argv + LAYOUT_FLAGS[message])
    assert "Resumed from" in capsys.readouterr().out
    assert len(history["train_loss"]) == 1
    assert np.isfinite(history["train_loss"] + history["val_loss"]).all()
    os.remove(path)
    state = torch.load(str(ckpt / "last_state.pth"), weights_only=True)
    assert state["epoch"] == EPOCH + 1
    opt = state["optimizer"]
    assert opt["layout"] == {"mu_dtype": knobs.get("mu_dtype", "float32"),
                             "flat": layout == "flat",
                             "multi_steps": layout == "accum",
                             "grad_accum": knobs.get("grad_accum", 1)}
    # 1 JAX step, then 2: 3 Adam steps; MultiSteps at k 2 from 1 held
    # gradient: one update, one gradient held again.
    assert (opt["count"], opt["mini_step"]) == (
        (1, 1) if layout == "accum" else (3, 0))
    shutil.rmtree(ckpt)  # about 0.7 GB of full-width files
