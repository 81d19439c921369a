"""The port's Siamese training slice against the JAX package's on the
CPU: optimizers against optax, the plateau scheduler and early stopping
against the JAX classes, the train-mode forward and backward at float64,
and a float32 lockstep of the two trainers from one JAX init on
``oscd_tree`` (2 epochs at 32x32, batch 2); then the train CLI, its resume
file, and the JAX ``run_evaluation`` on the port's ``best_model.pth``.

Why float64 first: in float32 the SiameseUNet's gradients are
ill-conditioned at these sizes (BatchNorm over a few pixels, attention
gates): either framework's float32 gradients differ from its own float64
ones by about 1e-3 of their largest magnitude (median over layers), and
the two frameworks' by the same amount.  At float64 the port's gradients,
loss and BatchNorm statistics equal JAX's to 1e-6, the precision of the
JAX upsample's interpolation weights, which it keeps in float32
(gan_aug_pfa_tpu/ops/resize.py:47, :113).

Tolerances of the float32 lockstep, and why:
  * per-epoch train losses within 1e-3 relative in epoch 1 and 2e-2 in
    epoch 2: the gradient differences above, through Adam, whose update
    m/(sqrt(v)+eps) normalizes each gradient element by its own history;
  * parameters within 2 * lr * steps: Adam moves a parameter by up to lr
    per step whatever its gradient's size, so one whose gradient is
    rounding noise (the conv biases before train-mode BatchNorm have a
    gradient of exactly 0) may move in opposite directions;
  * BatchNorm running_var follows torch's unbiased update, N/(N-1) times
    flax's biased one (ROADMAP C1):
    (rv_torch - m^K rv0) = N/(N-1) (rv_flax - m^K rv0) per layer, with K
    its updates and N = B*H*W at its input;
  * the validation loss on the SAME variables within 1e-5 relative.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gan_aug_pfa_torch import checkpoint as tck
from gan_aug_pfa_torch import interop as ti
from gan_aug_pfa_torch import pipelines as tp
from gan_aug_pfa_torch.config import DataConfig, EvalConfig, SiameseTrainConfig
from gan_aug_pfa_torch.data.loader import build_cached_dataset
from gan_aug_pfa_torch.data.scanner import create_sample_lists
from gan_aug_pfa_torch.models import SiameseUNet
from gan_aug_pfa_torch.train import __main__ as train_cli
from gan_aug_pfa_torch.train import optim as topt
from gan_aug_pfa_torch.train import plateau as tpl
from gan_aug_pfa_torch.train.siamese import SiameseTrainer, predict
from gan_aug_pfa_tpu import config as jcfg
from gan_aug_pfa_tpu import pipelines as jp
from gan_aug_pfa_tpu.data import build_cached_dataset as jax_build_cache
from gan_aug_pfa_tpu.data import create_sample_lists as jax_scan
from gan_aug_pfa_tpu.train import optim as jopt
from gan_aug_pfa_tpu.train import plateau as jpl
from gan_aug_pfa_tpu.train.siamese import SiameseTrainer as JaxTrainer
from gan_aug_pfa_tpu.train.siamese import TrainState
from torch_port_helpers import jax_siamese_variables
from torch_tmp import drop_tmp_path, dropped  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBDIR = "Onera Satellite Change Detection Dataset"
SIZE = (32, 32)
BS = 2
EPOCHS = 2
SEED = 0
# This init spreads the logits over a few units, so that no probability
# of the trained model lies near the 0.5 threshold (test_torch_eval.py).
INIT_SEED = 1
HEAD_SCALE = 10.0
BN_MOMENTUM = 0.9  # flax momentum; torch's 0.1


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs six test processes on the host's cores at once; two
    threads for this file's CPU work keep them from oversubscribing the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- optimizers, scheduler, early stopping ------------------------------


@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_optimizer_matches_optax_with_lr_change(name):
    """5 steps on the same gradients, the learning rate cut after step 2
    through set_learning_rate on both sides."""
    rng = np.random.RandomState(4)
    params = {"w": rng.randn(3, 4).astype(np.float32),
              "b": rng.randn(4).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in
              params.items()} for _ in range(5)]
    grads[1]["b"][:2] = 0.0  # zero gradients still decay the weights
    lr, wd = 1e-3, 1e-2
    tx = jopt.make_optimizer(name, lr, wd)
    jparams = {k: jax.numpy.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    update = jax.jit(tx.update)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt = topt.make_optimizer(name, tparams.values(), lr, wd)
    for step, g in enumerate(grads):
        if step == 2:
            state = jopt.set_learning_rate(state, lr * 0.2)
            topt.set_learning_rate(opt, lr * 0.2)
        upd, state = update({k: jax.numpy.asarray(v) for k, v in g.items()},
                            state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, upd)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in params:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-7)
    assert topt.get_learning_rate(opt) == pytest.approx(
        jopt.get_learning_rate(state), rel=1e-7)


def test_plateau_and_early_stop_match_jax():
    """A scripted validation-loss series with an improvement, plateaus
    long enough for two LR cuts, a tiny (sub-threshold) improvement and a
    NaN: the same LR and stop sequences."""
    series = ([1.0, 0.8, 0.79995] + [0.9] * 8 + [0.7] + [0.75] * 9
              + [float("nan")] * 3)
    lr0 = 1e-4
    opt = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(1))], lr=lr0)
    sched = tpl.make_plateau_scheduler(opt, 0.2, 7)
    jsched = jpl.ReduceLROnPlateau(lr0, 0.2, 7)
    stop, jstop = tpl.EarlyStopping(5), jpl.EarlyStopping(5)
    lrs, jlrs, stops, jstops = [], [], [], []
    for v in series:
        sched.step(v)
        lrs.append(topt.get_learning_rate(opt))
        jlrs.append(jsched.step(v))
        stops.append(stop.step(v))
        jstops.append(jstop.step(v))
    np.testing.assert_allclose(lrs, jlrs, rtol=1e-12)
    assert len(set(lrs)) == 3  # two cuts
    assert stops == jstops and any(stops)
    assert stop.state_dict() == jstop.state_dict()


def test_train_epoch_order_and_partial_batch():
    """One permutation per epoch from the epoch generator; full batches
    first, the partial final batch kept; the epoch loss is the mean of the
    per-batch losses."""
    trainer = SiameseTrainer(SiameseTrainConfig(batch_size=2), "cpu")
    seen = []

    def fake_step(cache, idx):
        seen.append(idx.tolist())
        return torch.tensor(float(len(seen)))

    trainer.train_step = fake_step
    cache = tp.DeviceCache(torch.zeros(5, 3, 16, 16), torch.zeros(5, 3, 16, 16),
                           torch.zeros(5, 16, 16))
    rng = np.random.RandomState(SEED)
    assert trainer.train_epoch(cache, rng) == pytest.approx(2.0)
    perm = np.random.RandomState(SEED).permutation(5).tolist()
    assert seen == [perm[0:2], perm[2:4], perm[4:5]]


def test_epoch_loop_checkpoints_and_early_stop(oscd_tree, tmp_path,
                                               monkeypatch):
    """The epoch loop on a scripted validation series (the JAX package's
    pipelines.py:236-392): best_model.pth on a strict improvement,
    model_epoch_N.pth and last_state.pth on the save_every cadence, and
    last_state.pth again when early stopping ends the run."""
    val = iter([0.5, 0.4, 0.4, 0.45, 0.3, 0.2])
    saved = []
    monkeypatch.setattr(SiameseTrainer, "train_epoch",
                        lambda self, cache, rng, epoch=None: 1.0)
    monkeypatch.setattr(SiameseTrainer, "validate",
                        lambda self, cache: next(val))
    save = tck.save

    def recorded(path, payload):
        saved.append(os.path.basename(path))
        save(path, payload)

    monkeypatch.setattr(tck, "save", recorded)
    ckpt_dir = str(tmp_path / "ckpt")
    hist = tp.run_siamese_training(
        DataConfig(root_dir=str(oscd_tree), target_size=(16, 16)),
        SiameseTrainConfig(num_epochs=6, save_every=2, early_stop_patience=2,
                           checkpoint_dir=ckpt_dir),
        verbose=False, device="cpu")
    assert hist["val_loss"] == [0.5, 0.4, 0.4, 0.45]  # stopped at epoch 4
    assert hist["best_val_loss"] == 0.4
    assert saved == ["best_model.pth", "best_model.pth", "model_epoch_2.pth",
                     "last_state.pth", "model_epoch_4.pth", "last_state.pth"]
    state = torch.load(os.path.join(ckpt_dir, "last_state.pth"),
                       weights_only=True)
    assert state["epoch"] == 4 and state["best_val_loss"] == 0.4
    assert state["early_stop"] == {"best": 0.4, "num_bad_epochs": 2}


# -- the train-mode forward and backward at float64 ------------------------


def test_train_forward_backward_matches_jax_at_float64():
    """One train-mode forward and backward of the full-width model from
    one JAX init, at float64 on both sides, against a fixed linear
    functional of the logits: equal loss and gradients; running_mean
    equal and running_var under the N/(N-1) relation after the one
    update (two in the encoder)."""
    from gan_aug_pfa_tpu.models.siamese_unet import SiameseUNet as JaxModel

    init = jax_siamese_variables(seed=INIT_SEED, size=SIZE[0],
                                 head_scale=HEAD_SCALE)
    rng = np.random.RandomState(2)
    x1, x2 = (rng.rand(BS, *SIZE, 3) * 2 - 1 for _ in range(2))
    w = rng.randn(BS, *SIZE, 1)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jax.numpy.asarray(a, np.float64), init)
        model = JaxModel(3, 1, dtype=np.float64)

        def loss(params):
            out, upd = model.apply(
                {"params": params, "batch_stats": v64["batch_stats"]},
                x1, x2, train=True, mutable=["batch_stats"])
            return (out * w).sum(), upd

        (want_loss, upd), grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(v64["params"])
        want_loss = float(want_loss)
        want_grads = ti.siamese_state_dict_from_jax(
            {"params": jax.tree.map(np.asarray, grads),
             "batch_stats": init["batch_stats"]}, dtype=np.float64)
        want_stats = ti.siamese_state_dict_from_jax(
            {"params": init["params"],
             "batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])},
            dtype=np.float64)
    port = SiameseUNet()
    port.load_state_dict(ti.siamese_state_dict_from_jax(init))
    port.double().train()
    start = {k: v.clone() for k, v in port.state_dict().items()}
    out = port(*(torch.from_numpy(x).permute(0, 3, 1, 2) for x in (x1, x2)))
    got_loss = (out * torch.from_numpy(w).permute(0, 3, 1, 2)).sum()
    got_loss.backward()
    assert float(got_loss) == pytest.approx(want_loss, rel=1e-6)
    biggest = max(float(want_grads[k].abs().max())
                  for k, _ in port.named_parameters())
    for name, p in port.named_parameters():
        # Conv biases before train-mode BatchNorm have a gradient of 0,
        # which leaves only rounding noise to compare.
        np.testing.assert_allclose(p.grad, want_grads[name], rtol=0,
                                   atol=1e-6 * biggest, err_msg=name)
    got = port.state_dict()
    for name, n in _bn_sizes(port).items():
        k = int(got[name + ".num_batches_tracked"])
        decay = BN_MOMENTUM ** k
        mean, var = name + ".running_mean", name + ".running_var"
        np.testing.assert_allclose(got[mean], want_stats[mean], rtol=1e-6,
                                   atol=1e-9, err_msg=mean)
        np.testing.assert_allclose(
            got[var] - decay * start[var],
            n / (n - 1) * (want_stats[var] - decay * start[var]),
            rtol=1e-6, atol=1e-9, err_msg=var)


# -- the lockstep --------------------------------------------------------


def _jax_run(root, init):
    """The JAX trainer at fp32 without a mesh, from ``init``, through the
    JAX pipeline's epoch loop (pipelines.py:236-253)."""
    cfg = jcfg.SiameseTrainConfig(batch_size=BS, num_epochs=EPOCHS,
                                  compute_dtype="float32",
                                  data_parallel=False, seed=SEED)
    trainer = JaxTrainer(cfg)
    state = jax.jit(lambda v: TrainState.create(
        apply_fn=trainer.model.apply, params=v["params"], tx=trainer.tx,
        batch_stats=v["batch_stats"]))(init)
    train_ds, val_ds = (
        jax_build_cache(jax_scan(root, SUBDIR, "synthetic_data", mode=mode,
                                 verbose=False), SIZE, verbose=False)
        for mode in ("train", "val"))
    dev_train = trainer._device_arrays(train_ds)
    dev_val = trainer._device_arrays(val_ds)
    epoch_rng = np.random.RandomState(SEED)
    rng = jax.random.PRNGKey(SEED)
    history = {"train_loss": [], "val_loss": []}
    for _ in range(EPOCHS):
        rng, erng = jax.random.split(rng)
        state, loss = trainer.train_epoch(state, dev_train, len(train_ds),
                                          erng, epoch_rng)
        history["train_loss"].append(loss)
        history["val_loss"].append(
            trainer.validate(state, dev_val, len(val_ds)))
    final = jax.tree.map(np.asarray, {"params": state.params,
                                      "batch_stats": state.batch_stats})
    return history, final, len(train_ds)


@pytest.fixture(scope="module")
def lockstep(oscd_tree, tmp_path_factory):
    root = str(oscd_tree)
    work = tmp_path_factory.mktemp("torch_train")
    ckpt_dir = str(work / "ckpt")
    init = jax_siamese_variables(seed=INIT_SEED, size=SIZE[0],
                                 head_scale=HEAD_SCALE)
    jax_hist, jax_final, n_train = _jax_run(root, init)
    port_hist = tp.run_siamese_training(
        DataConfig(root_dir=root, target_size=SIZE),
        SiameseTrainConfig(batch_size=BS, num_epochs=EPOCHS,
                           compute_dtype="float32", seed=SEED,
                           checkpoint_dir=ckpt_dir, save_every=1),
        verbose=False, device="cpu",
        initial_state_dict=ti.siamese_state_dict_from_jax(init))
    with dropped(work):
        yield {"root": root, "ckpt_dir": ckpt_dir, "init": init,
               "jax": jax_hist, "jax_final": jax_final, "port": port_hist,
               "steps": EPOCHS * -(-n_train // BS)}


def test_lockstep_train_losses_match_jax(lockstep):
    got, want = lockstep["port"]["train_loss"], lockstep["jax"]["train_loss"]
    assert len(got) == len(want) == EPOCHS
    for g, w, rtol in zip(got, want, (1e-3, 2e-2)):
        assert g == pytest.approx(w, rel=rtol)
    assert got[1] < got[0]  # it learns


def test_lockstep_parameters_within_adam_noise_bound(lockstep):
    cfg = SiameseTrainConfig()
    bound = 2 * cfg.learning_rate * lockstep["steps"]
    want = ti.siamese_state_dict_from_jax(lockstep["jax_final"])
    start = ti.siamese_state_dict_from_jax(lockstep["init"])
    got = lockstep["port"]["trainer"].model.state_dict()
    params = dict(lockstep["port"]["trainer"].model.named_parameters())
    diffs = torch.cat([(got[k] - want[k]).abs().flatten() for k in params])
    moved = torch.cat([(want[k] - start[k]).abs().flatten()
                       for k in params])
    assert float(diffs.max()) <= bound
    # Most parameters agree far better than the bound.
    assert float(diffs.median()) < 0.1 * float(moved.median())


def _bn_sizes(model):
    """N = B*H*W at each BatchNorm's input in a batch-BS forward."""
    sizes, hooks = {}, []

    def record(name, inputs):
        b, _, h, w = inputs[0].shape
        sizes[name] = b * h * w

    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            hooks.append(m.register_forward_pre_hook(
                lambda m, i, name=name: record(name, i)))
    x = torch.zeros(BS, 3, *SIZE, dtype=next(model.parameters()).dtype)
    training = model.training
    with torch.no_grad():
        model.eval()(x, x)
    model.train(training)
    for h in hooks:
        h.remove()
    return sizes


def test_lockstep_batchnorm_statistics(lockstep):
    """After 4 float32 steps the two models' activations have drifted
    apart, most where BatchNorm sees few pixels: running_mean within 5e-2
    (measured 2.7e-2) and running_var within 25% of the N/(N-1) relation
    (measured up to 20%, at the 2x2 bottleneck).  In every encoder layer
    the relation fits better with the N/(N-1) factor than without it.
    The exact check is the float64 test above."""
    model = lockstep["port"]["trainer"].model
    got = model.state_dict()
    want = ti.siamese_state_dict_from_jax(lockstep["jax_final"])
    start = ti.siamese_state_dict_from_jax(lockstep["init"])
    steps = lockstep["steps"]
    for name, n in _bn_sizes(model).items():
        k = int(got[name + ".num_batches_tracked"])
        encoder = name.startswith(("dconv_down", "bottleneck"))
        assert k == (2 * steps if encoder else steps), name
        decay = BN_MOMENTUM ** k
        mean, var = name + ".running_mean", name + ".running_var"
        np.testing.assert_allclose(got[mean], want[mean], rtol=0,
                                   atol=5e-2, err_msg=mean)
        lhs = got[var] - decay * start[var]
        flax_step = want[var] - decay * start[var]
        np.testing.assert_allclose(lhs, n / (n - 1) * flax_step, rtol=0.25,
                                   err_msg=var)
        if encoder:
            with_factor = float((lhs - n / (n - 1) * flax_step).abs().sum())
            assert with_factor < float((lhs - flax_step).abs().sum()), var


def test_lockstep_val_loss_on_same_variables(lockstep):
    """The port's validation loss with the JAX trainer's final variables
    loaded equals the JAX trainer's last validation loss."""
    trainer = SiameseTrainer(SiameseTrainConfig(batch_size=BS,
                                                compute_dtype="float32"),
                             "cpu")
    trainer.model.load_state_dict(
        ti.siamese_state_dict_from_jax(lockstep["jax_final"]))
    ds = build_cached_dataset(
        create_sample_lists(lockstep["root"], SUBDIR, mode="val",
                               verbose=False), SIZE, verbose=False)
    got = trainer.validate(tp.DeviceCache.from_dataset(ds, "cpu"))
    want = lockstep["jax"]["val_loss"][-1]
    assert got == pytest.approx(want, rel=1e-5)
    # With running statistics of its own (ROADMAP C1) the port's
    # validation loss differs a little.
    assert lockstep["port"]["val_loss"][-1] == pytest.approx(want, rel=1e-2)


def test_running_var_semantics_effect_on_val_loss(lockstep):
    """ROADMAP C1 in numbers: the JAX trainer's final variables with each
    running_var rebuilt as torch's update would have left it,
    m^K rv0 + N/(N-1) (rv_flax - m^K rv0), give the validation loss that
    the JAX one would have had under torch's semantics.  The gap is
    printed (``-s``) and stays below 1e-2 relative."""
    final = ti.siamese_state_dict_from_jax(lockstep["jax_final"])
    start = ti.siamese_state_dict_from_jax(lockstep["init"])
    trainer = SiameseTrainer(SiameseTrainConfig(batch_size=BS,
                                                compute_dtype="float32"),
                             "cpu")
    steps = lockstep["steps"]
    ratios = {}
    for name, n in _bn_sizes(trainer.model).items():
        k = 2 * steps if name.startswith(("dconv_down", "bottleneck")) \
            else steps
        var = name + ".running_var"
        decay = BN_MOMENTUM ** k
        final[var] = decay * start[var] + n / (n - 1) * (
            final[var] - decay * start[var])
        ratios[name] = n / (n - 1)
    trainer.model.load_state_dict(final)
    ds = build_cached_dataset(
        create_sample_lists(lockstep["root"], SUBDIR, mode="val",
                            verbose=False), SIZE, verbose=False)
    got = trainer.validate(tp.DeviceCache.from_dataset(ds, "cpu"))
    want = lockstep["jax"]["val_loss"][-1]
    gap = (got - want) / want
    print(json.dumps({"c1_val_loss_flax": want, "c1_val_loss_torch_var": got,
                      "c1_relative_gap": gap,
                      "largest_var_factor": max(ratios.values()),
                      "port_own_val_loss": lockstep["port"]["val_loss"][-1]}))
    assert abs(gap) < 1e-2


def test_last_state_restores_model_optimizer_and_schedule(lockstep):
    trained = lockstep["port"]["trainer"]
    trainer = SiameseTrainer(SiameseTrainConfig(batch_size=BS), "cpu")
    sched = tpl.make_plateau_scheduler(trainer.optimizer)
    stop = tpl.EarlyStopping(3)
    extra = tck.restore_train_state(
        os.path.join(lockstep["ckpt_dir"], "last_state.pth"), trainer.model,
        trainer.optimizer, sched, stop)
    assert extra == {"epoch": EPOCHS,
                     "best_val_loss": lockstep["port"]["best_val_loss"]}
    for (name, a), b in zip(trained.model.state_dict().items(),
                            trainer.model.state_dict().values()):
        assert torch.equal(a, b), name
    got, want = trainer.optimizer.state_dict(), trained.optimizer.state_dict()
    for key, s in want["state"].items():
        for field, v in s.items():
            assert torch.equal(got["state"][key][field], v)
    assert sched.best == min(lockstep["port"]["val_loss"])


def test_jax_evaluation_of_port_checkpoint_matches_port(lockstep, tmp_path):
    """The JAX package's run_evaluation loads the port's best_model.pth and
    reports the port's metrics within 1e-6."""
    root = lockstep["root"]
    pth = os.path.join(lockstep["ckpt_dir"], "best_model.pth")
    model = tck.restore_model_only(
        pth, SiameseUNet(batched_encoder=True))
    ds = build_cached_dataset(
        create_sample_lists(root, SUBDIR, mode="all", verbose=False),
        SIZE, verbose=False)
    probs = predict(model, torch.from_numpy(ds.img1),
                       torch.from_numpy(ds.img2), "float32")
    # No pixel close enough to the threshold to flip between frameworks.
    assert float((probs - 0.5).abs().min()) > 1e-5
    want = jp.run_evaluation(
        jcfg.DataConfig(root_dir=root),
        jcfg.EvalConfig(target_size=SIZE, checkpoint_path=pth,
                        output_dir=str(tmp_path / "jax"),
                        num_visualizations=0, compute_dtype="float32"),
        verbose=False)
    got = tp.run_evaluation(
        DataConfig(root_dir=root),
        EvalConfig(target_size=SIZE, checkpoint_path=pth,
                   output_dir=str(tmp_path / "port"),
                   compute_dtype="float32"),
        verbose=False, device="cpu")
    assert got["overall"] == pytest.approx(want["overall"], rel=0, abs=1e-6)
    assert got["per_city_counts"] == want["per_city_counts"]
    for city, m in want["per_city"].items():
        assert got["per_city"][city] == pytest.approx(m, rel=0, abs=1e-6)


# -- the CLI --------------------------------------------------------------


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "gan_aug_pfa_torch.train", *args],
        capture_output=True, text=True, timeout=300, cwd=REPO)


def test_cli_trains_saves_and_resumes(oscd_tree, tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    common = ["--root-dir", str(oscd_tree), "--device", "cpu",
              "--target-size", "32x32", "--batch-size", "2",
              "--compute-dtype", "float32", "--checkpoint-dir", ckpt_dir,
              "--save-every", "1", "--fused-loss"]
    proc = _cli(*common, "--num-epochs", "2")
    assert proc.returncode == 0, proc.stderr
    assert sorted(os.listdir(ckpt_dir)) == [
        "best_model.pth", "last_state.pth", "model_epoch_1.pth",
        "model_epoch_2.pth"]
    best = torch.load(os.path.join(ckpt_dir, "best_model.pth"),
                      weights_only=True)
    assert "conv_last.weight" in best  # a bare reference state_dict

    proc = _cli(*common, "--num-epochs", "3", "--resume")
    assert proc.returncode == 0, proc.stderr
    assert "Resumed from" in proc.stdout and "Epoch 3/3" in proc.stdout
    assert "Epoch 1/3" not in proc.stdout
    state = torch.load(os.path.join(ckpt_dir, "last_state.pth"),
                       weights_only=True)
    assert state["epoch"] == 3
    # 4 train samples at batch 2: 2 optimizer steps an epoch.
    assert all(float(s["step"]) == 6
               for s in state["optimizer"]["state"].values())


@pytest.mark.parametrize("flags", [["--grad-accum", "2"], ["--remat"],
                                   ["--stream", "host", "--batched-encoder"],
                                   ["--concat-free", "--log-jsonl",
                                    "run.jsonl"]])
def test_cli_rejects_flags_not_ported(flags, oscd_tree, tmp_path,
                                      monkeypatch):
    """The JAX package's training knobs, once not ported, now run: one
    epoch with each, beside ``--stream`` and the run log."""
    monkeypatch.chdir(tmp_path)
    history = train_cli.main([
        "--root-dir", str(oscd_tree), "--device", "cpu", "--target-size",
        "32x32", "--batch-size", "2", "--compute-dtype", "float32",
        "--num-epochs", "1", "--checkpoint-dir", str(tmp_path / "ckpt"),
        *flags])
    losses = history["train_loss"] + history["val_loss"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    trainer = history["trainer"]
    knobs = {"--grad-accum": trainer.optimizer.grad_accum
             if isinstance(trainer.optimizer, topt.OptaxAdam) else 1,
             "--remat": trainer.model.dconv_down1.remat,
             "--batched-encoder": trainer.model.batched_encoder,
             "--concat-free": trainer.model.concat_free}
    for flag in flags:
        if flag in knobs:
            assert knobs[flag] in (True, 2), flag
    if "--log-jsonl" in flags:
        assert (tmp_path / "run.jsonl").exists()
    shutil.rmtree(tmp_path / "ckpt")  # about 0.7 GB of full-width files


@pytest.mark.parametrize("flag", ["--pallas-augment", "--no-pallas-augment"])
def test_cli_accepts_pallas_augment_flags(flag, tmp_path, capsys):
    """Accepted for the JAX package's command lines: on an empty root the
    run parses, finds no train split and returns None."""
    assert train_cli.main(["--root-dir", str(tmp_path), "--device", "cpu",
                           "--augment", flag]) is None
    out = capsys.readouterr()
    assert "not ported yet" not in out.err
    assert "Training dataset is empty" in out.out


def test_cli_default_device_is_cuda_and_never_falls_back(oscd_tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--root-dir", str(oscd_tree), "--num-epochs", "1"])
