"""The port's optimizer knobs (``gan_aug_pfa_torch/train/optim.py``)
against optax and the JAX package's ``make_optimizer`` on the CPU, then
the JAX package's state layouts read into the port:

  * ``--momentum-dtype bfloat16``: 6 steps on a small seeded tree, the
    learning rate cut after step 3: the float32 parameters within 1e-6
    relative of optax's (atol 1e-9 for the few near 0) and the bfloat16
    first moments equal bit for bit, adamw and adam (weight decay on);
  * ``--flat-opt-state``: the same against ``optax.flatten``, and at
    float64 against the port's default optimizer within 1e-6 relative;
    ``"float32"`` momentum is the default optimizer;
  * ``--grad-accum`` 2 and 3: 7 mini-steps (a count that k does not
    divide, at least 2 applied updates) against ``optax.MultiSteps``: the
    parameters after each, the accumulator, ``mini_step``,
    ``gradient_step`` and the Adam count; the mini-steps between updates
    leave the parameters bit for bit; ``mini_step`` carries across an
    epoch boundary of the Siamese trainer, whose BatchNorm statistics
    update at every mini-step;
  * each JAX layout (MultiSteps mid-accumulation, flattened, bfloat16, and
    all three at once) written by the JAX package's ``save_checkpoint``
    for the generator of tests/data/jax_gan_state_nd5_ngf4,
    restored by ``checkpoint.restore_gan_state_from_jax``: moments,
    accumulator and counters mapped exactly, then one update at float64
    within 1e-6 of optax updating the same state; a state in another
    layout than the run's flags raises ``ResumeLayoutError`` naming both,
    the JAX package's and the port's own;
  * the port's ``last_state.pth`` written in the middle of an
    accumulation resumes to the same numbers as the run it was taken
    from, and ``python -m gan_aug_pfa_torch.train --resume`` continues it.
"""

import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from gan_aug_pfa_torch import checkpoint as tck
from gan_aug_pfa_torch import interop as ti
from gan_aug_pfa_torch.config import SiameseTrainConfig
from gan_aug_pfa_torch.data.loader import build_cached_dataset
from gan_aug_pfa_torch.data.scanner import create_sample_lists
from gan_aug_pfa_torch.models import UNetGenerator
from gan_aug_pfa_torch.pipelines import DeviceCache
from gan_aug_pfa_torch.train import __main__ as train_cli
from gan_aug_pfa_torch.train import optim as topt
from gan_aug_pfa_torch.train.siamese import SiameseTrainer
from gan_aug_pfa_tpu import checkpoint as jck
from gan_aug_pfa_tpu.train import optim as jopt
from torch_tmp import drop_tmp_path  # noqa: F401

LR, WD = 1e-3, 1e-2
RTOL = 1e-6
SUBDIR = "Onera Satellite Change Detection Dataset"
GAN_ARCH = dict(num_downs=5, ngf=4, ndf=8, n_layers=2)
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "jax_gan_state_nd5_ngf4")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"conv": {"kernel": rng.randn(3, 3, 4, 5).astype(np.float32)},
            "bias": (rng.randn(37) * 0.1).astype(np.float32)}


def _leaves(tree):
    return [tree["bias"], tree["conv"]["kernel"]]  # jax's sorted order


def _grads(tree, rng):
    """Gradients over five decades, as a network's are."""
    return jax.tree.map(lambda p: (rng.randn(*p.shape) * 10.0 ** rng.uniform(
        -4, 1, p.shape)).astype(p.dtype), tree)


def _lockstep(name, knobs, steps, dtype=np.float32, cut_at=3):
    """``steps`` optimizer steps of optax (the JAX package's
    make_optimizer) and the port's on the same gradients, the learning
    rate cut 5x before step ``cut_at``.  Yields (step, optax state, JAX
    params, port optimizer, port params) after each."""
    params = jax.tree.map(lambda a: a.astype(dtype), _tree())
    tx = jopt.make_optimizer(name, LR, WD, **knobs)
    with jax.enable_x64(dtype == np.float64):
        state = tx.init(params)
        update = jax.jit(tx.update)
        tparams = [torch.nn.Parameter(torch.from_numpy(a.copy()))
                   for a in _leaves(params)]
        opt = topt.make_optimizer(name, tparams, LR, WD, **knobs)
        rng = np.random.RandomState(1)
        for step in range(steps):
            if step == cut_at:
                state = jopt.set_learning_rate(state, LR / 5)
                topt.set_learning_rate(opt, LR / 5)
            g = _grads(params, rng)
            upd, state = update(g, state, params)
            params = jax.tree.map(lambda p, u: np.asarray(p + u), params, upd)
            for p, gl in zip(tparams, _leaves(g)):
                p.grad = torch.from_numpy(gl)
            opt.step()
            yield step, state, params, opt, tparams


def _assert_close(tparams, params, rtol=RTOL, atol=1e-9):
    for p, want in zip(tparams, _leaves(params)):
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=rtol,
                                   atol=atol)


def _adam(name, opt_state):
    return opt_state.inner_state[{"adamw": 0, "adam": 1}[name]]


@pytest.mark.parametrize("name", ["adamw", "adam"])
@pytest.mark.parametrize("flat", [False, True], ids=["tree", "flat"])
def test_bf16_momentum_matches_optax(name, flat):
    knobs = dict(mu_dtype="bfloat16", flat_state=flat)
    for step, state, params, opt, tparams in _lockstep(name, knobs, 6):
        _assert_close(tparams, params)
        mu = _adam(name, state).mu
        want = (np.asarray(mu.astype(jnp.float32)) if flat else np.concatenate(
            [np.asarray(m.astype(jnp.float32)).ravel()
             for m in _leaves(mu)]))
        assert opt.exp_avg[0].dtype == torch.bfloat16
        got = torch.cat([m.float().reshape(-1) for m in opt.exp_avg])
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(step))
    assert opt.count == 6 == int(_adam(name, state).count)
    assert topt.get_learning_rate(opt) == pytest.approx(
        jopt.get_learning_rate(state), rel=1e-7)


@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_flat_state_matches_optax_flatten(name):
    for _, state, params, opt, tparams in _lockstep(
            name, dict(flat_state=True), 6):
        _assert_close(tparams, params)
    adam = _adam(name, state)
    assert np.asarray(adam.mu).shape == (37 + 180,)
    assert [t.shape for t in opt.exp_avg + opt.exp_avg_sq] == [(217,)] * 2
    # The parameters are views of the one flat buffer the update runs on.
    flat = opt.flat_param.detach().numpy()
    np.testing.assert_array_equal(flat[37:], tparams[1].detach().numpy()
                                  .ravel())
    assert tparams[1].data_ptr() == opt.flat_param[37:].data_ptr()


@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_flat_state_at_float64_equals_the_default_optimizer(name):
    """The same arithmetic as torch's Adam(W), to 1e-6 relative (rounding
    aside) over 6 steps with a learning-rate cut."""
    params = _tree()
    ps = {k: [torch.nn.Parameter(torch.from_numpy(a.astype(np.float64)))
              for a in _leaves(params)] for k in ("flat", "default")}
    opts = {"flat": topt.make_optimizer(name, ps["flat"], LR, WD,
                                        flat_state=True),
            "default": topt.make_optimizer(name, ps["default"], LR, WD,
                                           mu_dtype="float32")}
    assert isinstance(opts["default"], (torch.optim.Adam, torch.optim.AdamW))
    rng = np.random.RandomState(2)
    for step in range(6):
        g = [torch.from_numpy(x.astype(np.float64))
             for x in _leaves(_grads(params, rng))]
        for k in ps:
            if step == 3:
                topt.set_learning_rate(opts[k], LR / 5)
            for p, gl in zip(ps[k], g):
                p.grad = gl.clone()
            opts[k].step()
        for a, b in zip(ps["flat"], ps["default"]):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), rtol=RTOL,
                                       atol=1e-12)


@pytest.mark.parametrize("name", ["adamw", "adam"])
@pytest.mark.parametrize("k", [2, 3])
def test_multisteps_matches_optax(name, k):
    held = None
    for step, state, params, opt, tparams in _lockstep(
            name, dict(grad_accum=k), 7):
        _assert_close(tparams, params)
        emit = (step + 1) % k == 0
        now = [p.detach().clone() for p in tparams]
        if held is not None and not emit:
            assert all(torch.equal(a, b) for a, b in zip(now, held))
        held = now
        assert (opt.mini_step, opt.gradient_step) == (
            int(state.mini_step), int(state.gradient_step)) == (
            (step + 1) % k, (step + 1) // k)
        assert opt.count == int(_adam(name, state.inner_opt_state).count)
        for a, want in zip(opt.acc, _leaves(state.acc_grads)):
            np.testing.assert_allclose(a.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=0)
    assert opt.gradient_step == 7 // k >= 2


def test_multisteps_carries_mini_step_across_epochs(oscd_tree):
    """The Siamese trainer at k = 3 with 2 steps an epoch (4 train pairs,
    batch 2): no update in epoch 1, whose BatchNorm statistics still move;
    the update lands at epoch 2's first step."""
    ds = build_cached_dataset(create_sample_lists(
        str(oscd_tree), SUBDIR, mode="train", verbose=False), (32, 32),
        verbose=False)
    cache = DeviceCache.from_dataset(ds, "cpu")
    trainer = SiameseTrainer(SiameseTrainConfig(
        batch_size=2, compute_dtype="float32", grad_accum=3), "cpu")
    opt = trainer.optimizer
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    rng = np.random.RandomState(0)
    trainer.train_epoch(cache, rng)
    after = trainer.model.state_dict()
    assert (opt.mini_step, opt.count) == (2, 0)
    for name, p in trainer.model.named_parameters():
        assert torch.equal(p, before[name]), name
    assert int(after["dconv_down1.1.num_batches_tracked"]) == 4
    assert not torch.equal(after["dconv_down1.1.running_mean"],
                           before["dconv_down1.1.running_mean"])
    trainer.train_epoch(cache, rng)
    assert (opt.mini_step, opt.gradient_step, opt.count) == (1, 1, 1)
    assert not torch.equal(trainer.model.conv_last.weight,
                           before["conv_last.weight"])


def test_momentum_float32_and_no_knob_give_torch_optimizers():
    p = [torch.nn.Parameter(torch.zeros(2))]
    for kw in ({}, {"mu_dtype": "float32"}, {"grad_accum": 1},
               {"grad_accum": 0}):
        assert type(topt.make_optimizer("adamw", p, LR, **kw)) is \
            torch.optim.AdamW
    with pytest.raises(ValueError, match="mu_dtype"):
        topt.make_optimizer("adam", p, LR, mu_dtype="float16")


# -- JAX layouts into the port ----------------------------------------------

LAYOUTS = {
    "accum": dict(grad_accum=2),
    "flat": dict(flat_state=True),
    "bf16": dict(mu_dtype="bfloat16"),
    "all": dict(grad_accum=2, flat_state=True, mu_dtype="bfloat16"),
}


@pytest.fixture(scope="module")
def generator_variables():
    """The JAX generator of the committed fixture (one trained epoch)."""
    state = ti.variables_from_msgpack(os.path.join(
        FIXTURE, "last_generator.msgpack"))
    return {k: jax.tree.map(np.array, state[k])
            for k in ("params", "batch_stats")}


def _write_jax_state(path, variables, knobs, steps=3):
    """The JAX generator's Adam state in a knob's layout after ``steps``
    seeded updates (MultiSteps at k 2: mid-accumulation), written as the
    JAX GAN pipeline writes last_generator.msgpack.  Returns the params
    and the optimizer state."""
    tx = jopt.make_optimizer("adam", 1e-4, b1=0.5, **knobs)
    params = variables["params"]
    state = tx.init(params)
    update = jax.jit(tx.update)
    rng = np.random.RandomState(3)
    for _ in range(steps):
        upd, state = update(_grads(params, rng), state, params)
        params = jax.tree.map(lambda p, u: np.asarray(p + u), params, upd)
    jck.save_checkpoint(path, SimpleNamespace(
        params=params, batch_stats=variables["batch_stats"],
        opt_state=state, step=steps), extra={"epoch": 2})
    return tx, params, jax.tree.map(np.asarray, state)


def _port_generator(knobs, dtype=torch.float32):
    model = UNetGenerator(num_downs=GAN_ARCH["num_downs"],
                          ngf=GAN_ARCH["ngf"]).to(dtype)
    opt = topt.make_optimizer("adam", model.parameters(), 1e-4, b1=0.5,
                              **knobs)
    return model, opt


def _by_name(model, tree, batch_stats, dtype=np.float32):
    return ti.state_dict_from_jax(model, {"params": tree,
                                          "batch_stats": batch_stats}, dtype)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_jax_layout_maps_exactly_and_steps_as_optax(layout, tmp_path,
                                                     generator_variables):
    knobs = LAYOUTS[layout]
    path = str(tmp_path / "last_generator.msgpack")
    tx, params, state = _write_jax_state(path, generator_variables, knobs)
    bs = generator_variables["batch_stats"]
    model, opt = _port_generator(knobs)
    assert tck.restore_gan_state_from_jax(path, model, opt) == 2
    multi = state if "grad_accum" in knobs else None
    inner = state.inner_opt_state if multi else state
    adam = _adam("adam", inner)
    names = [n for n, _ in model.named_parameters()]
    flat = knobs.get("flat_state", False)

    def want(tree, dtype=torch.float32):
        if flat and not isinstance(tree, dict):
            tree = ti.unravel_like(tree, params)
        sd = _by_name(model, jax.tree.map(
            lambda a: np.asarray(a, np.float32), tree), bs)
        per = [sd[n].to(dtype) for n in names]
        return [torch.cat([t.reshape(-1) for t in per])] if flat else per

    mu_dtype = torch.bfloat16 if "mu_dtype" in knobs else torch.float32
    for got, exp in ((opt.exp_avg, want(adam.mu, mu_dtype)),
                     (opt.exp_avg_sq, want(adam.nu))):
        assert len(got) == len(exp)
        for g, e in zip(got, exp):
            assert g.dtype == e.dtype
            assert torch.equal(g, e)
    assert opt.count == int(adam.count) > 0
    if multi is not None:
        assert (opt.mini_step, opt.gradient_step) == (
            int(multi.mini_step), int(multi.gradient_step))
        assert opt.mini_step > 0  # the middle of an accumulation
        for g, e in zip(opt.acc, want(multi.acc_grads)):
            assert torch.equal(g, e)
    assert opt.param_groups[0]["lr"] == float(np.float32(1e-4))

    # One update at float64 from the restored state, both sides.
    model64, opt64 = _port_generator(knobs, torch.float64)
    tck.restore_gan_state_from_jax(path, model64, opt64)
    grads = _grads(params, np.random.RandomState(9))
    g_named = _by_name(model64, grads, bs)
    for n, p in model64.named_parameters():
        p.grad = g_named[n].double()
    before = {n: p.detach().clone() for n, p in model64.named_parameters()}
    opt64.step()

    def f64(a):
        a = np.asarray(a)
        return a.astype(np.float64) if a.dtype.kind == "f" else a

    with jax.enable_x64(True):
        s64 = jax.tree.map(
            lambda a: a if a.dtype == jnp.bfloat16 else f64(a),
            jax.tree.map(jnp.asarray, state))
        p64 = jax.tree.map(f64, params)
        upd, _ = jax.jit(tx.update)(jax.tree.map(f64, grads), s64, p64)
        new = jax.tree.map(lambda p, u: np.asarray(p + u), p64, upd)
    new = _by_name(model64, new, bs, np.float64)
    moved = 0.0
    for n, p in model64.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), new[n].numpy(),
                                   rtol=RTOL, atol=1e-12, err_msg=n)
        moved = max(moved, float((p.detach() - before[n]).abs().max()))
    # The update applied (the MultiSteps state was one mini-step short).
    assert moved > 1e-6


def _layout_error(restore, *args):
    with pytest.raises(tck.ResumeLayoutError) as exc:
        restore(*args)
    return str(exc.value)


@pytest.mark.parametrize("saved,run", [("flat", "bf16"), ("accum", "none"),
                                       ("none", "all")])
def test_layouts_that_differ_raise_naming_both(saved, run, tmp_path,
                                               generator_variables):
    path = str(tmp_path / "last_generator.msgpack")
    _write_jax_state(path, generator_variables, LAYOUTS.get(saved, {}), 1)
    model, opt = _port_generator(LAYOUTS.get(run, {}))
    text = _layout_error(tck.restore_gan_state_from_jax, path, model, opt)
    names = {"flat": "flattened (--flat-opt-state)",
             "bf16": "bfloat16 first moments (--momentum-dtype bfloat16)",
             "accum": "optax.MultiSteps (--grad-accum > 1)",
             "none": "per-parameter float32 moments (no knob)",
             "all": "optax.MultiSteps (--grad-accum > 1), flattened "
                    "(--flat-opt-state), bfloat16 first moments "
                    "(--momentum-dtype bfloat16)"}
    assert f"the optimizer state is {names[saved]};" in text
    assert f"this run's flags give {names[run]}" in text
    # The port's own resume file: the same rule.
    model, opt = _port_generator(LAYOUTS.get(saved, {}))
    own = str(tmp_path / "last_generator.pth")
    tck.save(own, tck.gan_state(model, opt, 1))
    model, opt = _port_generator(LAYOUTS.get(run, {}))
    text = _layout_error(tck.restore_gan_state, own, model, opt)
    assert names[saved] in text and names[run] in text


# -- the port's own resume file mid-accumulation -------------------------------


def test_own_state_mid_accumulation_resumes_to_the_same_numbers(
        tmp_path, generator_variables):
    """All three optimizer knobs: the generator's optimizer, saved through
    ``last_generator.pth`` with one gradient of three held, restored into
    a fresh optimizer; both take the same next four mini-steps: equal
    parameters, moments, accumulator and counters, bit for bit."""
    knobs = dict(grad_accum=3, flat_state=True, mu_dtype="bfloat16")
    bs = generator_variables["batch_stats"]
    rng = np.random.RandomState(4)
    a = _port_generator(knobs)
    a[0].load_state_dict(_by_name(a[0], generator_variables["params"], bs))
    grads = [_by_name(a[0], _grads(generator_variables["params"], rng), bs)
             for _ in range(8)]

    def step(model, opt, g):
        for n, p in model.named_parameters():
            p.grad = g[n].clone()
        opt.step()

    for g in grads[:4]:
        step(*a, g)
    assert (a[1].count, a[1].mini_step) == (1, 1)
    path = str(tmp_path / "last_generator.pth")
    tck.save(path, tck.gan_state(*a, 1))
    b = _port_generator(knobs)
    assert tck.restore_gan_state(path, *b) == 1
    for g in grads[4:]:
        step(*a, g)
        step(*b, g)
    sa, sb = a[1].state_dict(), b[1].state_dict()
    assert (sb["count"], sb["mini_step"], sb["gradient_step"]) == (
        sa["count"], sa["mini_step"], sa["gradient_step"]) == (2, 2, 2)
    for key in ("exp_avg", "exp_avg_sq", "acc"):
        for x, y in zip(sa[key], sb[key]):
            assert torch.equal(x, y), key
    for (k, x), y in zip(a[0].state_dict().items(),
                         b[0].state_dict().values()):
        assert torch.equal(x, y), k


def test_cli_resumes_own_state_mid_accumulation(oscd_tree, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    common = ["--root-dir", str(oscd_tree), "--device", "cpu",
              "--target-size", "32x32", "--batch-size", "2",
              "--compute-dtype", "float32", "--checkpoint-dir", ckpt,
              "--grad-accum", "3", "--flat-opt-state"]
    first = train_cli.main(common + ["--num-epochs", "1"])
    state = torch.load(os.path.join(ckpt, "last_state.pth"),
                       weights_only=True)["optimizer"]
    assert (state["mini_step"], state["count"]) == (2, 0)
    resumed = train_cli.main(common + ["--num-epochs", "2", "--resume"])
    assert len(first["train_loss"]) == len(resumed["train_loss"]) == 1
    state = torch.load(os.path.join(ckpt, "last_state.pth"),
                       weights_only=True)["optimizer"]
    assert (state["mini_step"], state["count"]) == (1, 1)
    assert state["layout"]["flat"] and state["layout"]["multi_steps"]
    shutil.rmtree(ckpt)  # about 0.7 GB of full-width files


def test_optax_state_round_trips_through_flax_serialization():
    """The decoded layouts the port reads are flax's: MultiSteps fields by
    name, the chain by index, flattened moments 1-D."""
    tx = jopt.make_optimizer("adamw", LR, WD, **LAYOUTS["all"])
    sd = serialization.to_state_dict(tx.init(_tree()))
    assert set(sd) >= {"mini_step", "gradient_step", "inner_opt_state",
                       "acc_grads"}
    adam = sd["inner_opt_state"]["inner_state"]["0"]
    assert np.asarray(adam["mu"]).ndim == 1
    assert np.asarray(adam["mu"]).dtype == jnp.bfloat16
