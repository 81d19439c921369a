"""The Siamese model knobs of the port (``models/siamese_unet.py``,
``models/blocks.py``) against the JAX package on the CPU, and the train
CLI with every knob on.

  * ``--batched-encoder``, ``--concat-free`` and ``--remat``: one
    train-mode forward and backward of the full-width model at 32x32,
    batch 2, from one seeded init with random BatchNorm statistics, at
    float64 on both sides, against a fixed linear functional of the
    logits (one jitted JAX value-and-grad for each form, the JAX model
    built with the same flag): the loss within 1e-6 relative, every
    gradient within 1e-6 of the largest, running means within 1e-6
    relative and running variances under torch's N/(N-1) relation
    (ROADMAP C1), N the element count per channel at the layer's input,
    2B*H*W in the encoder under ``--batched-encoder``, which updates once
    a step there instead of twice;
  * ``--concat-free`` and ``--remat`` compute the same function as the
    default model: the same check against the port's default path, the
    BatchNorm buffers equal exactly under ``--remat`` (its recomputation
    leaves them alone);
  * a bf16 train step of ``SiameseTrainer`` with ``remat`` leaves the loss,
    the parameters and every BatchNorm buffer exactly as a plain step does
    (the recomputation runs under the same autocast);
  * ``python -m gan_aug_pfa_torch.train`` for an epoch with all six knobs
    and ``--stream host``.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from gan_aug_pfa_torch import interop as ti
from gan_aug_pfa_torch.config import SiameseTrainConfig
from gan_aug_pfa_torch.models import SiameseUNet
from gan_aug_pfa_torch.models.blocks import DoubleConv
from gan_aug_pfa_torch.train import __main__ as train_cli
from gan_aug_pfa_torch.train.siamese import SiameseTrainer
from gan_aug_pfa_tpu import interop as ji
from gan_aug_pfa_tpu.models.siamese_unet import SiameseUNet as JaxModel
from torch_tmp import drop_tmp_path  # noqa: F401

SIZE = 32
BS = 2
BN_MOMENTUM = 0.9  # flax momentum; torch's 0.1
FORMS = ("batched_encoder", "concat_free", "remat")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def init():
    """A seeded port init, BatchNorm affine parameters and running
    statistics drawn at random, as a float32 state dict."""
    torch.manual_seed(3)
    model = SiameseUNet()
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t, lo in ((m.weight, 0.5), (m.running_var, 0.5)):
                    t.copy_(lo + torch.rand(t.shape, generator=gen))
                for t in (m.bias, m.running_mean):
                    t.copy_(0.1 * torch.randn(t.shape, generator=gen))
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(2)
    x1, x2 = (rng.rand(BS, SIZE, SIZE, 3) * 2 - 1 for _ in range(2))
    return x1, x2, rng.randn(BS, SIZE, SIZE, 1)


def _jax_run(init, inputs, form):
    x1, x2, w = inputs
    variables = ji.siamese_from_torch(
        {k: v.numpy() for k, v in init.items()})
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jax.numpy.asarray(a, np.float64),
                           variables)
        model = JaxModel(3, 1, dtype=np.float64, **{form: True})

        def loss(params):
            out, upd = model.apply(
                {"params": params, "batch_stats": v64["batch_stats"]},
                x1, x2, train=True, mutable=["batch_stats"])
            return (out * w).sum(), upd

        # Without LLVM's expensive passes: about 3 s less compile a form
        # on the CPU, the same run time.
        (value, upd), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True)).lower(v64["params"]).compile(
                compiler_options={"xla_llvm_disable_expensive_passes":
                                  True})(v64["params"])
        grads, stats = (jax.tree.map(np.asarray, t)
                        for t in (grads, upd["batch_stats"]))
    return {"loss": float(value),
            "grads": ti.siamese_state_dict_from_jax(
                {"params": grads, "batch_stats": variables["batch_stats"]},
                dtype=np.float64),
            "state": ti.siamese_state_dict_from_jax(
                {"params": variables["params"], "batch_stats": stats},
                dtype=np.float64)}


def _port_run(init, inputs, **knobs):
    """Loss, gradients and state dict after one train-mode forward and
    backward at float64, and N at each BatchNorm's input."""
    x1, x2, w = inputs
    model = SiameseUNet(**knobs)
    model.load_state_dict(init)
    model.double().train()
    sizes, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            hooks.append(m.register_forward_pre_hook(
                lambda m, i, name=name: sizes.__setitem__(
                    name, i[0].numel() // i[0].shape[1])))
    out = model(*(torch.from_numpy(x).permute(0, 3, 1, 2)
                  for x in (x1, x2)))
    loss = (out * torch.from_numpy(w).permute(0, 3, 1, 2)).sum()
    loss.backward()
    for h in hooks:
        h.remove()
    return {"loss": float(loss),
            "grads": {k: p.grad for k, p in model.named_parameters()},
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "sizes": sizes}


@pytest.fixture(scope="module")
def runs(init, inputs):
    cache = {}

    def get(side, form):
        if (side, form) not in cache:
            if side == "jax":
                cache[side, form] = _jax_run(init, inputs, form)
            else:
                knobs = {} if form == "default" else {form: True}
                cache[side, form] = _port_run(init, inputs, **knobs)
        return cache[side, form]
    return get


def _assert_grads(got, want):
    """Every gradient within 1e-6 of the largest (in torch: the
    41M-element comparison takes a fraction of numpy's time)."""
    biggest = max(float(v.abs().max()) for v in want.values())
    for name, g in got.items():
        # Conv biases before train-mode BatchNorm have a gradient of 0,
        # which leaves only rounding noise to compare.
        err = float((g - want[name]).abs().max())
        assert err <= 1e-6 * biggest, (name, err, biggest)


@pytest.mark.parametrize("form", FORMS)
def test_model_knob_matches_jax_at_float64(runs, init, form):
    got, want = runs("port", form), runs("jax", form)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
    _assert_grads(got["grads"], want["grads"])
    encoder = ("dconv_down", "bottleneck")
    for name, n in got["sizes"].items():
        k = int(got["state"][name + ".num_batches_tracked"])
        two_pass = name.startswith(encoder) and form != "batched_encoder"
        assert k == (2 if two_pass else 1), name
        decay = BN_MOMENTUM ** k
        mean, var = name + ".running_mean", name + ".running_var"
        np.testing.assert_allclose(got["state"][mean], want["state"][mean],
                                   rtol=1e-6, atol=1e-9, err_msg=mean)
        start = init[var].double()
        np.testing.assert_allclose(
            got["state"][var] - decay * start,
            n / (n - 1) * (want["state"][var] - decay * start),
            rtol=1e-6, atol=1e-9, err_msg=var)


def test_batched_encoder_normalizes_over_both_images(runs):
    """The encoder's BatchNorms see 2B images in one pass: twice the
    elements of the two-pass form's each."""
    two, one = runs("port", "default")["sizes"], runs(
        "port", "batched_encoder")["sizes"]
    for name in one:
        factor = 2 if name.startswith(("dconv_down", "bottleneck")) else 1
        assert one[name] == factor * two[name], name


@pytest.mark.parametrize("form", ["concat_free", "remat"])
def test_same_math_knob_matches_the_default_path(runs, form):
    got, base = runs("port", form), runs("port", "default")
    assert got["loss"] == pytest.approx(base["loss"], rel=1e-6)
    _assert_grads(got["grads"], base["grads"])
    for k, v in base["state"].items():
        if form == "remat":
            assert torch.equal(got["state"][k], v), k
        else:
            np.testing.assert_allclose(got["state"][k], v, rtol=1e-6,
                                       atol=1e-12, err_msg=k)


def test_remat_recomputes_every_double_conv_without_keeping_buffers():
    model = SiameseUNet(remat=True)
    blocks = [m for m in model.modules() if isinstance(m, DoubleConv)]
    assert len(blocks) == 9 and all(m.remat for m in blocks)
    assert not any(m.remat for m in SiameseUNet().modules()
                   if isinstance(m, DoubleConv))


def test_remat_bf16_step_equals_a_plain_step(init):
    """One ``SiameseTrainer`` step under bf16 autocast, with and without
    remat, from one init on one batch: the same loss, parameters and
    BatchNorm buffers, bit for bit."""
    rng = np.random.RandomState(5)
    img = [torch.from_numpy(rng.rand(BS, 3, SIZE, SIZE).astype(np.float32))
           for _ in range(2)]
    labels = torch.from_numpy((rng.rand(BS, SIZE, SIZE) > 0.7).astype(
        np.float32))
    out = []
    for remat in (False, True):
        trainer = SiameseTrainer(SiameseTrainConfig(
            compute_dtype="bfloat16", remat=remat), "cpu")
        trainer.model.load_state_dict(init)
        loss = trainer.train_batch(*img, labels)
        out.append((float(loss), trainer.model.state_dict()))
    assert out[0][0] == out[1][0]
    for k, v in out[0][1].items():
        assert torch.equal(out[1][1][k], v), k


def test_cli_epoch_with_every_knob_streamed(oscd_tree, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    history = train_cli.main([
        "--root-dir", str(oscd_tree), "--device", "cpu", "--target-size",
        "32x32", "--batch-size", "2", "--compute-dtype", "float32",
        "--checkpoint-dir", ckpt, "--num-epochs", "1", "--stream", "host",
        "--batched-encoder", "--concat-free", "--remat", "--grad-accum",
        "2", "--momentum-dtype", "bfloat16", "--flat-opt-state"])
    losses = history["train_loss"] + history["val_loss"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    trainer = history["trainer"]
    model, opt = trainer.model, trainer.optimizer
    assert model.batched_encoder and model.concat_free
    assert all(m.remat for m in model.modules() if isinstance(m, DoubleConv))
    state = torch.load(os.path.join(ckpt, "last_state.pth"),
                       weights_only=True)["optimizer"]
    assert state["layout"] == {"mu_dtype": "bfloat16", "flat": True,
                               "multi_steps": True, "grad_accum": 2}
    # 4 train pairs at batch 2: two mini-steps, one update.
    assert (state["count"], state["mini_step"]) == (1, 0) == (
        opt.count, opt.mini_step)
    assert state["exp_avg"][0].dtype == torch.bfloat16
    assert state["exp_avg"][0].numel() == sum(
        p.numel() for p in model.parameters())
    shutil.rmtree(ckpt)  # about 0.7 GB of full-width files
