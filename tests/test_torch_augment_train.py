"""Augmented Siamese training, the port against the JAX package on the
CPU: one train step of each chain from one JAX init with the JAX step's
own draw, the augmented batch's forward and backward at float64, and the
``--augment`` CLI.

Tolerances, and why:
  * the first step's loss at float32 within 1e-3 relative, the tolerance
    of the float32 lockstep in tests/test_torch_train.py: the augmented
    images agree within tests/test_torch_augment.CHAIN_ATOL, and the
    SiameseUNet's float32 forward at 32x32 is ill-conditioned (ROADMAP C2);
  * at float64 both chains run end to end under ``jax.enable_x64`` and in
    float64 on the port's side (parameters drawn in float32, so both sides
    apply the same values).  The augmented images then agree within 1e-6
    (the resize weight is float32 on both sides, and XLA's fused
    multiply-adds round at float64 now), the labels exactly, and the
    FocalDice loss and its gradients within 1e-6 of their size, as in
    test_train_forward_backward_matches_jax_at_float64.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_aug_pfa_torch import interop as ti
from gan_aug_pfa_torch import losses as tlosses
from gan_aug_pfa_torch import pipelines as tp
from gan_aug_pfa_torch.config import SiameseTrainConfig
from gan_aug_pfa_torch.data import loader as tl
from gan_aug_pfa_torch.data import scanner as ts
from gan_aug_pfa_torch.data import transforms as tt
from gan_aug_pfa_torch.models import SiameseUNet
from gan_aug_pfa_torch.train import __main__ as train_cli
from gan_aug_pfa_torch.train.siamese import SiameseTrainer
from gan_aug_pfa_tpu import config as jcfg
from gan_aug_pfa_tpu import losses as jlosses
from gan_aug_pfa_tpu.data import loader as jl
from gan_aug_pfa_tpu.data import scanner as js
from gan_aug_pfa_tpu.data import transforms as jt
from gan_aug_pfa_tpu.models.siamese_unet import SiameseUNet as JaxModel
from gan_aug_pfa_tpu.train.siamese import SiameseTrainer as JaxTrainer
from gan_aug_pfa_tpu.train.siamese import TrainState
from torch_port_helpers import jax_siamese_variables
from torch_tmp import drop_tmp_path  # noqa: F401

SUBDIR = "Onera Satellite Change Detection Dataset"
SIZE = (32, 32)
BS = 2
INIT_SEED, HEAD_SCALE = 1, 10.0  # as tests/test_torch_train.py
STEP1_RTOL = 1e-3
LOSS_KW = dict(beta=0.6699803915247974, focal_gamma=1.7930869982898021,
               focal_alpha=0.6030489822904476,
               dice_smooth=1.956571276926647e-06)


@pytest.fixture(scope="module")
def init():
    return jax_siamese_variables(seed=INIT_SEED, size=SIZE[0],
                                 head_scale=HEAD_SCALE)


def _datasets(root, native):
    """(JAX, port) train caches of oscd_tree: padded native or target
    size."""
    jax_samples = js.create_sample_lists(root, SUBDIR, "synthetic_data",
                                         mode="train", verbose=False)
    port_samples = ts.create_sample_lists(root, SUBDIR, mode="train",
                                          verbose=False)
    if native:
        return (jl.build_padded_native_dataset(jax_samples, verbose=False),
                tl.build_padded_native_dataset(port_samples, verbose=False))
    return (jl.build_cached_dataset(jax_samples, SIZE, verbose=False),
            tl.build_cached_dataset(port_samples, SIZE, verbose=False))


@pytest.mark.parametrize("native", [True, False],
                         ids=["native", "fixed_size"])
def test_first_augmented_step_matches_jax(oscd_tree, init, native):
    """The JAX trainer's step (augment=True, fp32) and the port trainer's
    from the same weights on the same rows, the JAX step's draw handed to
    the port through ``train_step(params=)``."""
    jax_ds, port_ds = _datasets(str(oscd_tree), native)
    cfg = jcfg.SiameseTrainConfig(batch_size=BS, compute_dtype="float32",
                                  data_parallel=False)
    trainer = JaxTrainer(cfg, augment=True,
                         native_out_size=SIZE if native else None)
    state = jax.jit(lambda v: TrainState.create(
        apply_fn=trainer.model.apply, params=v["params"], tx=trainer.tx,
        batch_stats=v["batch_stats"]))(init)
    idx = np.array([2, 0], np.int32)
    rng = jax.random.PRNGKey(5)
    _, want = trainer._train_step(state, *trainer._device_arrays(jax_ds),
                                  jnp.asarray(idx), rng)
    keys = jax.random.split(rng, BS)
    if native:
        sizes = jax_ds.sizes[idx]
        draw = jax.vmap(lambda k, s: jt.sample_augment_params(
            k, s[0], s[1]))(keys, sizes)
    else:
        draw = jax.vmap(lambda k: jt.sample_augment_params(k, *SIZE))(keys)
    params = {k: torch.from_numpy(np.array(v)) for k, v in draw.items()}

    port = SiameseTrainer(SiameseTrainConfig(batch_size=BS,
                                             compute_dtype="float32"),
                          "cpu", augment=True,
                          native_out_size=SIZE if native else None)
    port.model.load_state_dict(ti.siamese_state_dict_from_jax(init))
    cache = (tp.NativeDeviceCache if native else tp.DeviceCache
             ).from_dataset(port_ds, "cpu")
    got = float(port.train_step(cache, torch.from_numpy(idx).long(), params))
    print(json.dumps({"chain": "native" if native else "fixed_size",
                      "step1_loss_port": got, "step1_loss_jax": float(want),
                      "relative_gap": (got - float(want)) / float(want)}))
    assert got == pytest.approx(float(want), rel=STEP1_RTOL)
    # Without a draw the step takes one from the trainer's generator.
    assert np.isfinite(float(port.train_step(cache, torch.tensor([1, 3]))))


# One compile each (traced under x64 at first call).
_jax_native_chain = jax.jit(jax.vmap(
    jt.augment_sample_native, in_axes=(0, 0, 0, 0, None, 0)),
    static_argnums=4)
_jax_fixed_chain = jax.jit(jax.vmap(jt.apply_augment_sample))


@pytest.mark.parametrize("native", [True, False],
                         ids=["native", "fixed_size"])
def test_augmented_step_gradients_match_jax_at_float64(oscd_tree, init,
                                                       native):
    """The augmented batch, the train-mode forward, the FocalDice loss and
    its gradients at float64 on both sides, from one JAX init."""
    jax_ds, _ = _datasets(str(oscd_tree), native)
    idx = np.array([1, 3])
    i1, i2 = jax_ds.img1[idx], jax_ds.img2[idx]
    lb = jax_ds.labels[idx]
    rng = jax.random.PRNGKey(7)
    keys = jax.random.split(rng, BS)
    h, w = i1.shape[1:3]
    sizes = jax_ds.sizes[idx] if native else np.array([[h, w]] * BS)
    draw = jax.tree.map(np.asarray, jax.vmap(
        lambda k, s: jt.sample_augment_params(k, s[0], s[1]))(
            keys, jnp.asarray(sizes)))
    with jax.enable_x64(True):
        p64 = {k: jnp.asarray(v, np.float64) if v.dtype == np.float32
               else jnp.asarray(v) for k, v in draw.items()}
        x1, x2 = jnp.asarray(i1, np.float64), jnp.asarray(i2, np.float64)
        if native:
            a1, a2, albl = _jax_native_chain(
                x1, x2, jnp.asarray(lb), jnp.asarray(sizes), SIZE, p64)
        else:
            a1, a2, albl = _jax_fixed_chain(x1, x2, jnp.asarray(lb), p64)
        assert a1.dtype == jnp.float64
        v64 = jax.tree.map(lambda a: jnp.asarray(a, np.float64), init)
        model = JaxModel(3, 1, dtype=np.float64)

        def loss(params):
            out, _ = model.apply(
                {"params": params, "batch_stats": v64["batch_stats"]},
                a1, a2, train=True, mutable=["batch_stats"])
            return jlosses.focal_dice_loss(out, albl[..., None], **LOSS_KW)

        want_loss, grads = jax.jit(jax.value_and_grad(loss))(v64["params"])
        want_grads = ti.siamese_state_dict_from_jax(
            {"params": jax.tree.map(np.asarray, grads),
             "batch_stats": init["batch_stats"]}, dtype=np.float64)
        want_imgs = [np.asarray(a) for a in (a1, a2)]
        want_lbl = np.asarray(albl)

    params = {k: torch.tensor(v, dtype=torch.float64)
              if v.dtype == np.float32 else torch.tensor(v)
              for k, v in draw.items()}
    t1, t2 = torch.from_numpy(i1).double(), torch.from_numpy(i2).double()
    if native:
        g1, g2, glbl = tt.augment_batch_native(
            t1, t2, torch.from_numpy(lb), torch.from_numpy(sizes), SIZE,
            params)
    else:
        g1, g2, glbl = tt.augment_batch(t1, t2, torch.from_numpy(lb), params)
    img_gap = max(float(np.abs(g.numpy() - want).max())
                  for g, want in zip((g1, g2), want_imgs))
    assert g1.dtype == g2.dtype == torch.float64 and img_gap <= 1e-6
    np.testing.assert_array_equal(glbl.numpy(), want_lbl)

    port = SiameseUNet()
    port.load_state_dict(ti.siamese_state_dict_from_jax(init))
    port.double().train()
    out = port(g1.permute(0, 3, 1, 2), g2.permute(0, 3, 1, 2))
    got_loss = tlosses.focal_dice_loss(out, glbl, **LOSS_KW)
    got_loss.backward()
    got_loss = float(got_loss.detach())
    biggest = max(float(want_grads[k].abs().max())
                  for k, _ in port.named_parameters())
    grad_gap = max(float((p.grad - want_grads[k]).abs().max())
                   for k, p in port.named_parameters())
    print(json.dumps({"chain": "native" if native else "fixed_size",
                      "fp64_image_gap": img_gap,
                      "fp64_loss_relative_gap":
                          (got_loss - float(want_loss)) / float(want_loss),
                      "fp64_grad_gap_over_max": grad_gap / biggest}))
    assert got_loss == pytest.approx(float(want_loss), rel=1e-6)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad, want_grads[name], rtol=0,
                                   atol=1e-6 * biggest, err_msg=name)


# -- the CLI --------------------------------------------------------------


@pytest.mark.parametrize("chain", [[], ["--no-native-aug"]],
                         ids=["native", "fixed_size"])
def test_cli_augment_trains_on_the_cpu(oscd_tree, tmp_path, chain):
    ckpt_dir = str(tmp_path / "ckpt")
    history = train_cli.main(
        ["--root-dir", str(oscd_tree), "--device", "cpu", "--augment",
         "--num-epochs", "1", "--target-size", "32x32", "--batch-size", "2",
         "--checkpoint-dir", ckpt_dir, *chain])
    losses = history["train_loss"] + history["val_loss"]
    assert len(losses) == 2 and all(np.isfinite(v) for v in losses)
    assert os.path.exists(os.path.join(ckpt_dir, "best_model.pth"))
    assert history["trainer"].augment
    assert (history["trainer"].native_out_size is None) == bool(chain)


def test_cli_augment_without_a_card_raises(oscd_tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--root-dir", str(oscd_tree), "--augment",
                        "--num-epochs", "1"])
