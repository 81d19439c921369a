"""Shared inputs for the port's parity tests (tests/test_torch_*.py): one
seeded full-width JAX SiameseUNet init and seeded JAX Pix2Pix inits, with
randomized BatchNorm affine parameters and running statistics, as trees of
numpy arrays.

At init the head's logits lie within about 0.1 of 0, so every probability
sits near the 0.5 threshold; the head's kernel is scaled by HEAD_SCALE to spread
the logits over a few units, as a trained model's are, and its bias
centres them on seeded random images, so that about half the pixels are
predicted as change."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from gan_aug_pfa_tpu.models.pix2pix import NLayerDiscriminator, UNetGenerator
from gan_aug_pfa_tpu.models.siamese_unet import SiameseUNet


HEAD_SCALE = 300.0


def _randomize_bn(tree, rng):
    """Copy of a params or batch_stats tree with every BatchNorm leaf
    (scale/bias, mean/var) drawn from ``rng``."""
    if "scale" in tree:
        return {"scale": rng.uniform(0.5, 1.5, tree["scale"].shape),
                "bias": rng.normal(0.0, 0.1, tree["bias"].shape)}
    if "mean" in tree:
        return {"mean": rng.normal(0.0, 0.1, tree["mean"].shape),
                "var": rng.uniform(0.5, 1.5, tree["var"].shape)}
    return {k: _randomize_bn(v, rng) if isinstance(v, dict) else v
            for k, v in tree.items()}


def jax_siamese_variables(seed=0, size=32, head_scale=HEAD_SCALE):
    """{"params", "batch_stats"} of the JAX SiameseUNet (fp32), numpy
    leaves, with seeded random BN scale/bias/mean/var and the head's
    kernel scaled by ``head_scale``."""
    model = SiameseUNet(3, 1, dtype=jnp.float32)
    x = jnp.zeros((1, size, size, 3), jnp.float32)
    v = jax.jit(lambda k: model.init(k, x, x, train=False))(
        jax.random.PRNGKey(seed))
    v = jax.tree.map(np.asarray, v)
    rng = np.random.RandomState(seed)
    v = {"params": _randomize_bn(v["params"], rng),
         "batch_stats": _randomize_bn(v["batch_stats"], rng)}
    head = v["params"]["conv_head"]
    v["params"]["conv_head"] = {"kernel": head["kernel"] * head_scale,
                                "bias": np.zeros_like(head["bias"])}
    v = jax.tree.map(lambda a: np.asarray(a, np.float32), v)
    calib = rng.rand(2, 2, size, size, 3).astype(np.float32) * 2 - 1
    logits = jax_siamese_logits(v, calib[0], calib[1])
    v["params"]["conv_head"]["bias"] -= np.median(logits).astype(np.float32)
    return v


@functools.lru_cache(maxsize=None)
def _jax_siamese_apply(batched_encoder):
    """One jitted eval-mode apply for each encoder form, so that calls at
    a shape already seen reuse its compile."""
    model = SiameseUNet(3, 1, dtype=jnp.float32,
                        batched_encoder=batched_encoder)
    return jax.jit(lambda v, a, b: model.apply(v, a, b, train=False))


def jax_siamese_logits(variables, x1, x2, batched_encoder=False):
    """JAX fp32 eval-mode logits for [-1,1] NHWC numpy inputs."""
    return np.asarray(
        _jax_siamese_apply(batched_encoder)(variables, x1, x2))


def jax_pix2pix_models(num_downs=5, ngf=8, ndf=8, n_layers=3,
                       dtype=jnp.float32):
    """The JAX generator and discriminator at a test size."""
    return (UNetGenerator(3, 3, num_downs=num_downs, ngf=ngf, dtype=dtype),
            NLayerDiscriminator(6, ndf=ndf, n_layers=n_layers, dtype=dtype))


def jax_pix2pix_variables(seed=0, size=32, **arch):
    """(generator, discriminator) variables of the JAX Pix2Pix models
    (fp32, numpy leaves), with seeded random BN scale/bias/mean/var."""
    gen, disc = jax_pix2pix_models(**arch)
    x = jnp.zeros((1, size, size, 3), jnp.float32)
    kg, kd = jax.random.split(jax.random.PRNGKey(seed))
    vg = jax.jit(lambda k: gen.init(k, x, train=False))(kg)
    vd = jax.jit(lambda k: disc.init(
        k, jnp.concatenate([x, x], axis=-1), train=False))(kd)
    rng = np.random.RandomState(seed)
    out = []
    for v in (vg, vd):
        v = jax.tree.map(np.asarray, v)
        v = {"params": _randomize_bn(v["params"], rng),
             "batch_stats": _randomize_bn(v["batch_stats"], rng)}
        out.append(jax.tree.map(lambda a: np.asarray(a, np.float32), v))
    return tuple(out)
