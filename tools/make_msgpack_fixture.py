#!/usr/bin/env python3
"""Write the JAX-written checkpoint fixture that the port loads on the card.

    python3 tools/make_msgpack_fixture.py [--out tests/data]

Needs JAX and the JAX package (it runs on the CPU; the card's machine has
neither).  Writes two files:

  * ``jax_generator_nd5_ngf4.msgpack``: a JAX UNetGenerator (``num_downs``
    5, ``ngf`` 4) initialized from ``PRNGKey(0)``, with its BatchNorm
    scale, bias, mean and variance drawn from ``RandomState(0)`` (at init
    they are 1, 0, 0, 1, which would leave the BatchNorm mapping
    untested), saved through the JAX package's
    ``checkpoint.save_checkpoint(model_only=True)``;
  * ``jax_generator_nd5_ngf4_expected.npz``: ``x``, a seeded 2x32x32x3
    float32 input in [-1, 1] (NHWC), and ``y``, the JAX generator's
    float32 eval-mode output for it.

``python -m gan_aug_pfa_torch.generate_synthetic --num-downs 5 --ngf 4
--target-size 32x32 --generator-checkpoint-name
jax_generator_nd5_ngf4.msgpack`` loads the first; ``chip_smoke.py`` (phase
12) and ``tests/test_torch_cuda.py`` hold the port's generator on the card
against the second.  ``tests/test_torch_msgpack.py`` rebuilds both and
checks that the committed files equal them.
"""

import argparse
import os
import sys
from types import SimpleNamespace

import numpy as np

NAME = "jax_generator_nd5_ngf4"
NUM_DOWNS, NGF, SIZE, BATCH = 5, 4, 32, 2


def _randomize_bn(tree, rng):
    """Copy of a params or batch_stats tree with every BatchNorm leaf
    (scale/bias, mean/var) drawn from ``rng``, in key order."""
    if "scale" in tree:
        return {"scale": rng.uniform(0.5, 1.5, tree["scale"].shape),
                "bias": rng.normal(0.0, 0.1, tree["bias"].shape)}
    if "mean" in tree:
        return {"mean": rng.normal(0.0, 0.1, tree["mean"].shape),
                "var": rng.uniform(0.5, 1.5, tree["var"].shape)}
    return {k: _randomize_bn(v, rng) if isinstance(v, dict) else v
            for k, v in tree.items()}


def make(out_dir):
    """Write both files into ``out_dir``; returns their paths."""
    import jax
    import jax.numpy as jnp

    from gan_aug_pfa_tpu import checkpoint
    from gan_aug_pfa_tpu.models.pix2pix import UNetGenerator

    model = UNetGenerator(3, 3, num_downs=NUM_DOWNS, ngf=NGF,
                          dtype=jnp.float32)
    x0 = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    v = jax.jit(lambda k: model.init(k, x0, train=False))(
        jax.random.PRNGKey(0))
    v = jax.tree.map(np.asarray, v)
    rng = np.random.RandomState(0)
    v = {"params": _randomize_bn(v["params"], rng),
         "batch_stats": _randomize_bn(v["batch_stats"], rng)}
    v = jax.tree.map(lambda a: np.asarray(a, np.float32), v)
    x = (np.random.RandomState(1).rand(BATCH, SIZE, SIZE, 3) * 2
         - 1).astype(np.float32)
    y = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        v, x), np.float32)
    os.makedirs(out_dir, exist_ok=True)
    ckpt_path = os.path.join(out_dir, NAME + ".msgpack")
    npz_path = os.path.join(out_dir, NAME + "_expected.npz")
    checkpoint.save_checkpoint(
        ckpt_path,
        SimpleNamespace(params=v["params"], batch_stats=v["batch_stats"],
                        opt_state=(), step=0),
        model_only=True)
    np.savez(npz_path, x=x, y=y)
    return ckpt_path, npz_path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join("tests", "data"))
    args = p.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    for path in make(args.out):
        print(f"{path}: {os.path.getsize(path)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
