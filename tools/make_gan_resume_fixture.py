#!/usr/bin/env python3
"""Write the JAX-written GAN train-state fixture that the port resumes
from on the card.

    python3 tools/make_gan_resume_fixture.py [--out tests/data]

Needs JAX and the JAX package (it runs on the CPU; the card's machine has
neither).  It trains the JAX Pix2Pix GAN (``num_downs`` 5, ``ngf`` 4,
``ndf`` 8, ``n_layers`` 2, 32x32, batch 1, float32, ``--ema-decay`` 0.9)
for one epoch through the JAX package's ``run_gan_training`` on the
seeded 14-city tree of ``chip_smoke.write_oscd_tree``, and writes:

  * ``jax_gan_state_nd5_ngf4/last_generator.msgpack`` and
    ``last_discriminator.msgpack``: the JAX resume pair of that epoch
    (params, batch statistics, optax's Adam state, the EMA and the epoch);
  * ``jax_gan_state_nd5_ngf4_expected.npz``: ``a`` and ``b``, a seeded
    2x32x32x3 float32 batch in [0, 1] (NHWC), ``loss_d`` and ``loss_g``,
    the JAX GAN's float32 losses of one D+G step on it from that state,
    and ``epoch``, the epoch the pair was written at.

``python -m gan_aug_pfa_torch.train_gan --num-downs 5 --ngf 4 --ndf 8
--n-layers 2 --target-size 32x32 --resume`` continues from the pair;
``chip_smoke.py`` (phase 14) and ``tests/test_torch_cuda.py`` hold the
port's D+G step on the card against the losses.
``tests/test_torch_resume_jax.py`` rebuilds the files and checks that the
committed ones equal them.
"""

import argparse
import os
import shutil
import sys
import tempfile

import numpy as np

NAME = "jax_gan_state_nd5_ngf4"
ARCH = dict(num_downs=5, ngf=4, ndf=8, n_layers=2)
SIZE, BATCH, EMA_DECAY, SEED = 32, 2, 0.9, 0
STEMS = ("last_generator", "last_discriminator")


def make(out_dir):
    """Write the pair and the npz into ``out_dir``; returns the pair's
    directory and the npz's path."""
    import jax

    from gan_aug_pfa_tpu import config
    from gan_aug_pfa_tpu import pipelines

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        from chip_smoke import write_oscd_tree
    finally:
        sys.path.remove(repo)
    with tempfile.TemporaryDirectory() as root:
        write_oscd_tree(root, seed=SEED)
        cfg = config.GANTrainConfig(
            num_epochs=1, target_size=(SIZE, SIZE), compute_dtype="float32",
            data_parallel=False, ema_decay=EMA_DECAY, seed=SEED,
            save_every=1, sample_every=1, **ARCH)
        history = pipelines.run_gan_training(
            config.DataConfig(root_dir=root), cfg, verbose=False)
        pair_dir = os.path.join(out_dir, NAME)
        os.makedirs(pair_dir, exist_ok=True)
        for stem in STEMS:
            shutil.copyfile(
                os.path.join(root, cfg.checkpoint_dir, stem + ".msgpack"),
                os.path.join(pair_dir, stem + ".msgpack"))
    rng = np.random.RandomState(SEED + 1)
    a, b = (rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
            for _ in range(2))
    trainer = history["trainer"]
    _, _, loss_d, loss_g = trainer._gan_step_batch(
        history["state_g"], history["state_d"], jax.numpy.asarray(a),
        jax.numpy.asarray(b))
    npz_path = os.path.join(out_dir, NAME + "_expected.npz")
    np.savez(npz_path, a=a, b=b, loss_d=np.float32(loss_d),
             loss_g=np.float32(loss_g), epoch=np.int64(cfg.num_epochs))
    return pair_dir, npz_path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join("tests", "data"))
    args = p.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    pair_dir, npz_path = make(args.out)
    for path in [os.path.join(pair_dir, s + ".msgpack") for s in STEMS] + [
            npz_path]:
        print(f"{path}: {os.path.getsize(path)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
