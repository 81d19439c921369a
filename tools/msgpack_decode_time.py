#!/usr/bin/env python3
"""Decode time of full-width JAX ``.msgpack`` checkpoints: the port's own
reader against flax's.

    python3 tools/msgpack_decode_time.py [--repeats 5]

Needs JAX and the JAX package (it writes the files with
``gan_aug_pfa_tpu.checkpoint.save_checkpoint``); runs on the CPU.  Writes,
into a temporary directory, the full-width SiameseUNet as
``best_model.msgpack`` (model-only) and as ``last_state.msgpack`` (the
full train state, AdamW with bfloat16 first moments, one update in), then
times, median and range over ``--repeats`` runs each: the port's
``interop.variables_from_msgpack`` (file read and decode), flax's
``serialization.msgpack_restore`` of the same bytes (file read included),
and the port's ``checkpoint.restore_model_only`` into a SiameseUNet
(decode, layout conversion and a strict load).  Prints the host's CPU
model beside the numbers.
"""

import argparse
import os
import platform
import statistics
import sys
import tempfile
import time


def _cpu_name():
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown CPU"


def _times(fn, repeats):
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from gan_aug_pfa_torch import checkpoint, interop
    from gan_aug_pfa_torch.models import SiameseUNet
    from gan_aug_pfa_tpu import checkpoint as jck
    from gan_aug_pfa_tpu.models.siamese_unet import SiameseUNet as JaxUNet
    from gan_aug_pfa_tpu.train.optim import make_optimizer
    from gan_aug_pfa_tpu.train.siamese import TrainState

    model = JaxUNet(3, 1, dtype=jnp.float32)
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    v = jax.jit(lambda k: model.init(k, x, x, train=False))(
        jax.random.PRNGKey(0))
    state = TrainState.create(
        apply_fn=None, params=v["params"], batch_stats=v["batch_stats"],
        tx=make_optimizer("adamw", 1e-4, 1e-5, mu_dtype="bfloat16"))
    state = jax.jit(lambda s: s.apply_gradients(grads=jax.tree.map(
        lambda a: a * 0.01, s.params)))(state)
    print(f"host: {_cpu_name()}, {os.cpu_count()} CPUs; "
          f"median [min, max] of {args.repeats} runs")
    with tempfile.TemporaryDirectory() as d:
        for stem, model_only in (("best_model", True), ("last_state", False)):
            path = os.path.join(d, stem + ".msgpack")
            jck.save_checkpoint(path, state, extra={"epoch": 1},
                                model_only=model_only)

            def flax_read():
                with open(path, "rb") as f:
                    serialization.msgpack_restore(f.read())

            rows = {
                "port variables_from_msgpack": _times(
                    lambda: interop.variables_from_msgpack(path),
                    args.repeats),
                "flax msgpack_restore": _times(flax_read, args.repeats),
                "port restore_model_only": _times(
                    lambda: checkpoint.restore_model_only(path,
                                                          SiameseUNet()),
                    args.repeats),
            }
            size = os.path.getsize(path) / 1e6
            for name, ts in rows.items():
                ms = [1e3 * t for t in ts]
                print(f"{stem}.msgpack ({size:.1f} MB) {name}: "
                      f"{statistics.median(ms):.1f} ms "
                      f"[{min(ms):.1f}, {max(ms):.1f}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
