"""Train the Pix2Pix GAN for change-data augmentation.

    python -m gan_aug_pfa_torch.train_gan --root-dir <root> [--num-epochs N]

Flag names and defaults are the root ``train_gan.py``'s (256x256, batch 1,
200 epochs, both learning rates 1e-4, beta1 0.5, lambda_L1 100, bf16).
``--device`` (default ``cuda``) picks the device; without a card the run
raises unless ``--device cpu`` is given.  ``--ema-decay`` keeps the
generator's EMA.  Run control: ``--log-jsonl``, ``--profile-dir``,
``--debug-nans`` and ``--async-ckpt``; SIGTERM or SIGINT finishes the epoch
in flight, writes the epoch's checkpoints and the ``last_*`` resume pair at
it and exits 0, and ``--resume`` continues from there, or from the JAX
package's ``last_generator.msgpack`` and ``last_discriminator.msgpack``.
Training is data-parallel over every visible card, as the JAX CLI's (one
worker a card, or the ranks of ``torchrun``; ``parallel/mesh.py``); the
default batch of 1 then runs whole on every card.  ``--no-data-parallel``
trains on one device.  ``--no-compile-cache`` is accepted so that the JAX
package's command lines run unchanged (the port has no compilation
cache).  ``--stream host|decode`` keeps the corpus
off the device (``data/stream.py``).  The JAX package's GAN knobs:
``--batched-disc``, ``--concat-free-disc`` and ``--shared-gen-fwd`` (the
step; ``train/gan.py``), ``--momentum-dtype`` and ``--flat-opt-state``
(both optimizers).  ``--resume`` from a pair whose optimizer layout is not
the one these flags give exits 2 naming both.
"""

from __future__ import annotations

import argparse
import importlib
from typing import Dict, List, Optional

from .config import (
    DATASET_SUBDIR_DEFAULT,
    DataConfig,
    GANTrainConfig,
    parse_target_size,
)
from .checkpoint import ResumeStateError
from .train.optim import MOMENTUM_DTYPES
from .train.siamese import COMPUTE_DTYPES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train Pix2Pix GAN for change-data augmentation")
    p.add_argument("--root-dir", type=str, default=".")
    p.add_argument("--dataset-subdir", type=str,
                   default=DATASET_SUBDIR_DEFAULT)
    p.add_argument("--checkpoint-dir", type=str, default="gan_checkpoints")
    p.add_argument("--output-dir", type=str, default="gan_samples")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--num-epochs", type=int, default=200)
    p.add_argument("--learning-rate-g", type=float, default=1e-4)
    p.add_argument("--learning-rate-d", type=float, default=1e-4)
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--lambda-l1", type=float, default=100.0)
    p.add_argument("--target-size", type=str, default="256x256")
    p.add_argument("--save-every", type=int, default=10)
    p.add_argument("--sample-every", type=int, default=5)
    p.add_argument("--num-downs", type=int, default=7,
                   help="generator U-Net depth (>= 5; the target size must "
                        "be a multiple of 2**N)")
    p.add_argument("--ngf", type=int, default=64,
                   help="generator base filter count")
    p.add_argument("--ndf", type=int, default=64,
                   help="discriminator base filter count")
    p.add_argument("--n-layers", type=int, default=3,
                   help="discriminator depth")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the model init and the epoch order")
    p.add_argument("--compute-dtype", type=str, default="bfloat16",
                   choices=list(COMPUTE_DTYPES),
                   help="model compute dtype (params stay float32)")
    p.add_argument("--resume", action="store_true",
                   help="resume from <checkpoint-dir>/last_generator.pth "
                        "and last_discriminator.pth")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="keep an exponential moving average of the "
                        "generator weights (e.g. 0.999), saved as "
                        "generator_ema_epoch_N.pth")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    p.add_argument("--no-data-parallel", action="store_true",
                   help="train on one device (default: data-parallel over "
                        "every visible card, one process a card; under "
                        "torchrun, over its ranks)")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="accepted for the JAX package's command lines; "
                        "the port has no compilation cache")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler trace + per-step timing "
                        "stats")
    p.add_argument("--debug-nans", action="store_true",
                   help="check each step's losses and gradients for "
                        "NaN/Inf (raises naming the step)")
    p.add_argument("--async-ckpt", action="store_true",
                   help="[extension] write checkpoints on a background "
                        "thread (see train.py --help)")
    p.add_argument("--log-jsonl", type=str, default=None,
                   help="[extension] append machine-readable run events "
                        "(run_start/epoch/checkpoint/sample/preemption/"
                        "run_end) as one JSON object per line to this "
                        "file; --resume appends to the same file")
    p.add_argument("--stream", type=str, default="hbm",
                   choices=["hbm", "host", "decode"],
                   help="[extension] train-data placement: 'hbm' keeps the "
                        "decoded corpus device-resident (default); 'host' "
                        "keeps it in host memory, copying batches to the "
                        "device per step; 'decode' re-decodes batches on "
                        "demand")
    p.add_argument("--batched-disc", action="store_true",
                   help="one 2B discriminator pass over [real|fake] (D's "
                        "BN batch stats mix real and fake)")
    p.add_argument("--concat-free-disc", action="store_true",
                   help="[extension] feed D the (A,B) pair; first conv "
                        "runs as a split-kernel sum, skipping the "
                        "6-channel concat (numerically equivalent)")
    p.add_argument("--shared-gen-fwd", action="store_true",
                   help="[extension] compute the generator forward once "
                        "per step instead of the reference's twice; same "
                        "losses/gradients, BN running stats reconstructed "
                        "to ~1e-7")
    p.add_argument("--momentum-dtype", type=str, default=None,
                   choices=list(MOMENTUM_DTYPES),
                   help="[extension] dtype for Adam's first-moment state "
                        "(default: param dtype, torch-exact)")
    p.add_argument("--flat-opt-state", action="store_true",
                   help="[extension] optimizer update on one concatenated "
                        "vector (optax.flatten; see train --help)")
    return p


def main(argv: Optional[List[str]] = None) -> Optional[Dict]:
    parser = build_parser()
    args = parser.parse_args(argv)
    target_size = parse_target_size(args.target_size)
    data_cfg = DataConfig(root_dir=args.root_dir,
                          dataset_subdir=args.dataset_subdir,
                          target_size=target_size, stream=args.stream)
    gan_cfg = GANTrainConfig(
        batch_size=args.batch_size,
        num_epochs=args.num_epochs,
        learning_rate_g=args.learning_rate_g,
        learning_rate_d=args.learning_rate_d,
        beta1=args.beta1,
        lambda_l1=args.lambda_l1,
        target_size=target_size,
        save_every=args.save_every,
        sample_every=args.sample_every,
        checkpoint_dir=args.checkpoint_dir,
        output_dir=args.output_dir,
        num_downs=args.num_downs,
        ngf=args.ngf,
        ndf=args.ndf,
        n_layers=args.n_layers,
        seed=args.seed,
        compute_dtype=args.compute_dtype,
        resume=args.resume,
        ema_decay=args.ema_decay,
        batched_disc=args.batched_disc,
        concat_free_disc=args.concat_free_disc,
        shared_gen_fwd=args.shared_gen_fwd,
        opt_momentum_dtype=args.momentum_dtype,
        opt_flat_state=args.flat_opt_state,
        async_ckpt=args.async_ckpt,
        profile_dir=args.profile_dir,
        debug_nans=args.debug_nans,
        log_jsonl=args.log_jsonl,
        data_parallel=not args.no_data_parallel,
    )
    from .parallel.mesh import LaunchError, launch

    # By its importable name, so that a spawned worker can unpickle it.
    train = importlib.import_module(__spec__.name).train
    try:
        return launch(train, (data_cfg, gan_cfg, args.device),
                      data_parallel=gan_cfg.data_parallel,
                      device=args.device)
    except LaunchError as e:
        parser.error(str(e))


def train(data_cfg: DataConfig, gan_cfg: GANTrainConfig, device):
    """``pipelines.run_gan_training`` on one rank (or alone); a resume pair
    of another optimizer layout exits 2 naming both."""
    from . import pipelines

    try:
        return pipelines.run_gan_training(data_cfg, gan_cfg, device=device)
    except ResumeStateError as e:
        build_parser().error(str(e))


if __name__ == "__main__":
    # run_gan_training returns None when it finds no sample.
    raise SystemExit(0 if main() is not None else 1)
