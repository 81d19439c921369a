"""Train the Siamese Attention U-Net for change detection.

    python -m gan_aug_pfa_torch.train --root-dir <root> [--num-epochs N]

Flag names are the root ``train.py``'s.  ``--device`` (default ``cuda``)
picks the device; without a card the run raises unless ``--device cpu``
is given.  ``--augment`` turns on joint augmentation, at native
resolution unless ``--no-native-aug``.  ``--fused-loss`` and
``--[no-]pallas-augment`` are accepted so that the JAX package's command
lines run unchanged: on the card the loss always runs the fused kernels
and augmentation the photometric kernels.  Run control: ``--log-jsonl``,
``--profile-dir``, ``--debug-nans``, ``--defer-best-ckpt`` and
``--async-ckpt``; SIGTERM or SIGINT finishes the epoch in flight, writes
``last_state.pth`` at it and exits 0, and ``--resume`` continues from
there, or from the JAX package's ``last_state.msgpack``.  ``--tune
[--n-trials N] [--parallel-trials N]`` runs the hyperparameter study
instead (``tune.run_tuning``; the study file ``optuna_study.db`` lands in
the working directory).  ``--stream host|decode`` keeps the train split
off the device (``data/stream.py``; validation stays resident; with
``--augment`` it streams the fixed-size chain, and tuning ignores it with
the JAX package's note).  The JAX package's training knobs:
``--batched-encoder``, ``--concat-free`` and ``--remat`` (the model),
``--momentum-dtype``, ``--flat-opt-state`` and ``--grad-accum`` (the
optimizer; ``train/optim.py``).  ``--resume`` from a state whose optimizer
layout is not the one these flags give exits 2 naming both.

Training is data-parallel over every visible card, as the JAX CLI's
(``parallel/mesh.py``): on a host with several cards the CLI starts one
worker a card; under ``torchrun`` (``torchrun --nproc-per-node N -m
gan_aug_pfa_torch.train ...``, also with ``--device cpu``) each process is
one rank.  Rank 0 prints and writes.  ``--no-data-parallel`` trains on
one device.  ``--tune --parallel-trials k`` splits the cards as the JAX
CLI does (``tune.partition_devices``): k partitions of ``cards // k``
cards, one trial at a time each.  A partition of one card is a worker
thread; one of several trains each of its trials data-parallel, one rank
a card (the CLI spawns them; under ``torchrun`` the world is
partitioned).  With ``--no-data-parallel`` each worker thread takes one
card.
"""

from __future__ import annotations

import argparse
import importlib
from typing import Dict, List, Optional

from ..config import (
    DATASET_SUBDIR_DEFAULT,
    SYNTHETIC_DATA_DIR_DEFAULT,
    DataConfig,
    SiameseTrainConfig,
    parse_target_size,
)
from ..checkpoint import ResumeStateError
from .optim import MOMENTUM_DTYPES
from .siamese import COMPUTE_DTYPES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train Siamese U-Net for Change Detection")
    p.add_argument("--root-dir", type=str, default=".",
                   help="Root project directory")
    p.add_argument("--dataset-subdir", type=str,
                   default=DATASET_SUBDIR_DEFAULT,
                   help="Subdirectory for the Onera dataset")
    p.add_argument("--synthetic-data-dir", type=str,
                   default=SYNTHETIC_DATA_DIR_DEFAULT,
                   help="Directory for synthetic data")
    p.add_argument("--checkpoint-dir", type=str,
                   default="siamese_checkpoints",
                   help="Directory to save model checkpoints")
    p.add_argument("--batch-size", type=int, default=4,
                   help="Training batch size")
    p.add_argument("--num-epochs", type=int, default=50,
                   help="Number of training epochs")
    p.add_argument("--learning-rate", type=float,
                   default=0.00010152447097322304,
                   help="Initial learning rate")
    p.add_argument("--target-size", type=str, default="128x128",
                   help="Target image size HxW (e.g., 128x128)")
    p.add_argument("--save-every", type=int, default=5,
                   help="Save checkpoint every N epochs")
    p.add_argument("--use-synthetic", action="store_true",
                   help="Include synthetic data during training")
    p.add_argument("--resume", action="store_true",
                   help="resume from <checkpoint-dir>/last_state.pth")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the model init and the epoch order")
    p.add_argument("--compute-dtype", type=str, default="bfloat16",
                   choices=list(COMPUTE_DTYPES),
                   help="model compute dtype (params stay float32)")
    p.add_argument("--early-stop", type=int, default=0, metavar="N",
                   help="stop after N consecutive epochs without "
                        "validation-loss improvement (0 = off)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    p.add_argument("--tune", action="store_true",
                   help="Run hyperparameter tuning")
    p.add_argument("--n-trials", type=int, default=50,
                   help="[extension] number of tuning trials for --tune")
    p.add_argument("--parallel-trials", type=int, default=1,
                   help="[extension] run N trials concurrently: the "
                        "devices of --device's kind (every card; under "
                        "torchrun, every rank) split into N partitions of "
                        "devices // N, each trial data-parallel over its "
                        "partition (one worker thread a card with "
                        "--no-data-parallel)")
    p.add_argument("--augment", action="store_true",
                   help="joint augmentation of the training pairs (the "
                        "reference augments only under --tune)")
    p.add_argument("--native-aug", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="with --augment, augment each pair at its native "
                        "resolution and resize to the target size as "
                        "chain step 5 (the reference's order; default); "
                        "--no-native-aug augments the target-size cache")
    p.add_argument("--fused-loss", action="store_true",
                   help="accepted for the JAX package's command lines; "
                        "on the card the loss always runs the fused "
                        "FocalDice kernels")
    p.add_argument("--pallas-augment", action="store_true", default=None,
                   help="accepted for the JAX package's command lines; "
                        "on the card augmentation always runs the "
                        "photometric kernels")
    p.add_argument("--no-pallas-augment", dest="pallas_augment",
                   action="store_false",
                   help="accepted for the JAX package's command lines, as "
                        "--pallas-augment")
    p.add_argument("--no-data-parallel", action="store_true",
                   help="train on one device (default: data-parallel over "
                        "every visible card, one process a card; under "
                        "torchrun, over its ranks); with --tune, one "
                        "worker thread a card")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="accepted for the JAX package's command lines; "
                        "the port has no compilation cache")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="[extension] write a torch.profiler trace + "
                        "per-step timing stats")
    p.add_argument("--debug-nans", action="store_true",
                   help="[extension] check each step's loss and gradients "
                        "for NaN/Inf (raises naming the step)")
    p.add_argument("--defer-best-ckpt", action="store_true",
                   help="[extension] keep the best model as a device "
                        "snapshot; write best_model.pth on the save-every "
                        "cadence instead of every improving epoch (avoids "
                        "~165 MB device->host pulls per improvement)")
    p.add_argument("--async-ckpt", action="store_true",
                   help="[extension] write checkpoints on a background "
                        "thread (device-side snapshot first; the "
                        "device->host pull overlaps later epochs)")
    p.add_argument("--log-jsonl", type=str, default=None,
                   help="[extension] append machine-readable run events "
                        "(run_start/epoch/checkpoint/preemption/run_end) "
                        "as one JSON object per line to this file; "
                        "--resume appends to the same file")
    p.add_argument("--stream", type=str, default="hbm",
                   choices=["hbm", "host", "decode"],
                   help="[extension] train-data placement: 'hbm' keeps the "
                        "decoded corpus device-resident (default, fastest "
                        "for small corpora); 'host' keeps it in host memory "
                        "and copies batches to the device per step, "
                        "prefetched (corpora larger than the card); "
                        "'decode' re-decodes batches on demand (larger than "
                        "host memory)")
    p.add_argument("--batched-encoder", action="store_true",
                   help="[extension] run the shared Siamese encoder as one "
                        "2B-batch pass (train-mode BN stats become joint "
                        "over both images)")
    p.add_argument("--concat-free", action="store_true",
                   help="[extension] decoder fast path: skip-concats stay "
                        "as slice tuples consumed by kernel-sliced convs "
                        "(no concatenates in device memory; numerically "
                        "equivalent)")
    p.add_argument("--momentum-dtype", type=str, default=None,
                   choices=list(MOMENTUM_DTYPES),
                   help="[extension] dtype for Adam's first-moment state "
                        "(default: param dtype, torch-exact; bfloat16 "
                        "halves one optimizer state tensor's memory "
                        "traffic)")
    p.add_argument("--flat-opt-state", action="store_true",
                   help="[extension] run the optimizer update on one "
                        "concatenated vector (optax.flatten): 2 large "
                        "moment buffers instead of ~200 small ones; same "
                        "arithmetic, different opt-state checkpoint layout")
    p.add_argument("--remat", action="store_true",
                   help="[extension] rematerialize U-Net block activations "
                        "in the backward pass (torch.utils.checkpoint): "
                        "fits larger batches/resolutions in device memory "
                        "for ~1/3 more conv FLOPs; identical math")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="[extension] average gradients over K steps and "
                        "apply one optimizer update (emulates "
                        "batch-size*K beyond device memory; BN stats stay "
                        "per-mini-batch)")
    return p


def main(argv: Optional[List[str]] = None) -> Optional[Dict]:
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        target_size = parse_target_size(args.target_size)
    except ValueError:
        print("Error: target_size must be in format HxW (e.g., 128x128)")
        return None
    data_cfg = DataConfig(
        root_dir=args.root_dir,
        dataset_subdir=args.dataset_subdir,
        synthetic_data_dir=args.synthetic_data_dir,
        target_size=target_size,
        use_synthetic=args.use_synthetic,
        augment=args.augment,
        native_aug=args.native_aug,
        stream=args.stream,
    )
    if args.tune:
        if args.stream != "hbm":
            print(
                "--stream applies only to main training; tuning trials "
                "use the HBM-resident cache (their datasets are rebuilt "
                "per trial at tuning batch sizes)."
            )
        from ..parallel.mesh import LaunchError
        from ..tune import run_tuning

        try:
            return run_tuning(data_cfg, n_trials=args.n_trials,
                              n_parallel=args.parallel_trials,
                              native_aug=args.native_aug, device=args.device,
                              data_parallel=not args.no_data_parallel)
        except LaunchError as e:
            parser.error(str(e))
    train_cfg = SiameseTrainConfig(
        batch_size=args.batch_size,
        num_epochs=args.num_epochs,
        learning_rate=args.learning_rate,
        checkpoint_dir=args.checkpoint_dir,
        save_every=args.save_every,
        seed=args.seed,
        compute_dtype=args.compute_dtype,
        resume=args.resume,
        early_stop_patience=args.early_stop,
        defer_best_ckpt=args.defer_best_ckpt,
        async_ckpt=args.async_ckpt,
        profile_dir=args.profile_dir,
        debug_nans=args.debug_nans,
        log_jsonl=args.log_jsonl,
        batched_encoder=args.batched_encoder,
        concat_free=args.concat_free,
        remat=args.remat,
        opt_momentum_dtype=args.momentum_dtype,
        opt_flat_state=args.flat_opt_state,
        grad_accum=args.grad_accum,
        data_parallel=not args.no_data_parallel,
    )
    from ..parallel.mesh import LaunchError, launch

    # By its importable name, so that a spawned worker can unpickle it.
    train = importlib.import_module(__spec__.name).train
    try:
        return launch(train, (data_cfg, train_cfg, args.device),
                      data_parallel=train_cfg.data_parallel,
                      device=args.device)
    except LaunchError as e:
        parser.error(str(e))


def train(data_cfg: DataConfig, train_cfg: SiameseTrainConfig, device):
    """``pipelines.run_siamese_training`` on one rank (or alone); a resume
    state of another optimizer layout exits 2 naming both."""
    from .. import pipelines

    try:
        return pipelines.run_siamese_training(data_cfg, train_cfg,
                                              device=device)
    except ResumeStateError as e:
        build_parser().error(str(e))


if __name__ == "__main__":
    # run_siamese_training returns None when the train split is empty; a
    # study is returned by --tune.
    raise SystemExit(0 if main() is not None else 1)
