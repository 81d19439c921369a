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
the JAX package's note).  Flags of paths not ported yet (below), and
``--resume`` from a JAX train state in an optax layout not ported yet,
exit 2 with "not ported yet".
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from ..config import (
    DATASET_SUBDIR_DEFAULT,
    SYNTHETIC_DATA_DIR_DEFAULT,
    DataConfig,
    SiameseTrainConfig,
    parse_target_size,
)
from ..checkpoint import ResumeNotPortedError, ResumeStateError
from .siamese import COMPUTE_DTYPES

# The root train.py's flags whose paths are not ported yet, with the value
# that leaves them off.
_NOT_PORTED = {
    "batched_encoder": False, "concat_free": False,
    "momentum_dtype": None, "flat_opt_state": False, "remat": False,
    "grad_accum": 1,
}


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
                   help="[extension] run N trials concurrently, one worker "
                        "a device (capped at the devices of --device's "
                        "kind)")
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
                   help="accepted for the JAX package's command lines; "
                        "the port trains on one device")
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
    not_ported = p.add_argument_group(
        "not ported yet (using one exits non-zero)")
    for flag in ("--batched-encoder", "--concat-free", "--flat-opt-state",
                 "--remat"):
        not_ported.add_argument(flag, action="store_true")
    not_ported.add_argument("--momentum-dtype", type=str, default=None)
    not_ported.add_argument("--grad-accum", type=int, default=1)
    return p


def main(argv: Optional[List[str]] = None) -> Optional[Dict]:
    parser = build_parser()
    args = parser.parse_args(argv)
    for name, off in _NOT_PORTED.items():
        if getattr(args, name) != off:
            parser.error(f"--{name.replace('_', '-')} is not ported yet")
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
        from ..tune import run_tuning

        return run_tuning(data_cfg, n_trials=args.n_trials,
                          n_parallel=args.parallel_trials,
                          native_aug=args.native_aug, device=args.device)
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
    )
    from .. import pipelines

    try:
        return pipelines.run_siamese_training(data_cfg, train_cfg,
                                              device=args.device)
    except (ResumeNotPortedError, ResumeStateError) as e:
        parser.error(str(e))


if __name__ == "__main__":
    # run_siamese_training returns None when the train split is empty; a
    # study is returned by --tune.
    raise SystemExit(0 if main() is not None else 1)
