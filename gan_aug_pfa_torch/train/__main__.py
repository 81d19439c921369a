"""Train the Siamese Attention U-Net for change detection.

    python -m gan_aug_pfa_torch.train --root-dir <root> [--num-epochs N]

Flag names are the root ``train.py``'s.  ``--device`` (default ``cuda``)
picks the device; without a card the run raises unless ``--device cpu``
is given.  ``--augment`` turns on joint augmentation, at native
resolution unless ``--no-native-aug``.  ``--fused-loss`` and
``--[no-]pallas-augment`` are accepted so that the JAX package's command
lines run unchanged: on the card the loss always runs the fused kernels
and augmentation the photometric kernels.  Flags of paths not ported yet
(``--tune``, ``--stream`` and the others below) exit non-zero with "not
ported yet".
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
from .siamese import COMPUTE_DTYPES

# The root train.py's flags whose paths are not ported yet, with the value
# that leaves them off.
_NOT_PORTED = {
    "tune": False, "stream": "hbm", "n_trials": None,
    "parallel_trials": None, "batched_encoder": False, "profile_dir": None,
    "debug_nans": False, "concat_free": False, "momentum_dtype": None, "flat_opt_state": False,
    "defer_best_ckpt": False, "remat": False, "grad_accum": 1,
    "async_ckpt": False, "log_jsonl": None,
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
    not_ported = p.add_argument_group(
        "not ported yet (using one exits non-zero)")
    for flag in ("--tune", "--batched-encoder", "--debug-nans",
                 "--concat-free", "--flat-opt-state", "--defer-best-ckpt",
                 "--remat", "--async-ckpt"):
        not_ported.add_argument(flag, action="store_true")
    not_ported.add_argument("--stream", type=str, default="hbm")
    not_ported.add_argument("--n-trials", type=int, default=None)
    not_ported.add_argument("--parallel-trials", type=int, default=None)
    not_ported.add_argument("--profile-dir", type=str, default=None)
    not_ported.add_argument("--momentum-dtype", type=str, default=None)
    not_ported.add_argument("--grad-accum", type=int, default=1)
    not_ported.add_argument("--log-jsonl", type=str, default=None)
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
    )
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
    )
    from .. import pipelines

    return pipelines.run_siamese_training(data_cfg, train_cfg,
                                          device=args.device)


if __name__ == "__main__":
    # run_siamese_training returns None when the train split is empty.
    raise SystemExit(0 if main() is not None else 1)
