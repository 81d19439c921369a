"""Evaluate the change-detection model over every OSCD city.

    python -m gan_aug_pfa_torch.evaluate --root-dir <root> [--json-out F]

Flag names are the root ``evaluate.py``'s; ``--device`` (default
``cuda``) picks the device.  ``--checkpoint-path`` takes the port's
``.pth`` or a JAX package ``.msgpack`` (model-only or a full train
state).  The root CLI's flags of paths not ported yet
(single-pair evaluation, visualizations, ``--post-process``,
``--ensemble``, ``--threshold-sweep``, ``--stream`` and serving artifacts)
are accepted with the value that leaves their path off; any other value
exits non-zero with "not ported yet".  ``--no-compile-cache`` is accepted
so that the JAX package's command lines run unchanged.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from .config import (
    DATASET_SUBDIR_DEFAULT,
    DataConfig,
    EvalConfig,
    parse_target_size,
)
from .train.siamese import COMPUTE_DTYPES

# The root evaluate.py's flags whose paths are not ported yet, with the
# value that leaves them off.
_NOT_PORTED = {
    "image1_path": None, "image2_path": None, "label_path": None,
    "city_name": None, "num_visualizations": 0, "post_process": False,
    "post_process_kernel": 3, "ensemble": None, "threshold_sweep": False,
    "stream": "hbm", "serving_artifact": None, "serving_aot": "auto",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate Change Detection Model")
    p.add_argument("--root-dir", type=str, default=".")
    p.add_argument("--dataset-subdir", type=str,
                   default=DATASET_SUBDIR_DEFAULT)
    p.add_argument("--checkpoint-path", type=str, default=None,
                   help="Model checkpoint, a .pth or a JAX package "
                        ".msgpack (default "
                        "<root>/siamese_checkpoints/best_model.pth)")
    p.add_argument("--output-dir", type=str, default="evaluation_results")
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--target-size", type=str, default="128x128",
                   help="Must match the size used for training")
    p.add_argument("--threshold", type=float, default=0.5,
                   help="decision threshold for the metrics")
    p.add_argument("--json-out", type=str, default=None,
                   help="also write the metrics report (overall + per-city "
                        "means) as one JSON file at this path")
    p.add_argument("--compute-dtype", type=str, default="bfloat16",
                   choices=list(COMPUTE_DTYPES),
                   help="model compute dtype for evaluation")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="accepted for the JAX package's command lines; "
                        "the port has no compilation cache")
    not_ported = p.add_argument_group(
        "not ported yet (a value other than the default exits non-zero)")
    for flag in ("--image1-path", "--image2-path", "--label-path",
                 "--city-name", "--serving-artifact"):
        not_ported.add_argument(flag, type=str, default=None)
    not_ported.add_argument("--num-visualizations", type=int, default=0)
    not_ported.add_argument("--post-process", action="store_true")
    not_ported.add_argument("--post-process-kernel", type=int, default=3)
    not_ported.add_argument("--ensemble", type=str, nargs="+", default=None,
                            metavar="CKPT")
    not_ported.add_argument("--threshold-sweep", action="store_true")
    not_ported.add_argument("--stream", type=str, default="hbm")
    not_ported.add_argument("--serving-aot", type=str, default="auto")
    return p


def main(argv: Optional[List[str]] = None) -> Optional[Dict]:
    parser = build_parser()
    args = parser.parse_args(argv)
    for name, off in _NOT_PORTED.items():
        if getattr(args, name) != off:
            parser.error(f"--{name.replace('_', '-')} is not ported yet")
    target_size = parse_target_size(args.target_size)
    data_cfg = DataConfig(root_dir=args.root_dir,
                          dataset_subdir=args.dataset_subdir)
    eval_cfg = EvalConfig(
        batch_size=args.batch_size,
        target_size=target_size,
        checkpoint_path=args.checkpoint_path,
        output_dir=args.output_dir,
        threshold=args.threshold,
        json_out=args.json_out,
        compute_dtype=args.compute_dtype,
    )
    from . import pipelines

    return pipelines.run_evaluation(data_cfg, eval_cfg, device=args.device)


if __name__ == "__main__":
    # run_evaluation returns None when it finds no samples or no checkpoint.
    raise SystemExit(0 if main() is not None else 1)
