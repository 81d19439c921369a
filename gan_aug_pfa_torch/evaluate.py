"""Evaluate the change-detection model: every OSCD city's metrics and
visualizations, or one image pair.

    python -m gan_aug_pfa_torch.evaluate --root-dir <root> [--json-out F]
    python -m gan_aug_pfa_torch.evaluate --image1-path P --image2-path P
        --city-name N [--label-path P]

Flag names and defaults are the root ``evaluate.py``'s; ``--device``
(default ``cuda``) picks the device.  ``--checkpoint-path`` and each
``--ensemble`` checkpoint take the port's ``.pth`` or a JAX package
``.msgpack`` (model-only or a full train state).
``--serving-artifact`` evaluates an artifact of ``python -m
gan_aug_pfa_torch.export_model`` in place of a checkpoint; it computes in
the dtype it was exported with, and single-pair evaluation ignores it, as
the JAX package's does.  The panels need matplotlib; without it one line
says they were skipped.  ``--stream host|decode`` keeps the corpus off the
device, one batch there at a time (``data/stream.py``); single-pair
evaluation ignores it.  ``--no-compile-cache`` is accepted so that the JAX
package's command lines run unchanged.
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

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate Change Detection Model")
    p.add_argument("--image1-path", type=str,
                   help="Path to the first image (before change)")
    p.add_argument("--image2-path", type=str,
                   help="Path to the second image (after change)")
    p.add_argument("--label-path", type=str, default=None,
                   help="Optional path to the ground truth change mask")
    p.add_argument("--city-name", type=str,
                   help="Name of the city/area for identification in output")
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
    p.add_argument("--num-visualizations", type=int, default=5)
    p.add_argument("--post-process", action="store_true",
                   help="Morphological opening+closing on predictions "
                        "(the reference README's Step 6, implemented)")
    p.add_argument("--post-process-kernel", type=int, default=3,
                   help="Structuring-element side for --post-process")
    p.add_argument("--ensemble", type=str, nargs="+", default=None,
                   metavar="CKPT",
                   help="Two or more checkpoints to ensemble by averaging "
                        "sigmoid probabilities (the reference README's "
                        "Step 7, implemented)")
    p.add_argument("--threshold", type=float, default=0.5,
                   help="decision threshold for the metrics")
    p.add_argument("--threshold-sweep", action="store_true",
                   help="also report macro-F1/IoU over a 0.05..0.95 "
                        "threshold grid and the best operating point")
    p.add_argument("--json-out", type=str, default=None,
                   help="also write the full metrics report (overall + "
                        "per-city means + sweep) as one JSON file at this "
                        "path")
    p.add_argument("--compute-dtype", type=str, default="bfloat16",
                   choices=list(COMPUTE_DTYPES),
                   help="model compute dtype for evaluation")
    p.add_argument("--serving-artifact", type=str, default=None,
                   help="Evaluate an exported artifact (python -m "
                        "gan_aug_pfa_torch.export_model) instead of a "
                        "checkpoint; it computes in its exported dtype")
    p.add_argument("--serving-aot", type=str, default="auto",
                   choices=["auto", "never", "require"],
                   help="executable-sidecar policy for --serving-artifact: "
                        "auto serves the batch sizes of a usable sidecar "
                        "(export_model --aot-batch-sizes) through it, "
                        "require fails without one, never ignores it")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="accepted for the JAX package's command lines; "
                        "the port has no compilation cache")
    p.add_argument("--stream", type=str, default="hbm",
                   choices=["hbm", "host", "decode"],
                   help="[extension] corpus placement: 'hbm' puts the "
                        "whole corpus on the device (default); 'host' "
                        "keeps it in host memory, copying a batch at a "
                        "time; 'decode' re-decodes each batch (corpora "
                        "beyond host memory)")
    return p


def main(argv: Optional[List[str]] = None) -> Optional[Dict]:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.ensemble is not None and len(args.ensemble) < 2:
        parser.error(
            "--ensemble needs two or more checkpoints; for a single "
            "checkpoint use --checkpoint-path"
        )
    target_size = parse_target_size(args.target_size)
    data_cfg = DataConfig(root_dir=args.root_dir,
                          dataset_subdir=args.dataset_subdir,
                          target_size=target_size, stream=args.stream)
    eval_cfg = EvalConfig(
        batch_size=args.batch_size,
        target_size=target_size,
        checkpoint_path=args.checkpoint_path,
        output_dir=args.output_dir,
        num_visualizations=args.num_visualizations,
        post_process=args.post_process,
        post_process_kernel=args.post_process_kernel,
        ensemble_paths=tuple(args.ensemble) if args.ensemble else None,
        threshold=args.threshold,
        threshold_sweep=args.threshold_sweep,
        json_out=args.json_out,
        compute_dtype=args.compute_dtype,
        serving_artifact=args.serving_artifact,
        serving_aot=args.serving_aot,
    )
    from . import pipelines

    if args.image1_path and args.image2_path and args.city_name:
        print(f"Evaluating single image pair for city: {args.city_name}")
        return pipelines.evaluate_single_pair(
            data_cfg, eval_cfg, args.image1_path, args.image2_path,
            args.city_name, label_path=args.label_path, device=args.device)
    return pipelines.run_evaluation(data_cfg, eval_cfg, device=args.device)


if __name__ == "__main__":
    # Both evaluations return None when an input or a checkpoint is missing.
    raise SystemExit(0 if main() is not None else 1)
