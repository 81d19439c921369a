"""Generate the synthetic training corpus with a trained Pix2Pix generator.

    python -m gan_aug_pfa_torch.generate_synthetic --root-dir <root> \
        [--generator-checkpoint-name generator_epoch_200.pth]

Flag names and defaults are the root ``generate_synthetic_data.py``'s
(256x256, batch 4, float32), with the default checkpoint named ``.pth``;
a generator the JAX package wrote (``generator_epoch_N.msgpack``,
``generator_ema_epoch_N.msgpack``, or the ``params`` of a
``last_generator.msgpack``) loads as well; ``--serving-artifact`` runs a
generator artifact of ``python -m gan_aug_pfa_torch.export_model`` in
place of the checkpoint.  ``--device`` (default ``cuda``) picks the
device; without a card the run raises unless ``--device cpu`` is given.
The output is the reference's layout:
``<synthetic-data-dir>/images/<city>/img{1,2}_synth_N.png`` and
``labels/<city>/cm_synth_N.png``, which ``python -m gan_aug_pfa_torch.train
--use-synthetic`` reads.  ``--stream host|decode`` keeps the corpus off the
device, one batch there at a time (``data/stream.py``); the PNGs are
written from a thread pool either way.  ``--no-compile-cache`` is
accepted for the JAX package's command lines.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from .config import (
    DATASET_SUBDIR_DEFAULT,
    SYNTHETIC_DATA_DIR_DEFAULT,
    DataConfig,
    GenerateConfig,
    parse_target_size,
)
from .train.siamese import COMPUTE_DTYPES

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Generate synthetic change data")
    p.add_argument("--root-dir", type=str, default=".")
    p.add_argument("--dataset-subdir", type=str,
                   default=DATASET_SUBDIR_DEFAULT)
    p.add_argument("--synthetic-data-dir", type=str,
                   default=SYNTHETIC_DATA_DIR_DEFAULT)
    p.add_argument("--gan-checkpoint-dir", type=str, default="gan_checkpoints")
    p.add_argument("--generator-checkpoint-name", type=str,
                   default="generator_epoch_200.pth",
                   help="generator checkpoint in --gan-checkpoint-dir: a "
                        ".pth or a JAX package .msgpack")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--target-size", type=str, default="256x256",
                   help="Must match GAN training size")
    p.add_argument("--compute-dtype", type=str, default="float32",
                   choices=list(COMPUTE_DTYPES),
                   help="generator inference dtype (float32 with TF32 off "
                        "by default, for PNGs comparable bit for bit)")
    p.add_argument("--num-downs", type=int, default=7,
                   help="generator U-Net depth; must match the checkpoint")
    p.add_argument("--ngf", type=int, default=64,
                   help="generator base filter count; must match the "
                        "checkpoint")
    p.add_argument("--serving-artifact", type=str, default=None,
                   help="Run an exported generator artifact (python -m "
                        "gan_aug_pfa_torch.export_model) instead of the "
                        "checkpoint")
    p.add_argument("--serving-aot", type=str, default="auto",
                   choices=["auto", "never", "require"],
                   help="executable-sidecar policy for --serving-artifact: "
                        "auto and never run the exported program; require "
                        "fails (the port writes no sidecar yet)")
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


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    target_size = parse_target_size(args.target_size)
    data_cfg = DataConfig(root_dir=args.root_dir,
                          dataset_subdir=args.dataset_subdir,
                          synthetic_data_dir=args.synthetic_data_dir,
                          target_size=target_size, stream=args.stream)
    gen_cfg = GenerateConfig(
        batch_size=args.batch_size,
        target_size=target_size,
        generator_checkpoint_name=args.generator_checkpoint_name,
        gan_checkpoint_dir=args.gan_checkpoint_dir,
        synthetic_data_dir=args.synthetic_data_dir,
        num_downs=args.num_downs,
        ngf=args.ngf,
        compute_dtype=args.compute_dtype,
        serving_artifact=args.serving_artifact,
        serving_aot=args.serving_aot,
    )
    from . import pipelines

    return pipelines.run_generate_synthetic(data_cfg, gen_cfg,
                                            device=args.device)


if __name__ == "__main__":
    # run_generate_synthetic returns 0 when it finds no sample or no
    # checkpoint.
    raise SystemExit(0 if main() else 1)
