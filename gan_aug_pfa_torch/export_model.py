"""Export a checkpoint as a self-contained serving artifact (the root
``export_model.py``'s CLI, with ``torch.export`` in place of
``jax.export``).

    python -m gan_aug_pfa_torch.export_model \
        --checkpoint-path siamese_checkpoints/best_model.pth \
        --output artifacts/siamese_serve.pt2 --platform cuda cpu

The checkpoint is the port's ``.pth`` or a JAX package ``.msgpack``
(model-only or a full train state).  The artifact loads with
``gan_aug_pfa_torch.serve.load_serving_fn`` and no model code, and
``evaluate``/``generate_synthetic --serving-artifact`` take it in place of
a checkpoint.  Flag names and defaults are the root CLI's, except that
``--platform`` takes ``cuda`` and ``cpu`` and ``--backend`` (``cuda`` by
default) is the device the export runs on.  ``--aot-batch-sizes B1,B2``
then compiles the artifact's executable sidecar on that device
(``serve.compile_artifact``: one AOTInductor package a batch size), as
``python -m gan_aug_pfa_torch.serve ARTIFACT B1,B2`` does on its own.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from .config import parse_target_size


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Export a trained model as a serving artifact")
    p.add_argument("--checkpoint-path", type=str, required=True,
                   help=".pth (the port's or the reference's) or a JAX "
                        "package .msgpack")
    p.add_argument("--arch", type=str, default=None,
                   choices=["siamese", "generator", "discriminator"],
                   help="Inferred from the checkpoint stem if omitted")
    p.add_argument("--output", type=str, default=None,
                   help="Artifact path (default: <checkpoint>.pt2)")
    p.add_argument("--target-size", type=str, default=None,
                   help="HxW the model will serve at (default: 128x128 for "
                        "siamese, 256x256 for GAN archs)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="Fix the batch dimension (default: dynamic)")
    p.add_argument("--platform", type=str, nargs="+", default=None,
                   metavar="P", choices=["cuda", "cpu"],
                   help="Device type(s) the artifact may be loaded on: cuda "
                        "and/or cpu (default: the --backend device's)")
    p.add_argument("--n-channels", type=int, default=3)
    p.add_argument("--num-downs", type=int, default=7,
                   help="generator U-Net depth; must match the checkpoint")
    p.add_argument("--ngf", type=int, default=64,
                   help="generator base filter count; must match the "
                        "checkpoint")
    p.add_argument("--ndf", type=int, default=64,
                   help="discriminator base filter count; must match the "
                        "checkpoint")
    p.add_argument("--n-layers", type=int, default=3,
                   help="discriminator depth; must match the checkpoint")
    p.add_argument("--compute-dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="Dtype the forward computes in inside the artifact")
    p.add_argument("--quantize", type=str, default=None, choices=["int8"],
                   help="Weight-only quantization: int8 = symmetric "
                        "per-output-channel conv weights, fp activations "
                        "(see gan_aug_pfa_torch/quantize.py)")
    p.add_argument("--backend", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="Device the export runs on")
    p.add_argument("--aot-batch-sizes", type=str, default=None,
                   metavar="B1,B2",
                   help="After exporting, compile the artifact ahead of "
                        "time at these batch sizes on the --backend device "
                        "and write the executable sidecar (<output>.aotc "
                        "and one AOTInductor package a batch size); serving "
                        "processes then run those batch sizes without the "
                        "exported program.  The sidecar is bound to the "
                        "device, torch and CUDA: run this on the deployment "
                        "host (also standalone: python -m "
                        "gan_aug_pfa_torch.serve ARTIFACT B1,B2)")
    return p


def main(argv: Optional[List[str]] = None) -> str:
    """Returns the artifact's path."""
    parser = build_parser()
    args = parser.parse_args(argv)
    from . import checkpoint as ckpt
    from . import serve

    aot_sizes = None
    if args.aot_batch_sizes:
        try:
            aot_sizes = serve.parse_batch_sizes(args.aot_batch_sizes)
        except ValueError as e:
            parser.error(f"--aot-batch-sizes: {e}")

    arch = args.arch or serve.arch_from_stem(args.checkpoint_path)
    if arch is None:
        raise SystemExit(
            f"cannot infer --arch from {args.checkpoint_path!r} "
            "(expected a best_model/model_epoch_N/generator_epoch_N/"
            "discriminator_epoch_N stem); pass --arch explicitly"
        )
    if args.target_size:
        h, w = parse_target_size(args.target_size)
    else:
        h, w = (128, 128) if arch == "siamese" else (256, 256)
    if arch == "generator":
        arch_kwargs = {"num_downs": args.num_downs, "ngf": args.ngf}
    elif arch == "discriminator":
        arch_kwargs = {"ndf": args.ndf, "n_layers": args.n_layers}
    else:
        arch_kwargs = {}

    model = serve._build_model(arch, args.n_channels, arch_kwargs)
    ckpt.restore_model_only(args.checkpoint_path, model)
    platforms = args.platform or [args.backend]
    print(f"Exporting {arch} at {h}x{w} "
          f"(batch={'dynamic' if args.batch_size is None else args.batch_size}"
          f", platforms={platforms}, compute={args.compute_dtype}"
          f"{', quantize=' + args.quantize if args.quantize else ''})")
    meta = {
        "arch": arch,
        "target_size": [h, w],
        "n_channels": args.n_channels,
        "source_checkpoint": os.path.abspath(args.checkpoint_path),
        "arch_kwargs": arch_kwargs,
        "quantize": args.quantize,
        "quantize_report": None,
    }
    kwargs = dict(n_channels=args.n_channels, batch_size=args.batch_size,
                  platforms=platforms, compute_dtype=args.compute_dtype,
                  arch_kwargs=arch_kwargs, device=args.backend)
    if args.quantize == "int8":
        exported, _, report = serve.export_model_quantized(
            arch, model.state_dict(), h, w, **kwargs)
        meta["quantize_report"] = report
        print(f"  int8 weight-only: {report['quantized']} tensors "
              f"quantized ({report['bytes_fp'] / 1e6:.1f} MB fp32 -> "
              f"{report['bytes_q'] / 1e6:.1f} MB), "
              f"{report['kept_fp']} kept fp")
    else:
        exported = serve.export_model(arch, model.state_dict(), h, w,
                                      **kwargs)
    out = args.output or os.path.splitext(args.checkpoint_path)[0] + ".pt2"
    serve.save_artifact(out, exported, meta)
    print(f"Saved serving artifact to {out} "
          f"({os.path.getsize(out) / 1e6:.1f} MB)")
    if aot_sizes:
        print(f"AOT-compiling for batch sizes {aot_sizes} on "
              f"{args.backend} ...")
        serve.compile_artifact(out, aot_sizes, device=args.backend)
    return out


if __name__ == "__main__":
    main()
