"""End-to-end pipelines.  Ported so far: evaluation (the JAX package's
``pipelines.run_evaluation``, pipelines.py:755-991), on the cached path.

Not ported yet: visualizations, ``--post-process``, ``--ensemble``,
``--threshold-sweep``, ``--stream``, serving artifacts and single-pair
evaluation.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from . import checkpoint as ckpt
from .config import DataConfig, EvalConfig
from .data.loader import CachedDataset, build_cached_dataset
from .data.scanner import create_sample_lists
from .device import resolve_device
from .metrics import METRIC_KEYS, metrics_from_counts
from .models.siamese_unet import SiameseUNet
from .ops.kernels.confusion_counts import confusion_counts_batch
from .train.siamese import predict


@dataclasses.dataclass
class DeviceCache:
    """The cached dataset on the device: images NCHW float32 in [0, 1],
    labels (N, H, W) float32 in {0, 1}."""

    img1: torch.Tensor
    img2: torch.Tensor
    labels: torch.Tensor

    @classmethod
    def from_dataset(cls, ds: CachedDataset, device) -> "DeviceCache":
        def images(a):
            return torch.from_numpy(a).to(device).permute(0, 3, 1, 2)

        return cls(images(ds.img1).contiguous(), images(ds.img2).contiguous(),
                   torch.from_numpy(ds.labels).to(device, torch.float32))

    def __len__(self) -> int:
        return self.img1.shape[0]


def evaluate_cached(model: torch.nn.Module, cache: DeviceCache,
                    cities: List[str], eval_cfg: EvalConfig) -> Dict:
    """Per-sample metrics over contiguous batches of the device cache,
    accumulated overall and per city in sample order (pipelines.py:872-916).
    Returns the sums, the per-city sample counts, and each sample's
    (tp, fp, fn, tn) as an (N, 4) array."""
    bs = eval_cfg.batch_size
    total = {k: 0.0 for k in METRIC_KEYS}
    per_city: Dict[str, Dict[str, float]] = {}
    per_city_counts: Dict[str, int] = {}
    counts = []
    for start in range(0, len(cache), bs):
        stop = min(start + bs, len(cache))
        probs = predict(
            model, cache.img1[start:stop].permute(0, 2, 3, 1),
            cache.img2[start:stop].permute(0, 2, 3, 1),
            eval_cfg.compute_dtype,
        )[..., 0]
        c = confusion_counts_batch(probs, cache.labels[start:stop],
                                   eval_cfg.threshold)
        m = metrics_from_counts(c[:, 0], c[:, 1], c[:, 2], c[:, 3])
        # One device->host copy per batch: the metrics and the counts.
        host = torch.cat(
            [torch.stack([m[k] for k in METRIC_KEYS], dim=1), c], dim=1
        ).cpu().numpy()
        counts.append(host[:, len(METRIC_KEYS):])
        for k_in_batch, sample_i in enumerate(range(start, stop)):
            city = cities[sample_i]
            if city not in per_city:
                per_city[city] = {k: 0.0 for k in METRIC_KEYS}
                per_city_counts[city] = 0
            for j, key in enumerate(METRIC_KEYS):
                v = float(host[k_in_batch, j])
                per_city[city][key] += v
                total[key] += v
            per_city_counts[city] += 1
    return {
        "total": total, "per_city": per_city,
        "per_city_counts": per_city_counts,
        "counts": (np.concatenate(counts) if counts
                   else np.zeros((0, 4), np.float32)),
    }


def run_evaluation(
    data_cfg: DataConfig,
    eval_cfg: EvalConfig,
    verbose: bool = True,
    device="cuda",
) -> Optional[Dict]:
    """Evaluate ``best_model.pth`` (or ``eval_cfg.checkpoint_path``) over
    every OSCD city.  Returns overall and per-city macro means, per-city
    sample counts, ``sweep`` (None: not ported) and each sample's confusion
    counts; None when no samples or no checkpoint are found."""
    dev = resolve_device(device)
    output_dir = os.path.join(data_cfg.root_dir, eval_cfg.output_dir)
    os.makedirs(output_dir, exist_ok=True)

    # The reference evaluates ALL cities despite 'validation' naming
    # (evaluate.py:315-320) — quirk preserved.
    samples = create_sample_lists(
        data_cfg.root_dir, data_cfg.dataset_subdir, verbose=verbose
    )
    if not samples:
        print("Error: No validation samples found. Check dataset paths and "
              "structure.")
        return None
    ds = build_cached_dataset(samples, eval_cfg.target_size, verbose=verbose)

    checkpoint_path = eval_cfg.checkpoint_path or os.path.join(
        data_cfg.root_dir, "siamese_checkpoints",
        ckpt.checkpoint_name("best_model"),
    )
    if not os.path.exists(checkpoint_path):
        print(f"Error: Checkpoint file not found at {checkpoint_path}")
        return None
    # The batched encoder computes the same eval-mode function as the
    # two-pass form in one pass over 2B images.
    model = SiameseUNet(eval_cfg.n_channels, eval_cfg.n_classes,
                        batched_encoder=True)
    ckpt.restore_model_only(checkpoint_path, model)
    model.to(dev).eval()

    acc = evaluate_cached(model, DeviceCache.from_dataset(ds, dev),
                          ds.cities, eval_cfg)
    total, per_city = acc["total"], acc["per_city"]
    per_city_counts = acc["per_city_counts"]
    n = sum(per_city_counts.values())
    overall = {k: v / n for k, v in total.items()} if n else {}
    if verbose:
        print("\n--- Overall Evaluation Metrics ---")
        for k, v in overall.items():
            print(f"{k.capitalize()}: {v:.4f}")
        print("\n--- Per-City Evaluation Metrics ---")
        for city, m in per_city.items():
            c = per_city_counts[city]
            print(f"City: {city} (Samples: {c})")
            for k in METRIC_KEYS:
                print(f"  {k.capitalize()}: {m[k] / c:.4f}")
    if eval_cfg.json_out:
        # The JAX package's report keys (pipelines.py:969-983).
        report = {
            "n_samples": n,
            "threshold": eval_cfg.threshold,
            "checkpoints": [checkpoint_path],
            "post_process": False,
            "overall": overall,
            "per_city": {
                city: {k: m[k] / per_city_counts[city] for k in METRIC_KEYS}
                for city, m in per_city.items()
            },
            "per_city_counts": per_city_counts,
            "sweep": None,
        }
        parent = os.path.dirname(os.path.abspath(eval_cfg.json_out))
        os.makedirs(parent, exist_ok=True)
        with open(eval_cfg.json_out, "w") as f:
            json.dump(report, f, indent=1)
        if verbose:
            print(f"Metrics report written to {eval_cfg.json_out}")
    return {"overall": overall, "per_city": per_city,
            "per_city_counts": per_city_counts, "sweep": None,
            "counts": acc["counts"]}
