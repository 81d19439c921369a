"""Configuration for the evaluation path (own copy of the JAX package's
``config.py``: the OSCD city list, directory names and the fields that
evaluation reads, with the same defaults)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# The OSCD city list (reference dataset.py:299-301).
ALL_CITIES = [
    "abudhabi", "aguasclaras", "beihai", "beirut", "bercy", "bordeaux",
    "cupertino", "hongkong", "mumbai", "nantes", "paris", "pisa", "rennes",
    "saclay_e",
]

# Nested OSCD directory names (reference dataset.py:302-304).
DATASET_SUBDIR_DEFAULT = "Onera Satellite Change Detection Dataset"
IMAGES_SUBTREE = ("images", "Onera Satellite Change Detection dataset - Images")
LABELS_SUBTREE = (
    "train_labels",
    "Onera Satellite Change Detection dataset - Train Labels",
)


@dataclasses.dataclass
class DataConfig:
    root_dir: str = "."
    dataset_subdir: str = DATASET_SUBDIR_DEFAULT


@dataclasses.dataclass
class EvalConfig:
    """Defaults mirror reference evaluate.py:15-28."""

    batch_size: int = 2
    target_size: Tuple[int, int] = (128, 128)
    checkpoint_path: Optional[str] = None
    output_dir: str = "evaluation_results"
    n_channels: int = 3
    n_classes: int = 1
    # Decision threshold for the metrics (the reference hardcodes 0.5).
    threshold: float = 0.5
    # Write the metrics report (overall + per-city means) as one JSON file.
    json_out: Optional[str] = None
    # "bfloat16" runs the model under bf16 autocast; "float32" runs it in
    # full float32 with TF32 off.
    compute_dtype: str = "bfloat16"


def parse_target_size(value: str) -> Tuple[int, int]:
    """Parse "HxW" target-size strings (reference train.py:263)."""
    h, w = map(int, value.split("x"))
    return (h, w)
