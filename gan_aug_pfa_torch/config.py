"""Configuration (own copy of the JAX package's ``config.py``: the OSCD
city list and split, directory names, and the fields that evaluation and
Siamese training read, with the same defaults).  The JAX package's
TPU-only knobs (mesh, remat, flat optimizer state and so on) are not
ported."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# The OSCD city list (reference dataset.py:299-301).
ALL_CITIES = [
    "abudhabi", "aguasclaras", "beihai", "beirut", "bercy", "bordeaux",
    "cupertino", "hongkong", "mumbai", "nantes", "paris", "pisa", "rennes",
    "saclay_e",
]
VAL_CITIES = ["pisa", "rennes", "saclay_e"]
TRAIN_CITIES = [c for c in ALL_CITIES if c not in VAL_CITIES]

# Nested OSCD directory names (reference dataset.py:302-304).
DATASET_SUBDIR_DEFAULT = "Onera Satellite Change Detection Dataset"
IMAGES_SUBTREE = ("images", "Onera Satellite Change Detection dataset - Images")
LABELS_SUBTREE = (
    "train_labels",
    "Onera Satellite Change Detection dataset - Train Labels",
)
SYNTHETIC_DATA_DIR_DEFAULT = "synthetic_data"


@dataclasses.dataclass
class DataConfig:
    root_dir: str = "."
    dataset_subdir: str = DATASET_SUBDIR_DEFAULT
    synthetic_data_dir: str = SYNTHETIC_DATA_DIR_DEFAULT
    target_size: Tuple[int, int] = (128, 128)
    use_synthetic: bool = False
    # Joint augmentation of the train split (data/transforms.py).
    augment: bool = False
    # Augment each sample at its native resolution and resize to target as
    # chain step 5 (the reference's order, dataset.py:172-193); False
    # augments the target-size cache instead.  Read only with augment.
    native_aug: bool = True


@dataclasses.dataclass
class SiameseTrainConfig:
    """Defaults mirror reference train.py:24-31, 294-296, 330-336."""

    batch_size: int = 4
    num_epochs: int = 50
    learning_rate: float = 0.00010152447097322304
    weight_decay: float = 1.1180726948943663e-05
    # Frozen tuned FocalDiceLoss constants (reference train.py:294).
    focal_alpha: float = 0.6030489822904476
    focal_gamma: float = 1.7930869982898021
    loss_beta: float = 0.6699803915247974
    dice_smooth: float = 1.956571276926647e-06
    optimizer: str = "adamw"
    checkpoint_dir: str = "siamese_checkpoints"
    save_every: int = 5
    # ReduceLROnPlateau (reference train.py:296).
    plateau_factor: float = 0.2
    plateau_patience: int = 7
    # Stop after N consecutive epochs without val-loss improvement (0 =
    # off: always run the full epoch budget, as the reference does).
    early_stop_patience: int = 0
    n_channels: int = 3
    n_classes: int = 1
    seed: int = 0
    # "bfloat16" runs the model under bf16 autocast with fp32 params;
    # "float32" runs it in full float32 with TF32 off.
    compute_dtype: str = "bfloat16"
    # Continue from <checkpoint_dir>/last_state.pth when it exists.
    resume: bool = False


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
