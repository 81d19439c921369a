"""Configuration (own copy of the JAX package's ``config.py``: the OSCD
city list and split, directory names, and the fields that evaluation,
Siamese training, GAN training and synthesis read, with the same
defaults, the training knobs included).  Fields of the JAX package's
mesh, compilation cache and Pallas switches have no counterpart: the port
trains on one device and always runs its kernels."""

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
    # Data placement of training, GAN training, synthesis and evaluation
    # (data/stream.py): "hbm" decodes once and keeps the corpus on the
    # device; "host" keeps the decoded corpus in host memory and copies
    # each batch to the device; "decode" holds only file paths and decodes
    # each batch on demand (corpora larger than host memory).
    stream: str = "hbm"


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
    # Train data-parallel over every rank of the process group
    # (parallel/mesh.py; the CLIs start one rank a card); False: one device.
    data_parallel: bool = True
    # Continue from <checkpoint_dir>/last_state.pth when it exists.
    resume: bool = False
    # Keep the best model as a device copy of its state_dict and write
    # best_model.pth on the save_every cadence, at the last epoch, on
    # preemption and on early stop, instead of at every improvement.
    defer_best_ckpt: bool = False
    # Write checkpoints on a background thread from a device snapshot
    # (checkpoint.AsyncCheckpointWriter); the run waits for the last write
    # before it returns.
    async_ckpt: bool = False
    # Observability: a torch.profiler trace and per-step timing into this
    # directory; a finite check of each step's loss and gradients.
    profile_dir: Optional[str] = None
    debug_nans: bool = False
    # Machine-readable run log: one JSON object per event, appended per
    # line (utils/runlog.py).  --resume appends to the same file.
    log_jsonl: Optional[str] = None
    # The JAX package's training knobs (its config.py:104-144):
    # Both images through the shared encoder as one 2B-batch pass; the
    # train-mode BatchNorm statistics become joint over both images.
    batched_encoder: bool = False
    # Decoder skip concatenations kept as tuples of slices, which the
    # attention gates and the decoder's first convs take by slicing their
    # weights (models/blocks.sliced_conv2d).  The same function.
    concat_free: bool = False
    # Recompute each DoubleConv's activations in the backward
    # (torch.utils.checkpoint): less activation memory for about a third
    # more convolution work.  The same function and running statistics.
    remat: bool = False
    # Adam's first moment in this dtype ("bfloat16" stores it rounded
    # after each update; None or "float32": the parameters' dtype).
    opt_momentum_dtype: Optional[str] = None
    # The optimizer update over one flat buffer (optax.flatten's layout of
    # the moments; train/optim.py).  The same arithmetic.
    opt_flat_state: bool = False
    # Average the gradients of k mini-steps and apply one optimizer update
    # (optax.MultiSteps); BatchNorm statistics still update every
    # mini-step.
    grad_accum: int = 1


@dataclasses.dataclass
class EvalConfig:
    """Defaults mirror reference evaluate.py:15-28."""

    batch_size: int = 2
    target_size: Tuple[int, int] = (128, 128)
    checkpoint_path: Optional[str] = None
    output_dir: str = "evaluation_results"
    num_visualizations: int = 5
    n_channels: int = 3
    n_classes: int = 1
    # Morphological opening and closing of the predictions
    # (ops/morphology.py), with a square element of this side.
    post_process: bool = False
    post_process_kernel: int = 3
    # Two or more checkpoints whose sigmoid probabilities are averaged.
    ensemble_paths: Optional[Tuple[str, ...]] = None
    # Decision threshold for the metrics (the reference hardcodes 0.5);
    # threshold_sweep also reports macro F1 and IoU over a 0.05..0.95 grid
    # and the best operating point.
    threshold: float = 0.5
    threshold_sweep: bool = False
    # Write the metrics report (overall + per-city means) as one JSON file.
    json_out: Optional[str] = None
    # "bfloat16" runs the model under bf16 autocast; "float32" runs it in
    # full float32 with TF32 off.  A serving artifact computes in the dtype
    # it was exported with instead.
    compute_dtype: str = "bfloat16"
    # Serve an exported artifact (``python -m gan_aug_pfa_torch.
    # export_model``) instead of restoring a checkpoint.
    serving_artifact: Optional[str] = None
    # Executable-sidecar policy for the artifact, the JAX package's: "auto"
    # and "never" run the exported program (the port writes no sidecar
    # yet); "require" fails.
    serving_aot: str = "auto"


@dataclasses.dataclass
class GANTrainConfig:
    """Defaults mirror reference train_gan.py:26-35 and the JAX package's
    architecture knobs (``num_downs``, ``ngf``, ``ndf``, ``n_layers``: the
    reference models' constructor defaults)."""

    batch_size: int = 1
    num_epochs: int = 200
    learning_rate_g: float = 1e-4
    learning_rate_d: float = 1e-4
    beta1: float = 0.5
    lambda_l1: float = 100.0
    target_size: Tuple[int, int] = (256, 256)
    save_every: int = 10
    sample_every: int = 5
    checkpoint_dir: str = "gan_checkpoints"
    output_dir: str = "gan_samples"
    n_channels: int = 3
    num_downs: int = 7
    ngf: int = 64
    ndf: int = 64
    n_layers: int = 3
    seed: int = 0
    # "bfloat16": bf16 autocast with fp32 params; "float32": TF32 off.
    compute_dtype: str = "bfloat16"
    # Data-parallel over every rank of the process group, as
    # SiameseTrainConfig's.
    data_parallel: bool = True
    # Continue from <checkpoint_dir>/last_{generator,discriminator}.pth.
    resume: bool = False
    # After every G update: ema <- ema * decay + params * (1 - decay);
    # saved as generator_ema_epoch_N.pth.  None = off.
    ema_decay: Optional[float] = None
    # The JAX package's GAN knobs (its config.py:183-212):
    # One discriminator pass over [real | fake] at 2B; D's BatchNorm
    # statistics then mix real and fake activations.
    batched_disc: bool = False
    # The discriminator takes the pair (A, B): its first conv sums two
    # convolutions with the halves of its weight, no 6-channel concat.
    concat_free_disc: bool = False
    # One generator forward a step, shared by the D step (detached) and
    # the G step; G's second running-statistics update is rebuilt from
    # the first (train/gan.py).
    shared_gen_fwd: bool = False
    # See SiameseTrainConfig.opt_momentum_dtype and opt_flat_state.
    opt_momentum_dtype: Optional[str] = None
    opt_flat_state: bool = False
    # See SiameseTrainConfig.async_ckpt, profile_dir, debug_nans and
    # log_jsonl.
    async_ckpt: bool = False
    profile_dir: Optional[str] = None
    debug_nans: bool = False
    log_jsonl: Optional[str] = None

    def __post_init__(self):
        if self.ema_decay is not None and not (0.0 <= self.ema_decay < 1.0):
            raise ValueError(
                f"ema_decay must be in [0, 1), got {self.ema_decay}"
            )


@dataclasses.dataclass
class GenerateConfig:
    """Defaults mirror reference generate_synthetic_data.py:13-24, with the
    checkpoint named ``.pth`` (the port's format; a JAX package
    ``.msgpack`` generator loads too)."""

    batch_size: int = 4
    target_size: Tuple[int, int] = (256, 256)
    generator_checkpoint_name: str = "generator_epoch_200.pth"
    gan_checkpoint_dir: str = "gan_checkpoints"
    synthetic_data_dir: str = SYNTHETIC_DATA_DIR_DEFAULT
    n_channels: int = 3
    num_downs: int = 7
    ngf: int = 64
    # float32 (TF32 off) by default, for PNGs comparable bit for bit.
    compute_dtype: str = "float32"
    # An exported generator artifact in place of the checkpoint, and its
    # sidecar policy (see EvalConfig).
    serving_artifact: Optional[str] = None
    serving_aot: str = "auto"


def parse_target_size(value: str) -> Tuple[int, int]:
    """Parse "HxW" target-size strings (reference train.py:263)."""
    h, w = map(int, value.split("x"))
    return (h, w)
