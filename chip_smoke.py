#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``gan_aug_pfa_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. print the card (``nvidia-smi`` name and power limit);
2. build every CUDA kernel of the evaluation and training paths from
   ``csrc/`` with nvcc, and the PNG unfilter (``csrc/png_decode.c``) with
   the host cc, one process per source, all at once;
3. hold each kernel against its plain PyTorch version on the card (exact
   equality for the confusion counts, also on two streams in turn, in two
   CUDA graphs replayed in turn and after its workspace grows, with one
   kernel launch and no other device op a call; the fused FocalDice loss
   within the JAX package's fused-loss tolerances, forward and backward,
   float32 and bf16 logits, aligned and misaligned views, equal bits on a
   rerun and in a CUDA graph's replay, no cast kernel around a bf16 loss)
   and time kernel (back to back and inside a CUDA graph), wrapper, plain
   version and one PyTorch call with CUDA events;
4. run the full-width SiameseUNet forward (fp32, TF32 off) on the card and
   on the CPU and compare the probabilities;
5. drive the evaluation path, ``python -m gan_aug_pfa_torch.evaluate`` at
   its defaults (128x128, batch 2, bf16), in this process over a generated
   14-city OSCD tree and a seeded checkpoint, with the confusion counts'
   (calls, launches) set to 0 just before and read just after (one launch a
   batch); check the report; compare the
   slice's counts at fp32 on the card with the CPU's; time evaluation
   throughput at batch 2 and 16;
6. drive the training path, ``python -m gan_aug_pfa_torch.train`` at its
   defaults (128x128, batch 4, bf16) for 4 epochs over a generated tree,
   with the fused-loss (calls, launches) set to 0 just before and read just
   after (one launch a call); check the losses and checkpoints, resume for
   one epoch, evaluate
   the trained ``best_model.pth``; compare 3 fp32 train steps on the card
   with the CPU's; time training throughput at batch 4 and 16 and profile
   one epoch;
7. drive the augmented training path, ``python -m gan_aug_pfa_torch.train
   --augment`` (native resolution, padded to the train split's largest
   extent, resized to 128x128) for 4 epochs, then one epoch of ``--augment
   --no-native-aug``, with the photometric and fused-loss counts set to 0
   just before each and read just after (one launch a photometric call);
   compare the augmented batch of each chain and its first fp32 train step
   on the card with the CPU's; time augmented training at batch 4 and
   profile one epoch;
8. hold both photometric kernels against their plain versions on the card
   (six jitter orders, both sigma edges, ragged native extents, extents of
   1 and 2, unaligned rows, every plan: resident, resident split over
   several clusters an image, streamed) and time them at the main
   paths' shapes and at 16x3x1024x1024, back to back and inside a CUDA
   graph (device time alone), beside a ``torch.mul`` of the same bytes;
9. drive Pix2Pix GAN training, ``python -m gan_aug_pfa_torch.train_gan`` at
   its defaults (256x256, batch 1, bf16, full width) for 2 epochs over a
   generated 14-city tree, then ``--resume --num-epochs 3``; check the
   losses, the checkpoint files, the 256x768 sample strip and a strict load
   of the epoch-3 generator; compare one fp32 D+G step on the card with
   the CPU's; time GAN steps/s at batch 1, profile one epoch and count the
   step's FLOPs against the card's dense bf16 peak;
10. drive synthesis, ``python -m gan_aug_pfa_torch.generate_synthetic`` at
   its defaults (256x256, batch 4, fp32) with the epoch-3 generator; check
   the 14 triples (img1 and labels equal to the cache through the
   normalize/denormalize replay and x255, img2 within 1 LSB of a CPU run
   of the same generator); time it (pairs/s, generator and PNG-write
   time); then train on the real and synthetic pairs, ``python -m
   gan_aug_pfa_torch.train --use-synthetic`` for 2 epochs, and evaluate
   its ``best_model.pth``, with the fused-loss and confusion-counts
   (calls, launches) set to 0 just before each and read just after;
11. drive run control through the CLIs: ``python -m gan_aug_pfa_torch.train
   --num-epochs 50 --save-every 50 --log-jsonl --defer-best-ckpt
   --async-ckpt --profile-dir`` as a child process on a 14-city tree,
   SIGTERM to its PID alone when ``Epoch 2/50`` appears; it must exit 0
   within 60 s with ``last_state.pth`` at the last epoch it printed and the
   deferred ``best_model.pth`` written; then ``--resume`` for 2 more epochs
   in this process with the fused-loss (calls, launches) set to 0 just
   before and read just after, a second ``run_start`` in the log,
   ``scripts/summarize_runlog.py`` on it, the loss kernels named in the
   profiler's traces and the step timing printed; an evaluation of the
   deferred ``best_model.pth`` (confusion counts (7, 7)); the same for
   ``python -m gan_aug_pfa_torch.train_gan`` at its defaults (SIGTERM after
   ``Epoch 1 -``; the epoch's files and the resume pair at the last printed
   epoch; ``--resume`` runs the next).  In this process: ``--debug-nans``
   with a NaN conv weight raises naming step 1 (and without it does not);
   ``last_state.pth`` of one trained state written synchronously and in
   the background (training on meanwhile) holds equal tensors key for key,
   with each save's blocking time; train steps/s at batch 4 plain, under
   ``--profile-dir`` (the step timer and the profiler) and under
   ``--debug-nans``;
12. load a checkpoint the JAX package wrote
   (``tests/data/jax_generator_nd5_ngf4.msgpack``, from
   ``tools/make_msgpack_fixture.py``) through ``python -m
   gan_aug_pfa_torch.generate_synthetic`` and run its generator at fp32
   (TF32 off) on the fixture's input: within 1e-5 of the JAX output saved
   beside it;
13. drive the evaluation CLI's extras over a generated 14-city tree and
   two seeded full-width checkpoints, each with the confusion counts'
   (calls, launches) set to 0 just before and read just after:
   ``--ensemble A B --threshold-sweep`` (one launch for each of the 20
   thresholds of each of 7 batches: (140, 140); each threshold's kernel
   counts of one batch equal the plain version's; the sweep's counts at
   fp32, card vs CPU, differ only by pixels within the devices' largest
   probability difference of that threshold; ``threshold_sweep.json``
   equals the report's sweep), ``--post-process --post-process-kernel 4
   --num-visualizations 2`` ((7, 7); the card's masks equal the CPU's on
   the same probabilities; the panels, or the line that skips them
   without matplotlib) and single-pair evaluation of one city's
   non-square native PNGs at fp32 ((1, 1); within 1e-5 of the CPU's
   prediction, and its metrics); each run's wall time;
14. tune: (a) ``python -m gan_aug_pfa_torch.train --tune --n-trials 6`` at
   its defaults (128x128, native augmentation, bf16, 15 epochs a trial)
   in this process from a fresh working directory over a 14-city tree,
   with the FocalDice and photometric (calls, launches) set to 0 just
   before and read just after: they must equal the sums each trial's
   batch size and epochs imply, one launch a call; every trial in
   ``optuna_study.db`` COMPLETE or PRUNED, the best trial the least
   completed value, ``python -m gan_aug_pfa_torch.show_optuna_results``
   reporting six trials, the memory allocated after each trial within 64
   MB of its value after the first; per-trial seconds and the study's
   wall time; (b) the fused FocalDice kernels against their plain version
   at each trial's (alpha, gamma, beta, smooth) and at gamma 1 and 3 on
   one 4x1x128x128 bf16 batch; (c) the JAX-written GAN resume pair
   (``tests/data/jax_gan_state_nd5_ngf4/``, from
   ``tools/make_gan_resume_fixture.py``) resumed for one epoch through
   ``python -m gan_aug_pfa_torch.train_gan --resume``, its Adam moments on
   the card equal to the file's, and one fp32 D+G step from it (TF32 off)
   within 1e-5 relative of the JAX losses saved beside it;
15. serve (run last, after phase 18: its sidecar's compile brings
   Inductor into the process): ``python -m gan_aug_pfa_torch.export_model
   --backend cuda`` at full width, in three child processes started
   beside phase 18 (``start_sidecar_export``), from seeded checkpoints (the Siamese net at fp32, bf16 and
   int8, the generator at fp32 and int8, the discriminator at fp32); the
   artifacts loaded in turn in one fresh process that cannot import the
   model code, each
   serving batches 1 and 4 against the eager port model (fp32 and int8
   within 1e-5 of the eager model with the same, dequantized, weights;
   bf16 within the eager bf16 forward's own distance from fp32, its
   convolutions bf16 in the graph); ``evaluate --serving-artifact`` with
   the confusion counts' (calls, launches) set to 0 just before and read
   just after ((7, 7); the checkpoint path's counts at fp32 within the
   phase-5 rule); ``generate_synthetic --serving-artifact`` (img2 within 1
   LSB of the checkpoint path on at most 0.5% of pixels); export seconds,
   load ms and first-batch latency in a fresh process, evaluation pairs/s
   at bs 2 and 16 through each artifact and the checkpoint path, int8
   against fp32 file and device bytes.  Then the executable sidecar
   (``phase_serving_sidecar``): ``python -m gan_aug_pfa_torch.serve`` on
   the fp32 Siamese artifact at batch 2 (compile seconds, package bytes),
   the AOTInductor package against the ``.pt2`` within 1e-5, ``evaluate
   --serving-aot require`` in a fresh process with ``never``'s report and
   confusion counts (7, 7), cold start and pairs/s against the ``.pt2``,
   a damaged package (``require`` raises naming it, ``auto`` serves the
   ``.pt2``), a recompile that leaves no stale package, and the int8
   artifact's package (compiled in a child process of its own beside the
   fp32 one) against its ``.pt2`` within 1e-5.

16. stream: hold the C unfilter of ``data/native_loader.py`` (built in
   phase 2) against ``data/png.py`` byte for byte on every file of a
   14-city tree and on all-Paeth and all-Average 600x600 RGB files, with
   both decoders' MB/s
   on 1 and 8 threads and the set-up seconds of the scan and the cache
   through each; a synthesis pass's 42 PNG writes serially and through
   ``PngWriterPool`` (ms, byte-identical files); then, over the tree and
   330 synthetic 256x256 triplets written by the pooled writer, in this
   process a resident epoch of a fresh trainer at the defaults (128x128,
   batch 4, bf16, full width), steps/s of a resident, a host and a decode
   epoch at batch 4 and 16 and each epoch's peak device memory above the
   step's own (streamed within (depth + 2) batches, resident the corpus);
   then one epoch of ``python -m gan_aug_pfa_torch.train --use-synthetic
   --stream host`` and ``--stream decode`` (under deterministic mode, as
   the resident epoch of their init and order: train losses equal to the
   resident epoch's in bits, val losses equal to each other; fused-loss
   (calls, launches) set to 0 just before each and read just after: a
   forward a step and a val step, a backward a step); one ``--augment
   --stream host`` epoch (JAX's
   note, the flip kernel once an image a step, the native kernel never);
   ``train_gan`` for one epoch at its defaults resident and ``--stream
   decode`` (losses equal in bits, both under deterministic mode);
   ``generate_synthetic --stream decode`` (files byte-identical to the
   resident run's, both under deterministic mode); ``evaluate --stream host`` and ``--stream decode``
   (confusion counts (7, 7) each, JSON equal to the resident report).

17. knobs: over the phase-6 tree at full width, in this process, ``python
   -m gan_aug_pfa_torch.train`` for 2 epochs with each of
   ``--batched-encoder``, ``--concat-free``, ``--remat``, ``--grad-accum
   2``, ``--momentum-dtype bfloat16`` and ``--flat-opt-state``, then all
   six (at ``--grad-accum 4``) with ``--augment --stream host``, and
   ``--resume`` for a third epoch from that run's ``last_state.pth``,
   written with 2 of 4 gradients held (the resume state's Adam count,
   ``mini_step`` and layout checked), with the FocalDice and photometric
   (calls, launches) set to 0 just before each run and read just after (a
   forward a train and a val step, a backward a train step, the flip
   kernel twice a streamed augmented step); one fp32 train step of each
   knob (TF32 off), card against CPU, within phase 6's 1e-5; each
   optimizer knob (and all three), Adam and AdamW, over the full-width
   discriminator's shapes on seeded gradients, card against CPU (the
   parameters, moments and accumulator within 1e-6 of each tensor's
   largest value, the counters and bf16 moments equal); train
   steps/s of the plain trainer and of each knob at batch 4 and 16, the
   device memory each held above the model, optimizer and cache, and
   kernel launches a step of the plain trainer, ``--batched-encoder``,
   ``--concat-free`` and ``--flat-opt-state``; ``python -m
   gan_aug_pfa_torch.train_gan`` for one epoch with each of
   ``--batched-disc``, ``--concat-free-disc``, ``--shared-gen-fwd``,
   ``--momentum-dtype bfloat16`` and ``--flat-opt-state``, one fp32 D+G
   step each, card against CPU, within phase 9's 1e-5, and GAN steps/s,
   launches a step and the device's busy share of each against the
   plain step.

18. data parallel (``parallel/mesh.py``), on the one card: (a) one NCCL
   rank (a group of one in this process) runs a collective, the trainer
   takes its mesh as none, and a fp32 step on it under deterministic mode
   gives the step without a group's loss and parameters bit for bit; (b)
   two
   ranks sharing the card over gloo (child processes with torchrun's
   variables) run one fp32 step of batch 4, 2 rows a rank: the loss
   within 1e-5 of one process, the summed gradients no farther from a
   float64 step's than twice the one-process fp32 step's, the parameters
   within 2 lr (1e-6 on 98% of them: Adam's first step moves each by lr
   times its gradient's sign), both ranks equal; (c) two ranks
   through ``python -m gan_aug_pfa_torch.train`` on the phase-6 tree at
   the defaults (batch 4, bf16) for 2 epochs, then one ``--augment``
   epoch, each rank's FocalDice and photometric (calls, launches) set to
   0 just before and read just after (a forward a train and a val step,
   a backward a train step, the native kernel twice a step), the epoch
   losses within 1e-3 of phases 6 and 7, only rank 0 writing checkpoints,
   which load strictly; (d) ``python -m gan_aug_pfa_torch.train_gan`` at
   batch 2 (one image a rank) for one epoch.  The loss kernel phase (3)
   also holds the kernels in a rank's form: a focal mean over n_total =
   2n and the backward given outside global sums, at the train shape and
   16M elements.  Two ranks on one card check correctness; they time
   nothing.

19. tuning over data-parallel sub-meshes (``tune.tune_on_ranks``), on
   the one card, beside the sidecar's compile: four gloo ranks (child
   processes with torchrun's variables) call ``tune.run_tuning`` with
   ``--parallel-trials 2`` on a 14-city tree at 128x128 (native
   augmentation, bf16, full width): two partitions of two ranks run a
   two-trial study, one epoch a trial.  Each rank's FocalDice and
   photometric (calls, launches) are set to 0 just before and read just
   after and must equal its trials' steps (one launch a call); the study
   holds trials 0 and 1, COMPLETE or PRUNED; the two ranks of a partition
   ran the same epochs with equal losses; each trial's first step loss
   lies within 1e-3 of the same step run in this process; two runs of the
   trial in this process under deterministic mode give its first step and
   first epoch's train and val losses in equal bits (the ranks' first
   epoch is printed beside them); the phase's seconds.

20. the tensor-parallel 'model' axis, beside the sidecar's compile: four
   gloo ranks sharing the card as (data 2, model 2) (``phase_model_axis``).

21. the 'spatial' axis, beside the sidecar's compile: four gloo ranks
   sharing the card (``phase_spatial_axis``) run three bf16 ``--augment``
   Siamese steps at 128x128, batch 4, on (data 2, spatial 2) and on the
   (data 2) mesh of the ranks that share a spatial index (losses within
   1e-3; FocalDice (3, 3)/(3, 3) and native photometric counts equal to
   (data 2)'s on every rank; each rank's step peak below the (data 2)
   rank's), and one GAN step at 256x256, batch 1, on (data 1, spatial 4)
   against one process (losses within 1e-3; peaks printed); then the same
   Siamese steps with ``--concat-free --remat`` on both meshes (the same
   bounds and counts; each rank's peak printed against the plain (2, 2)
   step's) and the GAN step with ``--concat-free-disc``; the first steps
   again at float32 (TF32 off) within 1e-5.

22. deterministic steps (run after phase 8): under
   ``torch.use_deterministic_algorithms(True)`` with cuDNN's deterministic
   algorithms, two bf16 Siamese train steps at the defaults (128x128,
   batch 4, full width) from one seeded state, run twice, give equal
   losses, parameters and BatchNorm buffers in bits, plain and with
   ``--batched-encoder --concat-free --remat``, and one bf16 GAN D+G step
   at its defaults likewise.

Deterministic mode needs ``CUBLAS_WORKSPACE_CONFIG`` in the environment
before cuBLAS makes its handle: ``main`` sets it (``:4096:8``) before the
first CUDA call, so every phase and child process runs with it.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
rest of the repository beside it, the script exits non-zero.
"""

import contextlib
import dataclasses
import functools
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np

SEED = 0
CITIES = [
    "abudhabi", "aguasclaras", "beihai", "beirut", "bercy", "bordeaux",
    "cupertino", "hongkong", "mumbai", "nantes", "paris", "pisa", "rennes",
    "saclay_e",
]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
# Special-function results (exp2, log2, reciprocal): 16 per clock per SM
# for compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput), 132 SMs at the 1,980 MHz boost clock.
SFU_OPS_PER_S = 16 * 132 * 1.98e9
MODEL_PROB_TOL = 1e-4  # fp32 probabilities, card (cuDNN) vs CPU
SINGLE_PAIR_TOL = 1e-5  # the single pair's fp32 probabilities, card vs CPU
PASSES = 5  # timed evaluation and training passes per batch size

# The tuned FocalDice constants (SiameseTrainConfig) and both gammas the
# JAX package's tests cover: the tuned one and the u^0 edge at 1.0.
LOSS_KW = {"beta": 0.6699803915247974, "focal_alpha": 0.6030489822904476,
           "dice_smooth": 1.956571276926647e-06}
GAMMAS = (1.7930869982898021, 1.0)
TRAIN_SHAPE = (4, 1, 128, 128)  # the train step's logits at the defaults
LOSS_CASES = [((1, 1, 7, 9), False), (TRAIN_SHAPE, False),
              ((3, 1, 37, 53), True), ((4, 1, 512, 512), False),
              ((16, 1, 1024, 1024), False)]
BIG_LOSS_SHAPE = (16, 1, 1024, 1024)
LOSS_DTYPES = ("float32", "bfloat16")  # the logits'; targets are float32
# Special-function results an element the function needs: exp(-|x|), one
# reciprocal (sigmoid, and 1 - sigmoid), log2(1 + exp(-|x|)) (softplus),
# exp(-bce) (pt), log2(u) and exp2 for u^gamma; the backward one exp2 more
# for u^(gamma-1) from the same log2(u).
FWD_SFU_OPS, BWD_SFU_OPS = 6, 7
# Card vs CPU, 3 fp32 train steps from one init: the first step's loss
# differs only by the forward's rounding; later ones also by Adam's
# updates of parameters whose gradient is rounding noise (up to lr each).
TRAIN_STEP1_RTOL, TRAIN_STEP_RTOL = 1e-5, 1e-3
# The photometric kernels vs their plain versions: the contrast mean is
# summed in another order and nvcc fuses multiply-adds.
PHOTOMETRIC_ATOL = 2e-6
# The augmented batch, card vs CPU: the geometric stages compute the same
# coordinates on both (separate IEEE operations, trig in float64), so the
# images differ by the photometric kernels' rounding, and labels by a
# nearest sample that a coordinate rounding moves, at most 0.1%.
CHAIN_ATOL, LABEL_MISMATCH_SHARE = 1e-4, 1e-3
# H100 SXM data sheet: dense bf16 tensor-core rate.
BF16_OPS_PER_S = 989e12
# One fp32 GAN D+G step, card (TF32 off) vs CPU from one init: loss_D
# differs by the forwards' rounding; loss_G also by D's first Adam step,
# which would move a parameter whose gradient were rounding noise by up to
# lr in either direction.  No D parameter has such a gradient (every conv
# without a bias feeds a BatchNorm with trained affine parameters):
# measured 8.3e-8 and 6.0e-8 relative on an H100.
GAN_LOSS_D_RTOL = GAN_LOSS_G_RTOL = 1e-5
# Synthesis, card vs CPU at fp32: img2 pixels within 1 LSB, on at most
# this share of pixels (a float32 rounding difference across an integer
# boundary of the truncating byte cast; measured 0.0035% on an H100).
SYNTH_LSB_SHARE = 0.005
SUBDIR = "Onera Satellite Change Detection Dataset"
# cuBLAS's workspace for deterministic mode: torch raises at a cuBLAS call
# under ``torch.use_deterministic_algorithms(True)`` unless this is in the
# environment when cuBLAS makes its handle, so ``main`` sets it before the
# first CUDA call, for every phase and every child process.
CUBLAS_WORKSPACE = ":4096:8"


@contextlib.contextmanager
def deterministic(torch):
    """Within: ``torch.use_deterministic_algorithms(True)`` and cuDNN's
    deterministic algorithms (benchmarking off); the settings before it
    after.  An op without a deterministic algorithm raises."""
    cudnn = torch.backends.cudnn
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            cudnn.deterministic, cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        cudnn.deterministic, cudnn.benchmark = prev[2:]


def write_png(path, arr, filter_type=None):
    """Write an 8-bit gray (H, W) or RGB (H, W, 3) PNG with the standard
    library's zlib.  Row y uses filter y % 5, so every filter type
    appears, or ``filter_type`` (0-4) on every row."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w = arr.shape[:2]
    bpp = 1 if arr.ndim == 2 else arr.shape[2]
    rows = arr.reshape(h, w * bpp).astype(np.int16)
    prev = np.zeros_like(rows)
    prev[1:] = rows[:-1]
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    upleft = np.zeros_like(rows)
    upleft[1:, bpp:] = rows[:-1, :-bpp]
    p = left + prev - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, prev, upleft))
    preds = [np.zeros_like(rows), left, prev, (left + prev) >> 1, paeth]
    ftype = (np.arange(h) % 5 if filter_type is None
             else np.full(h, filter_type))
    pred = np.choose(ftype[:, None], preds)
    body = ((rows - pred) & 0xFF).astype(np.uint8)
    raw = np.concatenate([ftype[:, None].astype(np.uint8), body], axis=1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    color_type = 0 if bpp == 1 else 2
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def write_oscd_tree(root, seed=SEED):
    """The 14 OSCD cities: seeded RGB pairs of a few hundred pixels a side
    and binary change maps, in the OSCD directory layout."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, "Onera Satellite Change Detection Dataset")
    images = os.path.join(
        base, "images", "Onera Satellite Change Detection dataset - Images")
    labels = os.path.join(
        base, "train_labels",
        "Onera Satellite Change Detection dataset - Train Labels")
    for city in CITIES:
        h, w = rng.randint(200, 400, size=2)
        pair = os.path.join(images, city, "pair")
        cm = os.path.join(labels, city, "cm")
        os.makedirs(pair)
        os.makedirs(cm)
        for name in ("img1.png", "img2.png"):
            write_png(os.path.join(pair, name),
                      rng.randint(0, 256, (h, w, 3)))
        write_png(os.path.join(cm, "cm.png"),
                  (rng.rand(h, w) > 0.8).astype(np.uint8) * 255)


def seeded_model(torch, SiameseUNet, seed=SEED):
    """The full-width SiameseUNet from a seed, with random BatchNorm
    running statistics.  At init every probability lies within about 0.003
    of 0.5; the head's weight is scaled by 300 to spread the logits over a
    few units, as a trained model's are, and its bias centres them on
    seeded random images."""
    torch.manual_seed(seed)
    gen = torch.Generator().manual_seed(seed)
    model = SiameseUNet().eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
        model.conv_last.weight.mul_(300.0)
        calib = torch.rand((2, 2, 3, 128, 128), generator=gen) * 2 - 1
        model.conv_last.bias.sub_(model(calib[0], calib[1]).median())
    return model


def time_ms(torch, fn, iters=200, warmup=20):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def confusion_inputs(torch, shape, threshold, gen, misaligned=False):
    b = shape[0] + (1 if misaligned else 0)
    p = torch.rand((b, *shape[1:]), generator=gen, device="cuda")
    p.view(-1)[::7] = threshold  # at the threshold: negative (strict >)
    t = (torch.rand((b, *shape[1:]), generator=gen, device="cuda")
         > 0.6).float()
    t[0] = 1.0
    if b > 1:
        t[-1] = 0.0
    if misaligned:  # a view whose data pointer is not 16-byte aligned
        p, t = p[1:], t[1:]
    return p, t


# The confusion-counts correctness cases: the evaluation shapes (bs 2 and
# 16), an odd map aligned and one pixel past a 16-byte boundary, 1x1 maps,
# a large shape, and a batch whose slots do not fit the workspace that the
# earlier cases left (it grows).
CONFUSION_CASES = [((2, 128, 128), False), ((16, 128, 128), False),
                   ((1, 37, 53), False), ((1, 37, 53), True),
                   ((3, 1, 1), False), ((16, 1024, 1024), False),
                   ((4000, 16, 16), False)]
CONFUSION_SHAPES = ((2, 128, 128), (16, 128, 128), (16, 1024, 1024))


def confusion_bound(b, hw):
    """Least time (ms) of one call: both (B, H*W) float32 maps read once,
    the (B, 4) float32 counts written once; against 6 integer or compare
    operations an element at the card's fp32 rate."""
    nbytes = 8 * b * hw + 16 * b
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 6 * b * hw / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes}


def confusion_call(torch, cc, p, t, threshold=0.5, fn=None, plan=None):
    """The bare C entry point of csrc/confusion_counts.cu (``fn``, this
    tree's by default) on fixed buffers with ``plan`` (the wrapper's by
    default): (call(stream), the (B, 4) output)."""
    fn = fn or cc._kernel()
    plan = plan or cc.plan_for(p, t)
    b = p.shape[0]
    hw = p[0].numel()
    out = torch.empty((b, 4), device="cuda")
    ws = torch.zeros(cc.SLOT_INTS * b, dtype=torch.int32, device="cuda")

    def call(stream):
        return fn(p.data_ptr(), t.data_ptr(), threshold, b, hw,
                  *plan.c_args(), out.data_ptr(), ws.data_ptr(), ws.numel(),
                  stream)

    return call, out


def phase_kernel(torch, cc):
    """Kernel vs plain version on the card, exact, in every
    CONFUSION_CASES case at thresholds 0.5 and 0.3; two streams in turn;
    two CUDA graphs replayed in turn with eager calls between; one kernel
    launch and no other device op a call; then timings at
    CONFUSION_SHAPES."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    max_err = 0.0
    stream = torch.cuda.current_stream().cuda_stream
    for shape, misaligned in CONFUSION_CASES:
        for thr in (0.5, 0.3):
            p, t = confusion_inputs(torch, shape, thr, gen, misaligned)
            if misaligned and p.data_ptr() % 16 == 0:
                raise AssertionError("misaligned case is 16-byte aligned")
            got = cc.confusion_counts_batch(p, t, thr)
            again = cc.confusion_counts_batch(p, t, thr)
            torch.cuda.synchronize()
            ref = cc.confusion_counts_batch_reference(p, t, thr)
            err = float((got - ref).abs().max())
            max_err = max(max_err, err)
            hw = shape[1] * shape[2]
            ok = (torch.equal(got, ref) and torch.equal(got, again)
                  and bool((got.sum(dim=1) == hw).all()))
            print(f"kernel {shape} thr={thr} misaligned={misaligned} plan "
                  f"{cc.plan_for(p, t)}: max_abs_err={err} "
                  f"{'OK' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(
                    f"confusion_counts kernel != plain version at {shape}, "
                    f"thr={thr}:\n{got}\n{ref}")
    ws = cc._workspaces.persistent(torch.device("cuda", 0), stream, 0)
    if ws.numel() < cc.SLOT_INTS * 4000 or bool(ws.any()):
        raise AssertionError("the workspace did not grow, or a slot is "
                             "not back at 0")
    check_confusion_streams_and_graphs(torch, cc, gen)
    check_one_launch(torch, cc, gen)

    timings = {}
    for shape in CONFUSION_SHAPES:
        p, t = confusion_inputs(torch, shape, 0.5, gen)
        b, hw = shape[0], shape[1] * shape[2]
        call, _ = confusion_call(torch, cc, p, t)
        if call(stream) != 0:
            raise AssertionError("confusion_counts launch failed")
        codes = ((p > 0.5).float() * 2 + (t > 0.5).float()
                 + 4 * torch.arange(b, device="cuda").view(-1, 1, 1)
                 ).view(-1)
        lib = torch.histc(codes, bins=4 * b, min=0, max=4 * b).view(b, 4)
        ref = cc.confusion_counts_batch_reference(p, t, 0.5)
        # histc bins: code 0 = tn, 1 = fn, 2 = fp, 3 = tp.
        if not torch.equal(lib[:, [3, 2, 1, 0]], ref):
            raise AssertionError("library call disagrees with the counts")

        def histc():
            return torch.histc(codes, bins=4 * b, min=0, max=4 * b)

        r = confusion_bound(b, hw)
        r.update({
            "ms": time_ms(torch, functools.partial(call, stream)),
            "graph_ms": graph_ms(torch, lambda: call(
                torch.cuda.current_stream().cuda_stream)),
            "wrapper_ms": time_ms(
                torch, lambda: cc.confusion_counts_batch(p, t, 0.5)),
            "plain_ms": time_ms(
                torch, lambda: cc.confusion_counts_batch_reference(p, t, 0.5)),
            "library_ms": time_ms(torch, histc),
            "library_graph_ms": graph_ms(torch, histc),
            "plan": list(cc.plan_for(p, t).c_args()),
        })
        timings[shape] = r
        print(f"kernel timing {shape}: {json.dumps(r)}")
    return max_err, timings


def check_confusion_streams_and_graphs(torch, cc, gen):
    """Calls on two streams in turn (a workspace each), then two CUDA
    graphs (a zeroed buffer each) replayed in turn with eager calls on the
    default stream between them: every result equals the eager one."""
    inputs = [confusion_inputs(torch, shape, thr, gen)
              for shape, thr in (((2, 128, 128), 0.5),
                                 ((16, 128, 128), 0.3))]
    thresholds = (0.5, 0.3)
    eager = [cc.confusion_counts_batch(p, t, thr)
             for (p, t), thr in zip(inputs, thresholds)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(10):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(cc.confusion_counts_batch(*inputs[i],
                                                        thresholds[i]))
    torch.cuda.synchronize()
    if not all(torch.equal(v, eager[i]) for i in range(2) for v in got[i]):
        raise AssertionError("confusion_counts on two streams != eager")
    graphs = []
    for (p, t), thr in zip(inputs, thresholds):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = cc.confusion_counts_batch(p, t, thr)
        graphs.append((graph, out))
    for _ in range(3):
        for i, (graph, out) in enumerate(graphs):
            graph.replay()
            between = cc.confusion_counts_batch(*inputs[1 - i],
                                                thresholds[1 - i])
            torch.cuda.synchronize()
            if not (torch.equal(out, eager[i])
                    and torch.equal(between, eager[1 - i])):
                raise AssertionError(f"confusion_counts graph {i} replay "
                                     "!= eager")
    print("confusion_counts: two streams in turn and two graphs replayed "
          "in turn with eager calls between equal eager")


def check_one_launch(torch, cc, gen):
    """At the evaluation shape a call is one kernel launch and no other
    device op (no fill, no derive, no cast)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    p, t = confusion_inputs(torch, (2, 128, 128), 0.5, gen)
    cc.confusion_counts_batch(p, t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cc.confusion_counts_batch(p, t)
        torch.cuda.synchronize()
    ops = {e.key: e.count for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA}
    print(f"confusion_counts call at (2, 128, 128): device ops {ops}")
    if len(ops) != 1 or not all("confusion_counts" in k and c == 1
                                for k, c in ops.items()):
        raise AssertionError(f"a confusion_counts call ran {ops}")


def loss_inputs(torch, shape, gen, misaligned=False, dtype="float32"):
    """Logits (B, 1, H, W) of ``dtype`` with saturated entries of +-1e4 and
    float32 binary targets (B, H, W), as the train step passes them;
    ``misaligned`` gives views one element past a 16-byte boundary (4 bytes
    for float32 logits and the targets, 2 for bfloat16 logits)."""
    n = int(np.prod(shape))
    extra = 1 if misaligned else 0
    x = torch.randn(n + extra, generator=gen, device="cuda") * 4
    x[::101] = 1e4
    x[50::101] = -1e4
    x = x.to(getattr(torch, dtype))
    t = (torch.rand(n + extra, generator=gen, device="cuda") > 0.7).float()
    if misaligned:
        x, t = x[1:], t[1:]
    b, _, h, w = shape
    return x.view(shape), t.view(b, h, w)


def loss_errors(torch, fl, xf, tf, gamma, loss, dx, g, kw=LOSS_KW,
                n_total=None, sums=None):
    """Kernel results against the plain version on the same values, at the
    tolerances of tests/test_pallas.py: the loss within 1e-6 relative, dx
    within 1e-5 of max|dx| (1e-3 from 2^20 elements on, where dx is
    O(1e-7) and the sums' rounding shows), plus one bf16 rounding step of
    each value where dx is bf16 (both sides round their float32 dx to
    nearest even).  Returns |dloss|, max|ddx|, the part of |ddx| above the
    rounding step, the dx tolerance, the plain loss and whether all
    hold.  ``kw``: beta, focal_alpha and dice_smooth of the loss;
    ``n_total``: the focal mean's divisor (n when None); ``sums``: the
    global sums the backward was given (the shard's own when None)."""
    beta, alpha, smooth = kw["beta"], kw["focal_alpha"], kw["dice_smooth"]
    n = xf.numel() if n_total is None else n_total
    ref_sums = fl.focal_dice_sums_reference(xf, tf, gamma, alpha)
    ref_loss = float(fl._finalize(ref_sums, n, beta, smooth))
    want = fl.focal_dice_grad_reference(
        xf, tf, ref_sums if sums is None else sums, g, beta, gamma, alpha,
        smooth, n).float()
    diff = (dx.float() - want).abs()
    step = 2 ** -7 * want.abs() if xf.dtype == torch.bfloat16 else 0.0
    excess = float((diff - step).max())
    tol = (1e-3 if xf.numel() >= 1 << 20 else 1e-5) * float(
        want.abs().max())
    dloss = abs(float(loss) - ref_loss)
    ok = (np.isfinite(float(loss)) and bool(dx.isfinite().all())
          and dx.dtype == xf.dtype and dloss < 1e-6 * max(1.0, abs(ref_loss))
          and excess <= tol)
    return dloss, float(diff.max()), excess, tol, ref_loss, ok


def phase_loss_kernel(torch, fl):
    """Fused FocalDice kernels vs the plain version on the card, forward
    and backward (``loss_errors``), at every LOSS_CASES shape, both gammas,
    float32 and bfloat16 logits, aligned and misaligned views; each
    forward and backward run twice must give the same bits, and so must a
    CUDA graph's replays.  Then the wrapper under autograd, the launches of
    a bf16 loss under autocast (the two kernels and no cast), and the
    timings."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    beta, alpha, smooth = (LOSS_KW["beta"], LOSS_KW["focal_alpha"],
                           LOSS_KW["dice_smooth"])
    g = torch.tensor(0.73, device="cuda")
    errs = {(k, d): 0.0 for k in ("fwd", "bwd") for d in LOSS_DTYPES}
    for shape, misaligned in LOSS_CASES:
        for dtype in LOSS_DTYPES:
            for gamma in GAMMAS:
                x, t = loss_inputs(torch, shape, gen, misaligned, dtype)
                xf, tf = x.reshape(-1), t.reshape(-1)
                if misaligned and xf.data_ptr() % 16 == 0:
                    raise AssertionError("misaligned case is 16-byte aligned")
                hyper = (beta, gamma, alpha, smooth)
                loss, sums = fl.launch_forward(xf, tf, *hyper)
                dx = fl.launch_backward(xf, tf, sums, g, *hyper)
                loss2, sums2 = fl.launch_forward(xf, tf, *hyper)
                dx2 = fl.launch_backward(xf, tf, sums2, g, *hyper)
                torch.cuda.synchronize()
                dloss, ddx, excess, tol, ref_loss, ok = loss_errors(
                    torch, fl, xf, tf, gamma, loss, dx, g)
                errs["fwd", dtype] = max(errs["fwd", dtype], dloss)
                errs["bwd", dtype] = max(errs["bwd", dtype], ddx)
                ok = (ok and torch.equal(loss, loss2)
                      and torch.equal(sums, sums2) and torch.equal(dx, dx2))
                print(f"loss kernel {shape} {dtype} gamma={gamma:.4f} "
                      f"misaligned={misaligned} plan {fl.plan_for(xf, tf)}: "
                      f"loss {float(loss):.7f} vs {ref_loss:.7f} (|d| "
                      f"{dloss:.2e}), max|ddx| {ddx:.2e}, beyond a bf16 "
                      f"step {excess:.2e} (tol {tol:.2e}) "
                      f"{'OK' if ok else 'MISMATCH'}")
                if not ok:
                    raise AssertionError(
                        f"fused loss kernels != plain version at {shape}, "
                        f"{dtype}, gamma={gamma}")

    check_global_form(torch, fl, gen, g)

    # Forward and backward captured in one CUDA graph: each replay gives
    # the eager bits.
    for dtype in LOSS_DTYPES:
        x, t = loss_inputs(torch, TRAIN_SHAPE, gen, dtype=dtype)
        xf, tf = x.reshape(-1), t.reshape(-1)
        hyper = (beta, GAMMAS[0], alpha, smooth)
        loss, sums = fl.launch_forward(xf, tf, *hyper)
        dx = fl.launch_backward(xf, tf, sums, g, *hyper)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            gl, gs = fl.launch_forward(xf, tf, *hyper)
            gdx = fl.launch_backward(xf, tf, gs, g, *hyper)
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            if not (torch.equal(gl, loss) and torch.equal(gs, sums)
                    and torch.equal(gdx, dx)):
                raise AssertionError(f"graph replay != eager ({dtype})")
        print(f"loss kernels in a CUDA graph ({dtype}): replays equal eager")

    # The wrapper under autograd, at the train shape: dx through
    # FocalDiceLossFn equals the plain Function's.
    x, t = loss_inputs(torch, TRAIN_SHAPE, gen)
    xk = x.detach().clone().requires_grad_()
    fl.focal_dice_loss_fused(xk, t, focal_gamma=GAMMAS[0], **LOSS_KW
                             ).backward()
    xp = x.detach().reshape(-1).clone().requires_grad_()
    fl.FocalDiceLossReferenceFn.apply(xp, t.reshape(-1), beta, GAMMAS[0],
                                      alpha, smooth).backward()
    d = float((xk.grad.reshape(-1) - xp.grad).abs().max())
    if not d <= 1e-5 * float(xp.grad.abs().max()):
        raise AssertionError(f"wrapper gradient differs from plain: {d}")
    print(f"loss wrapper under autograd vs plain: max|ddx| = {d:.2e}")
    check_no_cast(torch, fl, gen)

    timings = {(shape, dtype): loss_timings(torch, fl, shape, dtype, gen)
               for shape in (TRAIN_SHAPE, BIG_LOSS_SHAPE)
               for dtype in LOSS_DTYPES}
    return errs, timings


def check_global_form(torch, fl, gen, g):
    """The kernels as a data-parallel rank runs them (phase 18): a shard
    of a batch of two, the focal mean over n_total = 2n, the backward
    given the global sums (this shard's and another's, supplied from
    outside), at the train shape and at 16M elements, float32 and bf16
    logits: against the plain version at ``loss_errors``' tolerances."""
    beta, alpha, smooth = (LOSS_KW["beta"], LOSS_KW["focal_alpha"],
                           LOSS_KW["dice_smooth"])
    hyper = (beta, GAMMAS[0], alpha, smooth)
    for shape in (TRAIN_SHAPE, BIG_LOSS_SHAPE):
        for dtype in LOSS_DTYPES:
            x, t = loss_inputs(torch, shape, gen, dtype=dtype)
            other, t2 = loss_inputs(torch, shape, gen, dtype=dtype)
            xf, tf = x.reshape(-1), t.reshape(-1)
            n_total = 2 * xf.numel()
            sums = (fl.focal_dice_sums_reference(xf, tf, GAMMAS[0], alpha)
                    + fl.focal_dice_sums_reference(
                        other.reshape(-1), t2.reshape(-1), GAMMAS[0], alpha))
            loss, local = fl.launch_forward(xf, tf, *hyper, n_total)
            dx = fl.launch_backward(xf, tf, sums, g, *hyper, n_total)
            torch.cuda.synchronize()
            dloss, ddx, excess, tol, ref_loss, ok = loss_errors(
                torch, fl, xf, tf, GAMMAS[0], loss, dx, g, n_total=n_total,
                sums=sums)
            print(f"loss kernel global form {shape} {dtype} n_total "
                  f"{n_total}: loss {float(loss):.7f} vs {ref_loss:.7f} "
                  f"(|d| {dloss:.2e}), max|ddx| {ddx:.2e}, beyond a bf16 "
                  f"step {excess:.2e} (tol {tol:.2e}) "
                  f"{'OK' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"global-form loss kernels != plain "
                                     f"version at {shape}, {dtype}")


def check_no_cast(torch, fl, gen):
    """bf16 logits under bf16 autocast, as the train step passes them: the
    loss forward and backward are the two kernels, one launch each, and no
    other kernel (no cast of the logits before, none of dx after)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, t = loss_inputs(torch, TRAIN_SHAPE, gen, dtype="bfloat16")
    xb = x.detach().requires_grad_()
    g = torch.ones((), device="cuda")
    fl.focal_dice_loss_fused(xb, t, **LOSS_KW).backward(g)
    xb.grad = None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with torch.autocast("cuda", dtype=torch.bfloat16):
            loss = fl.focal_dice_loss_fused(xb, t, **LOSS_KW)
        loss.backward(g)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
    print(f"bf16 loss forward + backward under autocast: {kernels}")
    if len(kernels) != 2 or not all("focal_dice" in k and c == 1
                                    for k, c in kernels.items()):
        raise AssertionError(f"bf16 loss launched {kernels}")
    if xb.grad.dtype != torch.bfloat16:
        raise AssertionError(f"dx came back as {xb.grad.dtype}")


def loss_bound(n, x_bytes, backward):
    """Least time (ms) of one kernel call over n elements: logits of
    ``x_bytes`` and float32 targets read once, bf16 or float32 dx written
    once (backward), the 5 floats out (forward) or the sums and gradient
    in; against FWD_SFU_OPS / BWD_SFU_OPS special-function results an
    element at SFU_OPS_PER_S."""
    nbytes = n * (x_bytes + 4 + (x_bytes if backward else 0)) + 20
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    sfu = BWD_SFU_OPS if backward else FWD_SFU_OPS
    ops_ms = sfu * n / SFU_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "sfu_ms": ops_ms}


def loss_calls(torch, fl, xf, tf, kernels=None, plan=None):
    """The bare C forward and backward of csrc/focal_dice_loss.cu
    (``kernels`` = (fwd, bwd), this tree's by default) on flat CUDA inputs
    and fixed buffers, with ``plan`` (the wrapper's by default) and the
    tuned gamma: (fwd(stream), bwd(stream), the 5-float output, dx, the
    upstream gradient)."""
    hyper = (LOSS_KW["beta"], GAMMAS[0], LOSS_KW["focal_alpha"],
             LOSS_KW["dice_smooth"])
    fwd, bwd = kernels or fl._kernels()
    n = xf.numel()
    plan = (plan or fl.plan_for(xf, tf)).c_args()
    args = (xf.data_ptr(), int(xf.dtype == torch.bfloat16), tf.data_ptr())
    out = torch.empty(5, device="cuda")
    ws = torch.zeros(fl.WORKSPACE_FLOATS, device="cuda")
    dx = torch.empty_like(xf)
    g = torch.full((), 0.73, device="cuda")

    def fwd_on(stream):
        return fwd(*args, n, n, *plan, *hyper, out.data_ptr(),
                   ws.data_ptr(), stream)

    def bwd_on(stream):
        return bwd(*args, out.data_ptr() + 4, g.data_ptr(), n, n, *plan,
                   *hyper, dx.data_ptr(), stream)

    return fwd_on, bwd_on, out, dx, g


def loss_timings(torch, fl, shape, dtype, gen):
    """Kernel alone (the bare C calls, back to back and in a CUDA graph),
    wrapper, plain version and one PyTorch call reading about the same
    bytes (a yardstick: no single PyTorch call computes this function),
    forward and backward."""
    import torch.nn.functional as F

    x, t = loss_inputs(torch, shape, gen, dtype=dtype)
    xf, tf = x.reshape(-1), t.reshape(-1)
    n = xf.numel()
    hyper = (LOSS_KW["beta"], GAMMAS[0], LOSS_KW["focal_alpha"],
             LOSS_KW["dice_smooth"])
    fwd_on, bwd_on, out, _, g = loss_calls(torch, fl, xf, tf)
    t_same = tf.to(xf.dtype)
    lib_out = torch.empty(n, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    if fwd_on(stream) != 0 or bwd_on(stream) != 0:
        raise AssertionError("fused loss kernel launch failed")
    sums = out[1:]
    kw = dict(focal_gamma=GAMMAS[0], **LOSS_KW)
    result = {}
    for name, c_fn, wrapper, plain, library in (
        ("fwd", fwd_on,
         lambda: fl.focal_dice_loss_fused(x, t, **kw),
         lambda: fl.FocalDiceLossReferenceFn.apply(xf, tf, *hyper),
         lambda: F.binary_cross_entropy_with_logits(xf, t_same,
                                                    reduction="sum")),
        ("bwd", bwd_on,
         lambda: fl.launch_backward(xf, tf, sums, g, *hyper),
         lambda: fl.focal_dice_grad_reference(xf, tf, sums, g, *hyper),
         lambda: torch.mul(xf, tf, out=lib_out)),
    ):
        r = loss_bound(n, xf.element_size(), name == "bwd")
        r.update({
            "ms": time_ms(torch, functools.partial(c_fn, stream)),
            "graph_ms": graph_ms(torch, lambda c_fn=c_fn: c_fn(
                torch.cuda.current_stream().cuda_stream)),
            "wrapper_ms": time_ms(torch, wrapper),
            "plain_ms": time_ms(torch, plain),
            "library_ms": time_ms(torch, library),
            "library_graph_ms": graph_ms(torch, library),
            "plan": list(fl.plan_for(xf, tf).c_args()),
        })
        result[name] = r
        print(f"loss kernel timing {name} {shape} {dtype}: {json.dumps(r)}")
    return result


def photometric_bound(extents, native):
    """Least time (ms) of one photometric call on images whose work covers
    ``extents`` (h, w) each: three float32 channels read and written once
    in each extent (the native kernel leaves the padded tail alone), plus
    one (8,) float32 parameter row an image.  fp32 operations a pixel and
    channel: brightness 3, contrast 6 and saturation 6 (gray, blend,
    clip), the separable blur 10; the native kernel's mask and dynamic
    edge 5 more."""
    pixels = sum(h * w for h, w in extents)
    nbytes = 24 * pixels + 32 * len(extents)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (30 if native else 25) * 3 * pixels / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops_ms": ops_ms}


def photometric_rows(torch, b, order, extents=None, sigma_first=0.1,
                     seed=SEED):
    """(B, 8) rows: factors of 0.7 or 1.3 (the clips engage), the given
    order, sigma alternating 0.1 / 1.0 from ``sigma_first``; native
    extents, else the four flip combinations in turn."""
    rng = np.random.RandomState(seed)
    rows = np.zeros((b, 8), np.float32)
    rows[:, :3] = np.where(rng.rand(b, 3) > 0.5, 1.3, 0.7)
    rows[:, 3] = order
    rows[:, 4] = np.resize([sigma_first, 1.1 - sigma_first], b)
    if extents is None:
        rows[:, 5] = np.resize([1, 0, 1, 0], b)
        rows[:, 6] = np.resize([1, 1, 0, 0], b)
    else:
        ext = np.asarray(extents, np.float32)
        rows[:, 5:7] = ext
        rows[:, 7] = ext[:, 0] * ext[:, 1]
    return torch.from_numpy(rows).cuda()


def graph_ms(torch, fn, calls=20, replays=10):
    """Mean device time of ``fn`` with no host time between calls: ``calls``
    calls captured in one CUDA graph, replayed ``replays`` times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


# The photometric correctness cases: the main paths' shapes, ragged native
# extents, extents of 1 and 2 rows or columns, rows that are not 16-byte
# aligned, batches of 1 and 3, whose images the resident plan splits over
# several clusters, and 1024x1024 and 700x1023 images, which take the
# streamed plan (bands of a few rows among them, which fit the ring whole).
PHOTOMETRIC_CASES = [
    ("native", (4, 3, 400, 400), [[201, 397], [400, 400], [256, 130],
                                  [399, 200]]),
    ("native", (3, 3, 392, 400), [[392, 400], [1, 2], [255, 203]]),
    ("native", (1, 3, 392, 400), [[392, 400]]),
    ("native", (4, 3, 8, 8), [[1, 1], [2, 2], [1, 8], [8, 2]]),
    ("native", (2, 3, 1024, 1024), [[1024, 1024], [777, 1001]]),
    ("native", (4, 3, 1024, 1024), [[1, 1], [2, 1024], [40, 1000],
                                    [100, 3]]),
    ("native", (2, 3, 700, 1023), [[700, 1023], [699, 517]]),
    ("flip", (4, 3, 128, 128), None),
    ("flip", (3, 3, 37, 53), None),
    ("flip", (3, 3, 128, 128), None),
    ("flip", (2, 3, 1024, 1024), None),
    ("flip", (2, 3, 700, 1023), None),
]


def check_photometric(torch, ph, kind, shape, extents, gen):
    """One photometric kernel vs its plain version on the card at
    ``shape``, within PHOTOMETRIC_ATOL inside each native extent (the whole
    image for ``extents=None``), over the six jitter orders and both sigma
    edges; equal bits on a rerun.  Returns the largest error and the
    launch plan's name."""
    extents = ([[min(h, shape[2]), min(w, shape[3])] for h, w in extents]
               if extents else [[shape[2], shape[3]]] * shape[0])
    fn, ref = ((ph.photometric_native_chw, ph.photometric_native_reference)
               if kind == "native" else
               (ph.photometric_flip_chw, ph.photometric_flip_reference))
    plan = ph.plan_launch(shape[0], *shape[2:])
    x = torch.rand(shape, generator=gen, device="cuda")
    worst = 0.0
    for order in range(6):
        for sigma_first in (0.1, 1.0):
            rows = photometric_rows(
                torch, shape[0], order,
                extents if kind == "native" else None, sigma_first,
                seed=order)
            got, again = fn(x, rows), fn(x, rows)
            torch.cuda.synchronize()
            want = ref(x, rows)
            for i, (h, w) in enumerate(extents):
                worst = max(worst, float(
                    (got[i, :, :h, :w] - want[i, :, :h, :w]).abs().max()))
                if not torch.equal(got[i, :, :h, :w], again[i, :, :h, :w]):
                    raise AssertionError(f"{kind} {shape}: rerun differs")
    print(f"photometric {kind} kernel {shape} ({plan.mode}, split "
          f"{plan.split}) extents {extents}: max_abs_err={worst} over 6 "
          f"orders x 2 sigma edges "
          f"{'OK' if worst <= PHOTOMETRIC_ATOL else 'MISMATCH'}")
    if worst > PHOTOMETRIC_ATOL:
        raise AssertionError(f"photometric {kind} kernel != plain version "
                             f"at {shape}: {worst}")
    return worst, plan.mode + (" split" if plan.split > 1 else "")


def phase_photometric(torch, ph, native_shape, native_extents):
    """Both photometric kernels vs their plain versions on the card
    (``check_photometric``) in every plan (resident, split, streamed).
    Then timings of kernel, wrapper, plain version and a yardstick at the
    main paths' shapes and at 16x3x1024x1024, each with its launch
    plan."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    errs = {"native": 0.0, "flip": 0.0}
    modes = set()
    for kind, shape, extents in [("native", native_shape, native_extents),
                                 *PHOTOMETRIC_CASES]:
        worst, mode = check_photometric(torch, ph, kind, shape, extents, gen)
        errs[kind] = max(errs[kind], worst)
        modes.add(mode)
    if modes != {"resident", "resident split", "streamed"}:
        raise AssertionError(f"photometric cases ran plans {modes}")

    timings = {}
    big = (16, 3, 1024, 1024)
    native_fn, flip_fn, _ = ph._kernels()
    for kind, shape, extents in (
            ("native", native_shape, native_extents),
            ("native", big, [[1024, 1024]] * 16),
            ("flip", (4, 3, 128, 128), None), ("flip", big, None)):
        native = kind == "native"
        if extents:
            extents = [[min(h, shape[2]), min(w, shape[3])]
                       for h, w in extents]
        b, _, hp, wp = shape
        x = torch.rand(shape, generator=gen, device="cuda")
        rows = photometric_rows(torch, b, 3, extents)
        plan = ph.plan_launch(b, hp, wp)
        c_fn = native_fn if native else flip_fn
        out = torch.empty_like(x)
        yard = torch.empty_like(x)

        def kernel_on(stream):
            return c_fn(x.data_ptr(), rows.data_ptr(), b, hp, wp,
                        *plan.c_args(), out.data_ptr(), stream)

        # Back to back on the current stream, read once; in the graph, on
        # the capturing stream.
        stream = torch.cuda.current_stream().cuda_stream
        kernel_only = functools.partial(kernel_on, stream)
        if kernel_only() != 0:
            raise AssertionError(f"photometric {kind} launch failed")
        wrapper, plain = ((ph.photometric_native_chw,
                           ph.photometric_native_reference) if native else
                          (ph.photometric_flip_chw,
                           ph.photometric_flip_reference))
        t = photometric_bound(extents or [shape[2:]] * b, native)
        t.update({
            "ms": time_ms(torch, kernel_only),
            "graph_ms": graph_ms(torch, lambda: kernel_on(
                torch.cuda.current_stream().cuda_stream)),
            "wrapper_ms": time_ms(torch, lambda: wrapper(x, rows)),
            "plain_ms": time_ms(torch, lambda: plain(x, rows), iters=20,
                                warmup=3),
            "library_ms": time_ms(torch, lambda: torch.mul(x, 1.5, out=yard)),
            "library_graph_ms": graph_ms(
                torch, lambda: torch.mul(x, 1.5, out=yard)),
            "plan": dataclasses.asdict(plan),
            "active_clusters": ph.active_clusters(native, b, hp, wp, plan),
        })
        timings[(kind, shape)] = t
        print(f"photometric {kind} timing {shape}: {json.dumps(t)}")
    return errs, timings


def phase_model(torch, SiameseUNet, predict):
    """fp32 forward on the card vs the CPU, TF32 off on the card."""
    import copy

    model = seeded_model(torch, SiameseUNet)
    rng = np.random.RandomState(SEED)
    x1 = torch.from_numpy(rng.rand(2, 128, 128, 3).astype(np.float32))
    x2 = torch.from_numpy(rng.rand(2, 128, 128, 3).astype(np.float32))
    cpu = predict(model, x1, x2, "float32")
    gpu_model = copy.deepcopy(model).cuda()
    gpu = predict(gpu_model, x1.cuda(), x2.cuda(), "float32").cpu()
    diff = float((gpu - cpu).abs().max())
    print(f"model fp32 card vs CPU: max |dprob| = {diff} "
          f"(tolerance {MODEL_PROB_TOL}), prob range "
          f"[{float(cpu.min())}, {float(cpu.max())}]")
    if not diff <= MODEL_PROB_TOL:
        raise AssertionError(f"model card vs CPU: {diff} > {MODEL_PROB_TOL}")
    return diff


def check_report(result, report_path):
    """The evaluation of the 14 cities at 128x128: counts that cover each
    map, and ``check_report_file``."""
    counts = result["counts"]
    if counts.shape[0] != len(CITIES) or not (
            counts.sum(axis=1) == 128 * 128).all():
        raise AssertionError(f"counts do not cover 14 128x128 maps: {counts}")
    check_report_file(report_path)


def check_report_file(report_path):
    """The JAX package's report keys, every metric finite in [0, 1]."""
    from gan_aug_pfa_torch.metrics import METRIC_KEYS

    with open(report_path) as f:
        report = json.load(f)
    want_keys = {"n_samples", "threshold", "checkpoints", "post_process",
                 "overall", "per_city", "per_city_counts", "sweep"}
    if set(report) != want_keys or set(report["per_city"]) != set(CITIES):
        raise AssertionError(f"report keys {sorted(report)}")
    values = [report["overall"][k] for k in METRIC_KEYS] + [
        m[k] for m in report["per_city"].values() for k in METRIC_KEYS]
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in values):
        raise AssertionError(f"metric out of [0, 1]: {report}")
    print("evaluation report: " + json.dumps(report["overall"]))


def phase_main_path(torch, root):
    from gan_aug_pfa_torch import checkpoint, evaluate, pipelines
    from gan_aug_pfa_torch.config import EvalConfig
    from gan_aug_pfa_torch.data.loader import build_cached_dataset
    from gan_aug_pfa_torch.data.scanner import create_sample_lists
    from gan_aug_pfa_torch.models import SiameseUNet
    from gan_aug_pfa_torch.ops.kernels import confusion_counts as cc
    from gan_aug_pfa_torch.train.siamese import predict

    t0 = time.time()
    write_oscd_tree(root)
    model = seeded_model(torch, SiameseUNet)
    checkpoint.save_model(
        os.path.join(root, "siamese_checkpoints", "best_model.pth"), model)
    print(f"tree + checkpoint written in {time.time() - t0:.1f} s")

    report_path = os.path.join(root, "report.json")
    fn = cc.confusion_counts_batch
    fn.calls = fn.launches = 0
    t0 = time.time()
    result = evaluate.main(["--root-dir", root, "--json-out", report_path])
    wall = time.time() - t0
    counts = {"confusion_counts": (fn.calls, fn.launches)}
    print(f"main path: evaluate.main wall {wall:.2f} s, (calls, launches) "
          f"{counts}")

    n = sum(result["per_city_counts"].values())
    batches = -(-n // EvalConfig().batch_size)
    if n != len(CITIES) or counts["confusion_counts"] != (batches, batches):
        raise AssertionError(
            f"{n} samples, (calls, launches) {counts['confusion_counts']}; "
            f"expected {len(CITIES)} samples, one launch for each of "
            f"{batches} batches")
    check_report(result, report_path)

    # The slice at fp32 on the card vs the CPU: per sample, kernel counts
    # may differ from the CPU's only by pixels whose probability lies
    # within the two devices' largest probability difference of the
    # threshold.
    ds = build_cached_dataset(
        create_sample_lists(root, "Onera Satellite Change Detection Dataset",
                            mode="all", verbose=False),
        (128, 128), verbose=False)
    gpu_model = SiameseUNet(batched_encoder=True)
    checkpoint.restore_model_only(
        os.path.join(root, "siamese_checkpoints", "best_model.pth"),
        gpu_model)
    gpu_model.cuda()
    cpu_probs = predict(model, torch.from_numpy(ds.img1),
                        torch.from_numpy(ds.img2), "float32")[..., 0]
    cache = pipelines.DeviceCache.from_dataset(ds, "cuda")
    cfg32 = EvalConfig(compute_dtype="float32")
    gpu32 = pipelines.evaluate_cached(
        pipelines.ensemble_fn([gpu_model], cfg32.compute_dtype), cache,
        ds.cities, cfg32)
    gpu_probs = predict(gpu_model, cache.img1.permute(0, 2, 3, 1),
                        cache.img2.permute(0, 2, 3, 1), "float32")[..., 0]
    dprob = float((gpu_probs.cpu() - cpu_probs).abs().max())
    cpu_counts = cc.confusion_counts_batch_reference(
        cpu_probs.contiguous(), torch.from_numpy(ds.labels).float()).numpy()
    near = ((cpu_probs - 0.5).abs() <= dprob).sum(dim=(1, 2)).numpy()
    dcounts = np.abs(gpu32["counts"] - cpu_counts).max(axis=1)
    print(f"slice fp32 card vs CPU: max |dprob| = {dprob}, max |dcount| "
          f"per sample = {dcounts.tolist()}, near-threshold pixels = "
          f"{near.tolist()}")
    if dprob > MODEL_PROB_TOL or (dcounts > near).any():
        raise AssertionError("slice on the card disagrees with the CPU")

    # Throughput of the evaluation loop over a device cache of 16 copies
    # of the 14 pairs (224 pairs), at the default bf16: one warm-up pass,
    # then PASSES timed passes per batch size.
    reps = 16
    big = pipelines.DeviceCache(cache.img1.repeat(reps, 1, 1, 1),
                                cache.img2.repeat(reps, 1, 1, 1),
                                cache.labels.repeat(reps, 1, 1))
    for bs in (2, 16):
        cfg = EvalConfig(batch_size=bs)
        probs_fn = pipelines.ensemble_fn([gpu_model], cfg.compute_dtype)
        pipelines.evaluate_cached(probs_fn, big, ds.cities * reps, cfg)
        rates = []
        for _ in range(PASSES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipelines.evaluate_cached(probs_fn, big, ds.cities * reps, cfg)
            torch.cuda.synchronize()
            rates.append(len(big) / (time.perf_counter() - t0))
        print(f"eval throughput (bf16, 128x128, {len(big)} pairs, bs {bs}): "
              f"median {float(np.median(rates)):.1f} pairs/s over {PASSES} "
              f"passes, range [{min(rates):.1f}, {max(rates):.1f}]")
    device_breakdown(
        torch, lambda: pipelines.evaluate_cached(
            pipelines.ensemble_fn([gpu_model], EvalConfig().compute_dtype),
            cache, ds.cities, EvalConfig()),
        "one bs-2 evaluation pass (14 pairs, bf16)", ("confusion_counts",))
    return counts


def phase_training(torch, root):
    """The training path at its defaults through its CLI, in this process:
    4 epochs over the 11 train and 3 val cities (3 train steps of 4+4+3
    pairs and 1 val batch per epoch), then a resume for one more epoch and
    an evaluation of the trained best_model.pth."""
    from gan_aug_pfa_torch import evaluate
    from gan_aug_pfa_torch.ops.kernels.fused_loss import FocalDiceLossFn
    from gan_aug_pfa_torch.train import __main__ as train_cli

    write_oscd_tree(root)
    reset_loss_counts(FocalDiceLossFn)
    t0 = time.time()
    history = train_cli.main(["--root-dir", root, "--num-epochs", "4",
                              "--save-every", "2"])
    wall = time.time() - t0
    counts = loss_counts(FocalDiceLossFn)
    print(f"training path: train main wall {wall:.2f} s, fused-loss "
          f"(calls, launches) {counts}, train loss {history['train_loss']}, "
          f"val loss {history['val_loss']}")
    if counts != {"fwd": (16, 16), "bwd": (12, 12)}:
        raise AssertionError(f"fused-loss counts {counts}; expected 16 "
                             "forward calls (12 train + 4 val) and 12 "
                             "backward, one launch each")
    losses = history["train_loss"] + history["val_loss"]
    if len(losses) != 8 or not all(np.isfinite(v) for v in losses):
        raise AssertionError(f"losses {losses}")
    train_history = {k: history[k] for k in ("train_loss", "val_loss")}
    ckpt_dir = os.path.join(root, "siamese_checkpoints")
    for name in ("best_model", "model_epoch_2", "model_epoch_4",
                 "last_state"):
        if not os.path.exists(os.path.join(ckpt_dir, name + ".pth")):
            raise AssertionError(f"{name}.pth not written")

    resumed = train_cli.main(["--root-dir", root, "--num-epochs", "5",
                              "--save-every", "2", "--resume"])
    if len(resumed["train_loss"]) != 1 or loss_counts(FocalDiceLossFn) != {
            "fwd": (20, 20), "bwd": (15, 15)}:
        raise AssertionError(f"resume ran {resumed['train_loss']}, fused-"
                             f"loss counts {loss_counts(FocalDiceLossFn)}")
    print(f"resume: one epoch, train loss {resumed['train_loss']}, val "
          f"loss {resumed['val_loss']}")

    report_path = os.path.join(root, "trained_report.json")
    check_report(evaluate.main(["--root-dir", root, "--json-out",
                                report_path]), report_path)
    return dict(counts, history=train_history)


def phase_train_card_vs_cpu(torch, ds):
    """3 fp32 train steps from one seeded init, on the card (kernels, TF32
    off) and on the CPU (plain version): the per-step losses agree."""
    from gan_aug_pfa_torch.config import SiameseTrainConfig
    from gan_aug_pfa_torch.pipelines import DeviceCache
    from gan_aug_pfa_torch.train.siamese import SiameseTrainer

    cfg = SiameseTrainConfig(compute_dtype="float32")
    rel = []
    runs = []
    for device in ("cuda", "cpu"):
        trainer = SiameseTrainer(cfg, device)
        cache = DeviceCache.from_dataset(ds, device)
        runs.append([float(trainer.train_step(
            cache, torch.arange(start, min(start + 4, len(ds)),
                                device=device)))
            for start in range(0, len(ds), 4)])
    rel = [abs(a - b) / abs(b) for a, b in zip(*runs)]
    print(f"train steps fp32 card vs CPU: losses {runs[0]} vs {runs[1]}, "
          f"relative differences {rel} (tolerances {TRAIN_STEP1_RTOL} for "
          f"step 1, {TRAIN_STEP_RTOL} after)")
    if not (rel[0] <= TRAIN_STEP1_RTOL
            and all(r <= TRAIN_STEP_RTOL for r in rel)):
        raise AssertionError("train steps on the card disagree with the CPU")
    return rel


def train_throughput(torch, ds):
    """Train steps/s and pairs/s at bs 4 and 16, bf16, over a device cache
    of 16 copies of the train pairs: one warm-up pass, then PASSES timed
    passes; then a profile of one epoch of the plain train split."""
    from gan_aug_pfa_torch.config import SiameseTrainConfig
    from gan_aug_pfa_torch.pipelines import DeviceCache
    from gan_aug_pfa_torch.train.siamese import SiameseTrainer

    cache = DeviceCache.from_dataset(ds, "cuda")
    reps = 16
    big = DeviceCache(cache.img1.repeat(reps, 1, 1, 1),
                      cache.img2.repeat(reps, 1, 1, 1),
                      cache.labels.repeat(reps, 1, 1))
    result = {}
    for bs in (4, 16):
        trainer = SiameseTrainer(SiameseTrainConfig(batch_size=bs), "cuda")
        rng = np.random.RandomState(SEED)
        trainer.train_epoch(big, rng)
        walls = []
        for _ in range(PASSES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_epoch(big, rng)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        steps = -(-len(big) // bs)
        steps_s = [steps / w for w in walls]
        pairs_s = [len(big) / w for w in walls]
        result[bs] = float(np.median(pairs_s))
        print(f"train throughput (bf16, 128x128, {len(big)} pairs, bs {bs}): "
              f"median {float(np.median(steps_s)):.2f} steps/s, "
              f"{result[bs]:.1f} pairs/s over {PASSES} passes, range "
              f"[{min(pairs_s):.1f}, {max(pairs_s):.1f}] pairs/s")
    trainer = SiameseTrainer(SiameseTrainConfig(), "cuda")
    rng = np.random.RandomState(SEED)
    trainer.train_epoch(cache, rng)
    device_breakdown(
        torch, lambda: trainer.train_epoch(cache, rng),
        f"one bs-4 train epoch ({len(cache)} pairs, 3 steps, bf16)",
        ("focal_dice",))
    return result


def reset_loss_counts(fn):
    fn.fwd_calls = fn.fwd_launches = fn.bwd_calls = fn.bwd_launches = 0


def loss_counts(fn):
    return {"fwd": (fn.fwd_calls, fn.fwd_launches),
            "bwd": (fn.bwd_calls, fn.bwd_launches)}


def reset_photometric_counts(ph):
    for fn in (ph.photometric_native_chw, ph.photometric_flip_chw):
        fn.calls = fn.launches = 0


def photometric_counts(ph):
    return {name: (fn.calls, fn.launches) for name, fn in (
        ("native", ph.photometric_native_chw),
        ("flip", ph.photometric_flip_chw))}


def phase_aug_training(torch, root):
    """The augmented training path through its CLI, in this process: 4
    epochs of ``--augment`` (native resolution, the default) over the 11
    train and 3 val cities, then one epoch of ``--augment
    --no-native-aug``.  Every count is set to 0 just before each run and
    read just after it."""
    from gan_aug_pfa_torch.ops.kernels import photometric as ph
    from gan_aug_pfa_torch.ops.kernels.fused_loss import FocalDiceLossFn
    from gan_aug_pfa_torch.train import __main__ as train_cli

    write_oscd_tree(root)
    runs = {}
    for name, flags, epochs in (
            ("native", [], 4),
            ("fixed_size", ["--no-native-aug", "--checkpoint-dir",
                            "fixed_checkpoints"], 1)):
        reset_photometric_counts(ph)
        reset_loss_counts(FocalDiceLossFn)
        t0 = time.time()
        history = train_cli.main(["--root-dir", root, "--augment",
                                  "--num-epochs", str(epochs),
                                  "--save-every", "2", *flags])
        wall = time.time() - t0
        counts = photometric_counts(ph)
        loss = loss_counts(FocalDiceLossFn)
        print(f"augmented training ({name}): train main wall {wall:.2f} s, "
              f"photometric (calls, launches) {counts}, fused-loss "
              f"(calls, launches) {loss}, train loss "
              f"{history['train_loss']}, val loss {history['val_loss']}")
        # 11 train pairs at batch 4: 3 steps an epoch, 2 images a step, one
        # launch a call.
        steps = 3 * epochs
        want = {"native": (2 * steps, 2 * steps), "flip": (0, 0)}
        if name == "fixed_size":
            want = {"native": (0, 0), "flip": (2 * steps, 2 * steps)}
        if counts != want or loss != {"fwd": (4 * epochs, 4 * epochs),
                                      "bwd": (steps, steps)}:
            raise AssertionError(f"{name}: photometric {counts}, expected "
                                 f"{want}; fused loss {loss}")
        losses = history["train_loss"] + history["val_loss"]
        if len(losses) != 2 * epochs or not all(np.isfinite(losses)):
            raise AssertionError(f"{name}: losses {losses}")
        runs[name] = {"counts": counts, "loss_launches": loss, "wall": wall,
                      "history": {k: history[k]
                                  for k in ("train_loss", "val_loss")}}
    for name in ("best_model", "model_epoch_2", "model_epoch_4",
                 "last_state"):
        if not os.path.exists(os.path.join(root, "siamese_checkpoints",
                                           name + ".pth")):
            raise AssertionError(f"{name}.pth not written")
    if not os.path.exists(os.path.join(root, "fixed_checkpoints",
                                       "best_model.pth")):
        raise AssertionError("fixed-size run wrote no best_model.pth")
    return runs


def aug_batches(torch, native_ds, fixed_ds, device):
    """Bs-4 augmented batches of the native and the fixed-size chain on
    ``device`` from one CPU draw each, and the caches they came from."""
    from gan_aug_pfa_torch.data import transforms as T
    from gan_aug_pfa_torch.pipelines import DeviceCache, NativeDeviceCache

    out = {}
    for name, cache_cls, ds in (("native", NativeDeviceCache, native_ds),
                                ("fixed_size", DeviceCache, fixed_ds)):
        cache = cache_cls.from_dataset(ds, device)
        idx = torch.arange(4, device=device)
        if name == "native":
            sizes = torch.from_numpy(ds.sizes[:4]).long()
        else:
            sizes = torch.tensor([list(ds.img1.shape[1:3])] * 4)
        params = T.sample_augment_params(
            torch.Generator().manual_seed(SEED), sizes)
        params = {k: v.to(device) for k, v in params.items()}
        nhwc = (cache.img1[:4].permute(0, 2, 3, 1),
                cache.img2[:4].permute(0, 2, 3, 1), cache.labels[:4])
        if name == "native":
            batch = T.augment_batch_native(*nhwc, sizes.to(device),
                                           (128, 128), params)
        else:
            batch = T.augment_batch(*nhwc, params)
        out[name] = (cache, idx, params, batch)
    return out


def phase_aug_card_vs_cpu(torch, native_ds, fixed_ds):
    """One drawn parameter dict per chain: the augmented batch on the card
    (kernels) vs the CPU (plain versions), then the first fp32 augmented
    train step's loss on each from one seeded init."""
    from gan_aug_pfa_torch.config import SiameseTrainConfig
    from gan_aug_pfa_torch.train.siamese import SiameseTrainer

    card = aug_batches(torch, native_ds, fixed_ds, "cuda")
    cpu = aug_batches(torch, native_ds, fixed_ds, "cpu")
    result = {}
    for name in card:
        g, c = card[name][3], cpu[name][3]
        img_err = max(float((a.cpu() - b).abs().max())
                      for a, b in zip(g[:2], c[:2]))
        mismatch = float((g[2].cpu() != c[2]).float().mean())
        losses = []
        for batches, device in ((card, "cuda"), (cpu, "cpu")):
            cache, idx, params, _ = batches[name]
            trainer = SiameseTrainer(
                SiameseTrainConfig(compute_dtype="float32"), device,
                augment=True,
                native_out_size=(128, 128) if name == "native" else None)
            losses.append(float(trainer.train_step(cache, idx, params)))
        rel = abs(losses[0] - losses[1]) / abs(losses[1])
        print(f"augmented {name} batch card vs CPU: max |dimg| {img_err} "
              f"(tolerance {CHAIN_ATOL}), label mismatch share {mismatch}; "
              f"first fp32 step loss {losses[0]} vs {losses[1]}, relative "
              f"{rel} (tolerance {TRAIN_STEP1_RTOL})")
        if (img_err > CHAIN_ATOL or mismatch > LABEL_MISMATCH_SHARE
                or rel > TRAIN_STEP1_RTOL):
            raise AssertionError(f"augmented {name} chain on the card "
                                 "disagrees with the CPU")
        result[name] = {"img_err": img_err, "label_mismatch": mismatch,
                        "step1_rel": rel}
    return result


def aug_throughput(torch, native_ds):
    """Augmented (native) train steps/s and pairs/s at bs 4, bf16, over a
    device cache of 16 copies of the train pairs: one warm-up pass, then
    PASSES timed passes; then a profile of one epoch of the plain train
    split with the photometric kernels' and the gathers' device shares."""
    from gan_aug_pfa_torch.config import SiameseTrainConfig
    from gan_aug_pfa_torch.pipelines import NativeDeviceCache
    from gan_aug_pfa_torch.train.siamese import SiameseTrainer

    cache = NativeDeviceCache.from_dataset(native_ds, "cuda")
    reps = 16
    big = NativeDeviceCache(cache.img1.repeat(reps, 1, 1, 1),
                            cache.img2.repeat(reps, 1, 1, 1),
                            cache.labels.repeat(reps, 1, 1),
                            cache.sizes.repeat(reps, 1))
    trainer = SiameseTrainer(SiameseTrainConfig(), "cuda", augment=True,
                             native_out_size=(128, 128))
    rng = np.random.RandomState(SEED)
    trainer.train_epoch(big, rng)
    walls = []
    for _ in range(PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_epoch(big, rng)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    steps = -(-len(big) // 4)
    steps_s = [steps / w for w in walls]
    pairs_s = [len(big) / w for w in walls]
    print(f"augmented train throughput (native {tuple(cache.img1.shape[2:])} "
          f"-> 128x128, bf16, {len(big)} pairs, bs 4): median "
          f"{float(np.median(steps_s)):.2f} steps/s, "
          f"{float(np.median(pairs_s)):.1f} pairs/s over {PASSES} passes, "
          f"range [{min(pairs_s):.1f}, {max(pairs_s):.1f}] pairs/s")
    trainer.train_epoch(cache, rng)
    busy_us, kernels = device_breakdown(
        torch, lambda: trainer.train_epoch(cache, rng),
        f"one bs-4 augmented train epoch ({len(cache)} pairs, 3 steps, "
        "bf16)", ("photometric",))
    for label, names in (("photometric kernels", ("photometric",)),
                         ("gathers (geometric stages)", ("gather",))):
        us = sum(e.self_device_time_total for e in kernels
                 if any(n in e.key for n in names))
        print(f"  share of device time in {label}: {us:.1f} us, "
              f"{100 * us / busy_us:.2f}%")
    return float(np.median(steps_s))


def gan_step_flops(torch, trainer, size):
    """FLOPs of one D+G step (batch 1) from the layer shapes: 2 x
    multiply-adds of every convolution and transposed convolution (BatchNorm,
    activations, losses and Adam not counted).  With F_G and F_D one
    forward's and F_G0 and F_D0 their first layers': the D step's G forward
    F_G; two D passes of forward, weight gradient and input gradient
    without the first layer's, 2 (3 F_D - F_D0); the G step's G forward,
    weight gradient and input gradient without the first layer's,
    3 F_G - F_G0; its D pass forward and input gradient, 2 F_D."""
    counts = []

    def hook(module, inputs, out):
        if isinstance(module, torch.nn.ConvTranspose2d):
            macs = inputs[0].numel() * module.out_channels * module.weight[
                0, 0].numel()
        else:
            macs = out.numel() * module.weight[0].numel()
        counts.append(2 * macs)

    totals = []
    for model, channels in ((trainer.generator, 3),
                            (trainer.discriminator, 6)):
        hooks = [m.register_forward_hook(hook) for m in model.modules()
                 if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
        counts.clear()
        with torch.no_grad():
            model.eval()(torch.zeros(1, channels, size, size,
                                     device=trainer.device))
        for h in hooks:
            h.remove()
        totals.append((sum(counts), counts[0]))
    (f_g, f_g0), (f_d, f_d0) = totals
    return {"step": 4 * f_g - f_g0 + 8 * f_d - 2 * f_d0,
            "g_forward": f_g, "d_forward": f_d}


def phase_gan(torch, root):
    """GAN training at its defaults through its CLI, in this process: 2
    epochs over the 14 cities (14 steps of batch 1 an epoch), then a
    resumed third; the files, the strip and the epoch-3 generator."""
    from gan_aug_pfa_torch import train_gan as gan_cli
    from gan_aug_pfa_torch.data import png
    from gan_aug_pfa_torch.models import UNetGenerator

    write_oscd_tree(root)
    t0 = time.time()
    history = gan_cli.main(["--root-dir", root, "--num-epochs", "2"])
    wall = time.time() - t0
    resumed = gan_cli.main(["--root-dir", root, "--num-epochs", "3",
                            "--resume"])
    losses = {k: history[k] + resumed[k] for k in ("loss_d", "loss_g")}
    print(f"GAN training: train_gan main wall {wall:.2f} s for 2 epochs, "
          f"resumed third; losses {losses}")
    if len(losses["loss_d"]) != 3 or not np.isfinite(
            losses["loss_d"] + losses["loss_g"]).all():
        raise AssertionError(f"GAN losses {losses}")
    ckpt_dir = os.path.join(root, "gan_checkpoints")
    want = sorted(f"{kind}_epoch_{e}.pth" for kind in ("generator",
                                                       "discriminator")
                  for e in (2, 3)) + ["last_discriminator.pth",
                                      "last_generator.pth"]
    if sorted(os.listdir(ckpt_dir)) != want:
        raise AssertionError(f"GAN checkpoints {os.listdir(ckpt_dir)}")
    strips = sorted(os.listdir(os.path.join(root, "gan_samples")))
    shapes = [png.decode_rgb(os.path.join(root, "gan_samples", f)).shape
              for f in strips]
    if (len(strips) != 2 or not strips[1].endswith("_epoch_003.png")
            or any(sh != (256, 768, 3) for sh in shapes)):
        raise AssertionError(f"GAN strips {strips} {shapes}")
    UNetGenerator().load_state_dict(torch.load(
        os.path.join(ckpt_dir, "generator_epoch_3.pth"), weights_only=True),
        strict=True)
    print(f"GAN files: {want}; strips {strips} at 256x768; "
          "generator_epoch_3.pth loads strictly")
    return losses


def phase_gan_card_vs_cpu(torch, ds):
    """One fp32 D+G step from one seeded init on the card (TF32 off) and on
    the CPU, on the first pair of the cache."""
    from gan_aug_pfa_torch.config import GANTrainConfig
    from gan_aug_pfa_torch.train.gan import GANTrainer

    losses = []
    for device in ("cuda", "cpu"):
        trainer = GANTrainer(GANTrainConfig(compute_dtype="float32"), device)
        a, b = (torch.from_numpy(x[:1]).permute(0, 3, 1, 2).contiguous()
                .to(device) for x in (ds.img1, ds.img2))
        losses.append([float(v) for v in trainer.train_batch(a, b)])
    rel = [abs(c - p) / abs(p) for c, p in zip(*losses)]
    print(f"GAN step fp32 card vs CPU: (loss_D, loss_G) {losses[0]} vs "
          f"{losses[1]}, relative differences {rel} (tolerances "
          f"{GAN_LOSS_D_RTOL}, {GAN_LOSS_G_RTOL})")
    if rel[0] > GAN_LOSS_D_RTOL or rel[1] > GAN_LOSS_G_RTOL:
        raise AssertionError("GAN step on the card disagrees with the CPU")
    return rel


def gan_throughput(torch, ds):
    """GAN steps/s at batch 1, bf16, 256x256: one warm-up epoch over the 14
    pairs, then PASSES timed epochs; a profile of one epoch; the step's
    FLOPs against the dense bf16 peak."""
    from gan_aug_pfa_torch.config import GANTrainConfig
    from gan_aug_pfa_torch.pipelines import DeviceCache
    from gan_aug_pfa_torch.train.gan import GANTrainer

    cache = DeviceCache.from_dataset(ds, "cuda")
    trainer = GANTrainer(GANTrainConfig(), "cuda")
    rng = np.random.RandomState(SEED)
    trainer.train_epoch(cache, rng)
    rates = []
    for _ in range(PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_epoch(cache, rng)
        torch.cuda.synchronize()
        rates.append(len(cache) / (time.perf_counter() - t0))
    median = float(np.median(rates))
    print(f"GAN throughput (bf16, 256x256, batch 1, {len(cache)} steps an "
          f"epoch): median {median:.2f} steps/s over {PASSES} epochs, range "
          f"[{min(rates):.2f}, {max(rates):.2f}]")
    busy_us, kernels = device_breakdown(
        torch, lambda: trainer.train_epoch(cache, rng),
        f"one GAN epoch ({len(cache)} steps, batch 1, bf16)", (), top=10)
    launches = sum(e.count for e in kernels) / len(cache)
    flops = gan_step_flops(torch, trainer, 256)
    share = flops["step"] * median / BF16_OPS_PER_S
    print(f"GAN step: {launches:.1f} kernel launches a step; "
          f"{flops['step'] / 1e9:.2f} GFLOP a step (G forward "
          f"{flops['g_forward'] / 1e9:.2f}, D forward "
          f"{flops['d_forward'] / 1e9:.2f}), at {median:.2f} steps/s "
          f"{flops['step'] * median / 1e12:.2f} TFLOP/s, "
          f"{100 * share:.2f}% of the dense bf16 peak "
          f"({BF16_OPS_PER_S / 1e12:.0f} TFLOP/s)")
    return {"steps_s": rates, "launches_per_step": launches,
            "busy_us": busy_us, "flops": flops, "peak_share": share}


def phase_synthesis(torch, root):
    """Synthesis at its defaults through its CLI, in this process, with the
    epoch-3 generator; the 14 triples against the cache and a CPU run; the
    generator's and the PNG writer's time."""
    from gan_aug_pfa_torch import checkpoint, generate_synthetic as synth_cli
    from gan_aug_pfa_torch.data import png
    from gan_aug_pfa_torch.data.loader import (
        build_cached_dataset,
        float_to_uint8,
    )
    from gan_aug_pfa_torch.data.scanner import create_sample_lists
    from gan_aug_pfa_torch.models import UNetGenerator
    from gan_aug_pfa_torch.train.gan import generate

    t0 = time.time()
    n = synth_cli.main(["--root-dir", root, "--generator-checkpoint-name",
                        "generator_epoch_3.pth"])
    wall = time.time() - t0
    if n != len(CITIES):
        raise AssertionError(f"synthesis wrote {n} samples")
    ds = build_cached_dataset(
        create_sample_lists(root, SUBDIR, mode="all", verbose=False),
        (256, 256), verbose=False)
    generator = UNetGenerator()
    checkpoint.restore_model_only(
        os.path.join(root, "gan_checkpoints", "generator_epoch_3.pth"),
        generator)
    # NHWC views of an NCHW cache, as the pipeline passes them.
    img1_cpu = torch.from_numpy(ds.img1).permute(0, 3, 1, 2).contiguous()
    fake_cpu = np.concatenate([
        generate(generator, img1_cpu[i:i + 4].permute(0, 2, 3, 1)).numpy()
        for i in range(0, len(ds), 4)])
    base = os.path.join(root, "synthetic_data")
    diffs = []
    for i, city in enumerate(ds.cities):
        img1 = png.decode_rgb(os.path.join(base, "images", city,
                                           f"img1_synth_{i}.png"))
        img2 = png.decode_rgb(os.path.join(base, "images", city,
                                           f"img2_synth_{i}.png"))
        label = png.decode_gray(os.path.join(base, "labels", city,
                                             f"cm_synth_{i}.png"))
        replay = (ds.img1[i] * np.float32(2) - np.float32(1)) * np.float32(
            0.5) + np.float32(0.5)
        if not (np.array_equal(img1, float_to_uint8(replay))
                and np.array_equal(label, ds.labels[i] * 255)):
            raise AssertionError(f"synthetic img1 or label {i} ({city}) "
                                 "differs from the cache")
        diffs.append(np.abs(img2.astype(int) - float_to_uint8(fake_cpu[i])))
    diffs = np.concatenate([d.ravel() for d in diffs])
    share = float((diffs > 0).mean())
    print(f"synthesis: {n} triples in {wall:.2f} s ({n / wall:.2f} pairs/s "
          f"through the CLI, cache and model load included); img1 and "
          f"labels equal the cache; img2 card vs CPU max {diffs.max()} LSB "
          f"on {100 * share:.4f}% of pixels (limit 1 LSB on "
          f"{100 * SYNTH_LSB_SHARE}%)")
    if diffs.max() > 1 or share > SYNTH_LSB_SHARE:
        raise AssertionError("synthetic img2 on the card disagrees with the "
                             "CPU")

    # The split: the generator over the 14 pairs at batch 4 on the card,
    # and the 42 PNG writes on the host, PASSES times each.
    generator.cuda()
    img1 = img1_cpu.cuda().permute(0, 2, 3, 1)
    replays = [float_to_uint8((x * np.float32(2) - np.float32(1))
                              * np.float32(0.5) + np.float32(0.5))
               for x in ds.img1]
    gen_s, write_s = [], []
    with tempfile.TemporaryDirectory() as out:
        for rep in range(PASSES + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fakes = [generate(generator, img1[i:i + 4]) for i in
                     range(0, len(ds), 4)]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fake = np.concatenate([f.cpu().numpy() for f in fakes])
            t2 = time.perf_counter()
            for i in range(len(ds)):
                for name, arr in (("a", replays[i]),
                                  ("b", float_to_uint8(fake[i])),
                                  ("c", ds.labels[i].astype(np.uint8) * 255)):
                    png.write_png(os.path.join(out, f"{name}{i}.png"), arr)
            if rep:  # the first pass warms cuDNN up
                gen_s.append(t1 - t0)
                write_s.append(time.perf_counter() - t2)
    g, w = float(np.median(gen_s)), float(np.median(write_s))
    print(f"synthesis split (fp32, 256x256, batch 4, {len(ds)} pairs, median "
          f"of {PASSES}): generator {1e3 * g:.2f} ms ({len(ds) / g:.1f} "
          f"pairs/s, range [{1e3 * min(gen_s):.2f}, {1e3 * max(gen_s):.2f}] "
          f"ms), PNG writes {1e3 * w:.1f} ms ({len(ds) / w:.1f} pairs/s, "
          f"range [{1e3 * min(write_s):.1f}, {1e3 * max(write_s):.1f}] ms); "
          f"{len(ds) / (g + w):.1f} pairs/s together")
    return {"cli_pairs_s": n / wall, "generator_s": gen_s, "write_s": write_s,
            "img2_lsb_share": share}


def phase_loop(torch, root):
    """Siamese training on the real and the port's synthetic train pairs
    through its CLI (2 epochs at the defaults), then an evaluation of the
    trained model, each with its kernels' counts set to 0 just before and
    read just after."""
    from gan_aug_pfa_torch import evaluate
    from gan_aug_pfa_torch.data.scanner import create_sample_lists
    from gan_aug_pfa_torch.ops.kernels import confusion_counts as cc
    from gan_aug_pfa_torch.ops.kernels.fused_loss import FocalDiceLossFn
    from gan_aug_pfa_torch.train import __main__ as train_cli

    train = create_sample_lists(root, SUBDIR, mode="train",
                                use_synthetic=True, verbose=False)
    n_synth = sum(s.is_synthetic for s in train)
    reset_loss_counts(FocalDiceLossFn)
    history = train_cli.main(["--root-dir", root, "--use-synthetic",
                              "--num-epochs", "2"])
    counts = loss_counts(FocalDiceLossFn)
    steps = -(-len(train) // 4)
    want = {"fwd": (2 * (steps + 1), 2 * (steps + 1)),
            "bwd": (2 * steps, 2 * steps)}
    print(f"loop training on {len(train)} pairs ({n_synth} synthetic): "
          f"fused-loss (calls, launches) {counts}, train loss "
          f"{history['train_loss']}, val loss {history['val_loss']}")
    if n_synth != 11 or counts != want or not np.isfinite(
            history["train_loss"] + history["val_loss"]).all():
        raise AssertionError(f"loop training: {n_synth} synthetic pairs, "
                             f"counts {counts}, expected {want}")
    fn = cc.confusion_counts_batch
    fn.calls = fn.launches = 0
    report_path = os.path.join(root, "loop_report.json")
    result = evaluate.main(["--root-dir", root, "--json-out", report_path])
    eval_counts = (fn.calls, fn.launches)
    print(f"loop evaluation: confusion_counts (calls, launches) "
          f"{eval_counts}")
    if eval_counts != (7, 7):
        raise AssertionError(f"loop evaluation counts {eval_counts}")
    check_report(result, report_path)
    return {"loss": counts, "confusion_counts": eval_counts}


REPO = os.path.dirname(os.path.abspath(__file__))
# A preempted trainer finishes its epoch, writes and exits within this.
SIGTERM_EXIT_S = 60.0
FIXTURE = os.path.join(REPO, "tests", "data", "jax_generator_nd5_ngf4")
FIXTURE_ATOL = 1e-5  # the JAX generator's fp32 output, card vs JAX (CPU)


class Tee:
    """A stdout that also keeps what it was given."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.parts)


def run_child(args, sigterm_at=None, timeout=300.0):
    """Run ``python -u args`` from the repository root, echoing its
    output.  With ``sigterm_at`` (a regular expression), send SIGTERM to
    the child's PID alone (not its process group) when a line matches.
    Returns (exit code, output lines, seconds from the signal to the
    exit).  Kills the child and raises when it outlives ``timeout``."""
    import queue
    import re
    import signal
    import threading

    proc = subprocess.Popen(
        [sys.executable, "-u", *args], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    out, t_sig, deadline = [], None, time.time() + timeout
    try:
        while True:
            try:
                line = lines.get(timeout=max(0.0, deadline - time.time()))
            except queue.Empty:
                raise AssertionError(f"{args[:2]} still running after "
                                     f"{timeout} s")
            if line is None:
                break
            out.append(line.rstrip("\n"))
            print(f"  | {out[-1]}")
            if (sigterm_at and t_sig is None
                    and re.search(sigterm_at, out[-1])):
                os.kill(proc.pid, signal.SIGTERM)
                t_sig = time.time()
                print(f"  (SIGTERM sent to pid {proc.pid})")
        rc = proc.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rc, out, (time.time() - t_sig if t_sig is not None else None)


def last_epoch(lines, pattern):
    import re

    found = [int(m.group(1)) for m in map(re.compile(pattern).match, lines)
             if m]
    if not found:
        raise AssertionError(f"no line matches {pattern!r}")
    return found[-1]


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def phase_run_control(torch, root):
    """Run control on the card through the CLIs: a Siamese run preempted
    by SIGTERM in epoch 2 (or 3) of 50 with every run-control flag, resumed
    for 2 epochs in this process with the fused-loss counts read; the same
    for the GAN at its defaults (its preempted run beside the Siamese
    part); an evaluation of the deferred best_model.pth with the confusion
    counts read."""
    from gan_aug_pfa_torch import evaluate
    from gan_aug_pfa_torch import train_gan as gan_cli
    from gan_aug_pfa_torch.ops.kernels import confusion_counts as cc
    from gan_aug_pfa_torch.ops.kernels.fused_loss import FocalDiceLossFn
    from gan_aug_pfa_torch.train import __main__ as train_cli

    write_oscd_tree(root)
    log = os.path.join(root, "run.jsonl")
    prof = os.path.join(root, "prof")
    flags = ["--root-dir", root, "--save-every", "50", "--log-jsonl", log,
             "--defer-best-ckpt", "--async-ckpt", "--profile-dir", prof]
    # The GAN's preempted CLI run goes on in a thread of its own beside the
    # Siamese part (nothing here is timed but the exits, each held to its
    # bound); its checks follow the Siamese part's.
    gan_log = os.path.join(root, "gan.jsonl")
    gan_flags = ["--root-dir", root, "--log-jsonl", gan_log, "--async-ckpt",
                 "--profile-dir", os.path.join(root, "gan_prof")]
    gan_run = {}

    def preempted_gan():
        try:
            gan_run["out"] = run_child(
                ["-m", "gan_aug_pfa_torch.train_gan", *gan_flags],
                sigterm_at=r"^Epoch 1 - ")
        except BaseException as e:  # raised again in the main thread
            gan_run["error"] = e

    gan_thread = threading.Thread(target=preempted_gan)
    gan_thread.start()
    t0 = time.time()
    rc, lines, exit_s = run_child(
        ["-m", "gan_aug_pfa_torch.train", *flags, "--num-epochs", "50"],
        sigterm_at=r"^Epoch 2/50 ")
    wall = time.time() - t0
    n = last_epoch(lines, r"^Epoch (\d+) - Train Loss")
    ckpt_dir = os.path.join(root, "siamese_checkpoints")
    state = torch.load(os.path.join(ckpt_dir, "last_state.pth"),
                       map_location="cpu", weights_only=True)
    print(f"run control, Siamese: exit {rc} {exit_s:.2f} s after SIGTERM "
          f"({wall:.2f} s in all), last epoch printed {n}, last_state.pth "
          f"epoch {state['epoch']}, files {sorted(os.listdir(ckpt_dir))}")
    if (rc != 0 or exit_s > SIGTERM_EXIT_S or state["epoch"] != n
            or not any(line.startswith("Preemption requested") for line in
                       lines)
            or not os.path.exists(os.path.join(ckpt_dir, "best_model.pth"))):
        raise AssertionError("the preempted Siamese run did not save and "
                             "exit cleanly")

    reset_loss_counts(FocalDiceLossFn)
    tee = Tee(sys.stdout)
    sys.stdout = tee
    try:
        resumed = train_cli.main([*flags, "--num-epochs", str(n + 2),
                                  "--resume"])
    finally:
        sys.stdout = tee.out
    counts = loss_counts(FocalDiceLossFn)
    events = read_jsonl(log)
    starts = [e["start_epoch"] for e in events if e["event"] == "run_start"]
    print(f"run control, resume: {len(resumed['train_loss'])} epochs, "
          f"fused-loss (calls, launches) {counts}, run_start epochs "
          f"{starts}, events {[e['event'] for e in events]}")
    if (len(resumed["train_loss"]) != 2 or starts != [1, n + 1]
            or counts != {"fwd": (8, 8), "bwd": (6, 6)}
            or "Step timing: " not in tee.text()):
        raise AssertionError("the resumed run did not run exactly 2 epochs "
                             "(3 steps and 1 validation batch each) with "
                             "one launch a loss call and its step timing")
    summary = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "summarize_runlog.py"), log],
        capture_output=True, text=True, timeout=60)
    print(summary.stdout.rstrip())
    if summary.returncode != 0 or f"preempted at epoch {n}" not in (
            summary.stdout):
        raise AssertionError(f"summarize_runlog.py: {summary.stderr}")
    traces = [os.path.join(prof, f) for f in sorted(os.listdir(prof))]
    named = {}
    for path in traces:
        with open(path) as f:
            text = f.read()
        named[os.path.basename(path)] = (
            len(text), all(k in text for k in ("focal_dice_fwd_kernel",
                                               "focal_dice_bwd_kernel")))
    print(f"profiler traces (bytes, names both loss kernels): {named}")
    if len(traces) != 2 or not all(ok for _, ok in named.values()):
        raise AssertionError("the profile directory lacks a trace naming "
                             "the fused-loss kernels")

    fn = cc.confusion_counts_batch
    fn.calls = fn.launches = 0
    report_path = os.path.join(root, "deferred_report.json")
    check_report(evaluate.main(["--root-dir", root, "--json-out",
                                report_path]), report_path)
    eval_counts = (fn.calls, fn.launches)
    print(f"run control, evaluation of the deferred best_model.pth: "
          f"confusion_counts (calls, launches) {eval_counts}")
    if eval_counts != (7, 7):
        raise AssertionError(f"evaluation counts {eval_counts}")

    gan_thread.join()
    if "error" in gan_run:
        raise gan_run["error"]
    rc, lines, gan_exit_s = gan_run["out"]
    m = last_epoch(lines, r"^Epoch (\d+) - Avg Loss D")
    gan_dir = os.path.join(root, "gan_checkpoints")
    files = sorted(os.listdir(gan_dir))
    want = sorted([f"generator_epoch_{m}.pth", f"discriminator_epoch_{m}.pth",
                   "last_generator.pth", "last_discriminator.pth"])
    epochs = [torch.load(os.path.join(gan_dir, f), map_location="cpu",
                         weights_only=True)["epoch"]
              for f in ("last_generator.pth", "last_discriminator.pth")]
    print(f"run control, GAN: exit {rc} {gan_exit_s:.2f} s after SIGTERM, "
          f"last epoch printed {m}, files {files}, last_* epochs {epochs}")
    if rc != 0 or gan_exit_s > SIGTERM_EXIT_S or files != want or (
            epochs != [m, m]):
        raise AssertionError("the preempted GAN run did not save and exit "
                             "cleanly")
    gan_resumed = gan_cli.main([*gan_flags, "--num-epochs", str(m + 1),
                                "--resume"])
    gan_events = read_jsonl(gan_log)
    gan_starts = [e["start_epoch"] for e in gan_events
                  if e["event"] == "run_start"]
    print(f"run control, GAN resume: {len(gan_resumed['loss_d'])} epoch, "
          f"run_start epochs {gan_starts}")
    if len(gan_resumed["loss_d"]) != 1 or gan_starts != [1, m + 1] or (
            not os.path.exists(os.path.join(
                gan_dir, f"generator_epoch_{m + 1}.pth"))):
        raise AssertionError("the GAN did not resume at the next epoch")
    return {"siamese_exit_s": exit_s, "gan_exit_s": gan_exit_s,
            "epochs": (n, m), "loss": counts, "confusion_counts": eval_counts}


def phase_run_control_in_process(torch, ds):
    """On the card, in this process: the NaN check through the pipeline;
    last_state.pth of one trained full-width state written synchronously
    and in the background (training on while the background write runs),
    the files equal key for key, and each save's blocking time; then
    ``run_control_rates`` in a child process."""
    from gan_aug_pfa_torch import checkpoint, pipelines
    from gan_aug_pfa_torch.config import DataConfig, SiameseTrainConfig
    from gan_aug_pfa_torch.models import SiameseUNet
    from gan_aug_pfa_torch.train.plateau import (
        EarlyStopping,
        make_plateau_scheduler,
    )
    from gan_aug_pfa_torch.train.siamese import SiameseTrainer

    with tempfile.TemporaryDirectory() as root:
        write_oscd_tree(root)
        bad = SiameseUNet().state_dict()
        bad["dconv_down1.0.weight"][0, 0, 0, 0] = float("nan")
        outcome = {}
        for debug in (True, False):
            try:
                hist = pipelines.run_siamese_training(
                    DataConfig(root_dir=root),
                    SiameseTrainConfig(num_epochs=1, debug_nans=debug),
                    verbose=False, initial_state_dict=bad)
                outcome[debug] = f"no error, train loss {hist['train_loss']}"
            except FloatingPointError as e:
                outcome[debug] = f"FloatingPointError: {str(e)[:160]}"
    print(f"NaN check: with --debug-nans {outcome[True]}; without "
          f"{outcome[False]}")
    if not outcome[True].startswith(
            "FloatingPointError: non-finite values in epoch 1, step 1: "
            "['loss', 'grad dconv_down1.0.weight'") or not (
                outcome[False].startswith("no error")):
        raise AssertionError("the NaN check did not name step 1")

    cache = pipelines.DeviceCache.from_dataset(ds, "cuda")
    trainer = SiameseTrainer(SiameseTrainConfig(), "cuda")
    scheduler = make_plateau_scheduler(trainer.optimizer)
    stopper = EarlyStopping()
    rng = np.random.RandomState(SEED)
    trainer.train_epoch(cache, rng)
    writer = checkpoint.AsyncCheckpointWriter()
    timings = {"sync": [], "async": [], "async_done": []}
    with tempfile.TemporaryDirectory() as out:
        for rep in range(3):
            payload = checkpoint.train_state(trainer.model, trainer.optimizer,
                                             scheduler, stopper, 1, 0.5)
            sync_path = os.path.join(out, f"sync{rep}.pth")
            async_path = os.path.join(out, f"async{rep}.pth")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            checkpoint.save(sync_path, payload)
            timings["sync"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            writer.save(async_path, payload)
            timings["async"].append(time.perf_counter() - t0)
            # Training goes on while the write runs: the file must still
            # hold the state as it was at the save.
            trainer.train_epoch(cache, rng)
            writer.wait()
            timings["async_done"].append(time.perf_counter() - t0)
            a, b = (torch.load(p, weights_only=True)
                    for p in (sync_path, async_path))
            diff = compare_nested(torch, a, b)
            if diff:
                raise AssertionError(f"sync and async last_state differ at "
                                     f"{diff}")
        size = os.path.getsize(sync_path)
    writer.close()
    ms = {k: [round(1e3 * v, 2) for v in vs] for k, vs in timings.items()}
    print(f"last_state.pth ({size / 1e6:.1f} MB, model + AdamW moments): "
          f"blocking time of a synchronous save {ms['sync']} ms; of a "
          f"background save {ms['async']} ms (its write done, with a train "
          f"epoch between, after {ms['async_done']} ms); files equal key "
          f"for key")

    rc, _, _ = run_child(["-c", "import sys, chip_smoke; "
                               "sys.exit(chip_smoke.run_control_rates())"])
    if rc != 0:
        raise AssertionError(f"run_control_rates exited {rc}")
    return {"save_ms": ms}


def run_control_rates():
    """Train steps/s at batch 4 (bf16, 128x128, 8 copies of the 11 train
    pairs: 22 steps an epoch), median of 3 epochs after one warm-up,
    plain, under --debug-nans (the NaN checks) and under --profile-dir
    (the step timer and the profiler), in that order: a profiler session
    slows a process's later launch-bound steps, so it comes last, in a
    process of its own (``chip_smoke`` runs this as a child)."""
    from contextlib import nullcontext

    import torch

    from gan_aug_pfa_torch import pipelines
    from gan_aug_pfa_torch.config import SiameseTrainConfig
    from gan_aug_pfa_torch.data.loader import build_cached_dataset
    from gan_aug_pfa_torch.data.scanner import create_sample_lists
    from gan_aug_pfa_torch.train.siamese import SiameseTrainer
    from gan_aug_pfa_torch.utils import profiling

    with tempfile.TemporaryDirectory() as root:
        write_oscd_tree(root)
        ds = build_cached_dataset(
            create_sample_lists(root, SUBDIR, mode="train", verbose=False),
            (128, 128), verbose=False)
    cache = pipelines.DeviceCache.from_dataset(ds, "cuda")
    reps = 8
    big = pipelines.DeviceCache(cache.img1.repeat(reps, 1, 1, 1),
                                cache.img2.repeat(reps, 1, 1, 1),
                                cache.labels.repeat(reps, 1, 1))
    steps = -(-len(big) // 4)
    rates = {}
    with tempfile.TemporaryDirectory() as prof:
        for mode in ("plain", "debug-nans", "profile-dir"):
            trainer = SiameseTrainer(SiameseTrainConfig(), "cuda")
            if mode == "debug-nans":
                profiling.enable_nan_checks(trainer)
            rng = np.random.RandomState(SEED)
            trainer.train_epoch(big, rng)
            if mode == "profile-dir":
                trainer.step_timer = profiling.StepTimer(4, skip_first=2)
            walls = []
            with (profiling.trace(prof) if mode == "profile-dir"
                  else nullcontext()):
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    trainer.train_epoch(big, rng)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
            rates[mode] = [steps / w for w in walls]
            extra = (" " + trainer.step_timer.format_summary("step timer: ")
                     if trainer.step_timer else "")
            print(f"train steps/s (bf16, 128x128, bs 4, {steps} steps an "
                  f"epoch) {mode}: median "
                  f"{float(np.median(rates[mode])):.2f} over 3 epochs, range "
                  f"[{min(rates[mode]):.2f}, {max(rates[mode]):.2f}]{extra}")
    return 0


def compare_nested(torch, a, b, prefix=""):
    """The first key path where two loaded checkpoints differ, or None."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or list(a) != list(b):
            return prefix or "/"
        for k in a:
            diff = compare_nested(torch, a[k], b[k], f"{prefix}/{k}")
            if diff:
                return diff
        return None
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return prefix
        for i, (x, y) in enumerate(zip(a, b)):
            diff = compare_nested(torch, x, y, f"{prefix}/{i}")
            if diff:
                return diff
        return None
    if isinstance(a, torch.Tensor):
        ok = (isinstance(b, torch.Tensor) and a.dtype == b.dtype
              and torch.equal(a, b))
        return None if ok else prefix
    return None if a == b else prefix


def phase_jax_checkpoint(torch, root):
    """A checkpoint the JAX package wrote (tests/data, made by
    tools/make_msgpack_fixture.py) on the card: synthesis through its CLI
    with it, then its generator at fp32 (TF32 off) on the fixture's input
    against the JAX output saved beside it."""
    from gan_aug_pfa_torch import checkpoint, generate_synthetic as synth_cli
    from gan_aug_pfa_torch.models import UNetGenerator
    from gan_aug_pfa_torch.train.siamese import tf32_off

    write_oscd_tree(root)
    out = os.path.join(root, "jax_synth")
    n = synth_cli.main([
        "--root-dir", root, "--num-downs", "5", "--ngf", "4",
        "--target-size", "32x32", "--gan-checkpoint-dir",
        os.path.dirname(FIXTURE), "--generator-checkpoint-name",
        os.path.basename(FIXTURE) + ".msgpack", "--synthetic-data-dir", out])
    written = sum(len(fs) for _, _, fs in os.walk(out))
    t0 = time.perf_counter()
    model = checkpoint.restore_model_only(FIXTURE + ".msgpack",
                                          UNetGenerator(num_downs=5, ngf=4))
    load_ms = 1e3 * (time.perf_counter() - t0)
    expected = np.load(FIXTURE + "_expected.npz")
    x = torch.from_numpy(expected["x"]).cuda().permute(0, 3, 1, 2)
    with torch.no_grad(), tf32_off():
        y = model.cuda().eval()(x).permute(0, 2, 3, 1).cpu().numpy()
    err = float(np.abs(y - expected["y"]).max())
    print(f"JAX-written generator on the card: synthesis through the CLI "
          f"wrote {n} samples ({written} files); load of the .msgpack "
          f"{load_ms:.1f} ms; fp32 output vs JAX max |diff| {err:.3g} "
          f"(limit {FIXTURE_ATOL})")
    if n != len(CITIES) or written != 3 * len(CITIES) or err > FIXTURE_ATOL:
        raise AssertionError("the JAX-written generator does not run as JAX "
                             "on the card")
    return err


def run_captured(fn, *args):
    """``fn(*args)`` with its standard output captured and then printed:
    (result, the output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    text = buf.getvalue()
    print(text, end="")
    return result, text


def counted_eval(torch, cc, argv, label):
    """``evaluate.main(argv)`` with the confusion counts' (calls, launches)
    set to 0 just before and read just after; prints its wall time."""
    from gan_aug_pfa_torch import evaluate

    fn = cc.confusion_counts_batch
    fn.calls = fn.launches = 0
    t0 = time.time()
    result, text = run_captured(evaluate.main, argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = (fn.calls, fn.launches)
    print(f"evaluation extras, {label}: evaluate.main wall {wall:.2f} s, "
          f"confusion counts (calls, launches) {counts}")
    if result is None:
        raise AssertionError(f"{label}: the evaluation returned None")
    return result, text, counts, wall


def phase_eval_extras(torch, root):
    """Phase 13: the evaluation CLI's extras on the card over a 14-city
    tree and two seeded full-width checkpoints: (a) a two-model ensemble
    with the threshold sweep, (b) post-processing with 2 panels, (c)
    single-pair evaluation of one city's native PNGs; each with the
    confusion counts' (calls, launches) read around it, then held against
    the plain version and the CPU."""
    from gan_aug_pfa_torch import checkpoint, evaluate, pipelines
    from gan_aug_pfa_torch.config import EvalConfig
    from gan_aug_pfa_torch.data.loader import build_cached_dataset
    from gan_aug_pfa_torch.data.pil_resize import resize_nearest
    from gan_aug_pfa_torch.data.png import decode_gray
    from gan_aug_pfa_torch.data.scanner import create_sample_lists
    from gan_aug_pfa_torch.metrics import (
        confusion_counts_sweep,
        sweep_thresholds,
    )
    from gan_aug_pfa_torch.models import SiameseUNet
    from gan_aug_pfa_torch.ops import morphology
    from gan_aug_pfa_torch.ops.kernels import confusion_counts as cc
    from gan_aug_pfa_torch.utils.viz import skip_message

    write_oscd_tree(root)
    paths = [os.path.join(root, f"model_{s}.pth") for s in (SEED, SEED + 1)]
    for seed, path in zip((SEED, SEED + 1), paths):
        checkpoint.save_model(path, seeded_model(torch, SiameseUNet, seed))
    ds = build_cached_dataset(
        create_sample_lists(root, SUBDIR, mode="all", verbose=False),
        (128, 128), verbose=False)
    batches = -(-len(ds) // EvalConfig().batch_size)
    grid = sweep_thresholds()
    base = ["--root-dir", root, "--num-visualizations", "0"]
    out = {}

    # (a) Ensemble + sweep at the defaults (bf16, batch 2).
    report_path = os.path.join(root, "sweep_report.json")
    result, _, out["sweep"], _ = counted_eval(
        torch, cc, base + ["--ensemble", *paths, "--threshold-sweep",
                           "--json-out", report_path], "ensemble + sweep")
    want = (batches * (1 + len(grid)),) * 2
    if out["sweep"] != want:
        raise AssertionError(f"sweep: (calls, launches) {out['sweep']}, "
                             f"expected {want}")
    with open(report_path) as f:
        report = json.load(f)
    with open(os.path.join(root, "evaluation_results",
                           "threshold_sweep.json")) as f:
        sweep_json = json.load(f)
    if (report["sweep"] != sweep_json or report["checkpoints"] != paths
            or result["sweep"] != sweep_json
            or sweep_json["thresholds"] != grid.tolist()
            or sweep_json["best_threshold"] != grid[
                int(np.argmax(sweep_json["f1"]))]):
        raise AssertionError(f"sweep report and threshold_sweep.json "
                             f"disagree: {report['sweep']} {sweep_json}")
    print("sweep: best threshold "
          f"{sweep_json['best_threshold']} (F1 {sweep_json['best_f1']:.4f})")
    gpu_models = pipelines.load_models(paths, EvalConfig(), "cuda", "{path}")
    cache = pipelines.DeviceCache.from_dataset(ds, "cuda")
    bs = EvalConfig().batch_size
    probs = pipelines.ensemble_probs(
        gpu_models, cache.img1[:bs].permute(0, 2, 3, 1),
        cache.img2[:bs].permute(0, 2, 3, 1), "bfloat16").contiguous()
    kernel = confusion_counts_sweep(probs, cache.labels[:bs], grid)
    plain = torch.stack([cc.confusion_counts_batch_reference(
        probs, cache.labels[:bs], float(t)) for t in grid])
    if not torch.equal(kernel, plain):
        raise AssertionError("sweep counts: kernel and plain version differ "
                             "on the card")
    # Card fp32 vs CPU fp32: each threshold's counts may differ only by
    # pixels whose probability lies within the devices' largest probability
    # difference of it.
    cfg32 = EvalConfig(compute_dtype="float32", threshold_sweep=True)
    gpu32 = pipelines.evaluate_cached(
        pipelines.ensemble_fn(gpu_models, cfg32.compute_dtype), cache,
        ds.cities, cfg32, keep_probs=len(ds))
    cpu_models = pipelines.load_models(paths, EvalConfig(),
                                       torch.device("cpu"), "{path}")
    cpu32 = pipelines.evaluate_cached(
        pipelines.ensemble_fn(cpu_models, cfg32.compute_dtype),
        pipelines.DeviceCache.from_dataset(ds, "cpu"),
        ds.cities, cfg32, keep_probs=len(ds))
    gpu_p, cpu_p = np.stack(gpu32["probs"]), np.stack(cpu32["probs"])
    dprob = float(np.abs(gpu_p - cpu_p).max())
    near = np.stack([(np.abs(cpu_p - np.float32(t)) <= dprob).sum(
        axis=(1, 2)) for t in grid])
    dcounts = np.abs(gpu32["sweep_counts"] - cpu32["sweep_counts"]).max(
        axis=2)
    print(f"sweep fp32 card vs CPU: max |dprob| = {dprob}, max |dcount| "
          f"{int(dcounts.max())}, pixels near a threshold "
          f"{int(near.sum())}")
    if dprob > MODEL_PROB_TOL or (dcounts > near).any():
        raise AssertionError("sweep on the card disagrees with the CPU")

    pass_times(torch, pipelines, gpu_models, cache, ds.cities)

    # (b) Post-processing, 2 panels.
    panel_dir = os.path.join(root, "panels")
    result, text, out["post_process"], _ = counted_eval(
        torch, cc, ["--root-dir", root, "--checkpoint-path", paths[0],
                    "--post-process", "--post-process-kernel", "4",
                    "--num-visualizations", "2", "--output-dir", panel_dir],
        "post-process")
    if out["post_process"] != (batches, batches):
        raise AssertionError(f"post-process: (calls, launches) "
                             f"{out['post_process']}, expected "
                             f"{(batches, batches)}")
    panels = sorted(n for n in os.listdir(panel_dir)
                    if n.startswith("validation_sample_"))
    if skip_message(2) not in text and panels != sorted(
            f"validation_sample_{ds.cities[i]}_{i}.png" for i in range(2)):
        raise AssertionError(f"no panels and no skip line: {panels}")
    probs = pipelines.ensemble_probs(
        gpu_models[:1], cache.img1.permute(0, 2, 3, 1),
        cache.img2.permute(0, 2, 3, 1), "bfloat16").contiguous()
    # The run's kernel, and smaller ones and each operation on its own,
    # which leave more of these noisy maps' change pixels.
    kept = {}
    hard = (probs > 0.5).float()
    for k in (4, 3, 2):
        for name, fn, x in (("postprocess", morphology.postprocess_prediction,
                             probs), ("dilate", morphology.dilate, hard),
                            ("erode", morphology.erode, hard)):
            card = fn(x, kernel_size=k).cpu()
            if not torch.equal(card, fn(x.cpu(), kernel_size=k)):
                raise AssertionError(f"{name} k={k}: card and CPU differ")
            kept[f"{name} k={k}"] = int(card.sum())
    print(f"post-process: card == CPU on {len(ds)} maps, change pixels "
          f"{kept}; panels {panels or 'skipped'}")

    # (c) Single pair: one city's non-square native PNGs, bicubic to
    # 128x128, fp32, card then CPU.
    city = next(c for c in CITIES if len(set(decode_shape(root, c))) == 2)
    pair = os.path.join(root, SUBDIR, "images",
                        "Onera Satellite Change Detection dataset - Images",
                        city, "pair")
    label = os.path.join(root, SUBDIR, "train_labels",
                         "Onera Satellite Change Detection dataset - Train "
                         "Labels", city, "cm", "cm.png")
    argv = ["--root-dir", root, "--checkpoint-path", paths[0],
            "--image1-path", os.path.join(pair, "img1.png"),
            "--image2-path", os.path.join(pair, "img2.png"),
            "--city-name", city, "--label-path", label,
            "--compute-dtype", "float32"]
    card, _, out["single_pair"], _ = counted_eval(torch, cc, argv,
                                                  "single pair")
    if out["single_pair"] != (1, 1):
        raise AssertionError(f"single pair: (calls, launches) "
                             f"{out['single_pair']}, expected (1, 1)")
    cpu, _ = run_captured(evaluate.main, argv + ["--device", "cpu"])
    dprob = float(np.abs(card["pred"] - cpu["pred"]).max())
    near = int((np.abs(cpu["pred"] - 0.5) <= dprob).sum())
    # The metrics equal the CPU's where no pixel can flip; else the counts
    # differ by at most the pixels that can.
    target = torch.from_numpy(resize_nearest(decode_gray(label),
                                             (128, 128)) / 255.0).float()
    dcount = float((cc.confusion_counts_batch_reference(
        torch.from_numpy(card["pred"]), target[None])
        - cc.confusion_counts_batch_reference(
            torch.from_numpy(cpu["pred"]), target[None])).abs().max())
    same = card["metrics"] == cpu["metrics"]
    print(f"single pair {city} {decode_shape(root, city)} fp32 card vs CPU: "
          f"max |dprob| = {dprob} (limit {SINGLE_PAIR_TOL}), pixels near 0.5 "
          f"{near}, max |dcount| {dcount}, metrics equal {same}: "
          f"{card['metrics']}")
    if (dprob > SINGLE_PAIR_TOL or dcount > near
            or not (same or near)):
        raise AssertionError("single pair on the card disagrees with the CPU")
    # Last: a profiler session slows this process's later launch-bound
    # passes (PERF.md §7).
    device_breakdown(
        torch, lambda: pipelines.evaluate_cached(
            pipelines.ensemble_fn(gpu_models[:1], EvalConfig().compute_dtype),
            cache, ds.cities, EvalConfig(threshold_sweep=True)),
        "one bs-2 evaluation pass with the sweep (14 pairs, bf16)",
        ("confusion_counts",))
    return out


def pass_times(torch, pipelines, models, cache, cities):
    """Median and range of PASSES timed bs-2 bf16 evaluation passes over
    the 14 pairs, after one warm-up, for one model and the two-model
    ensemble, each plain, with the sweep and with post-processing."""
    from gan_aug_pfa_torch.config import EvalConfig

    for label, ms, kw in (
            ("one model", models[:1], {}),
            ("one model + sweep", models[:1], {"threshold_sweep": True}),
            ("one model + post-process k=4", models[:1],
             {"post_process": True, "post_process_kernel": 4}),
            ("ensemble of 2", models, {}),
            ("ensemble of 2 + sweep", models, {"threshold_sweep": True})):
        cfg = EvalConfig(**kw)
        probs_fn = pipelines.ensemble_fn(ms, cfg.compute_dtype)
        pipelines.evaluate_cached(probs_fn, cache, cities, cfg)
        times = []
        for _ in range(PASSES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipelines.evaluate_cached(probs_fn, cache, cities, cfg)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        print(f"eval pass ({label}, bs 2, bf16, {len(cache)} pairs): median "
              f"{float(np.median(times)):.2f} ms over {PASSES} passes, range "
              f"[{min(times):.2f}, {max(times):.2f}]")


def decode_shape(root, city):
    """(H, W) of a city's img1.png, read from its PNG header."""
    path = os.path.join(root, SUBDIR, "images",
                        "Onera Satellite Change Detection dataset - Images",
                        city, "pair", "img1.png")
    with open(path, "rb") as f:
        head = f.read(24)
    w, h = struct.unpack(">II", head[16:24])
    return (h, w)


def device_breakdown(torch, fn, label, ours, top=8):
    """Trace ``fn`` with torch.profiler: wall time, summed device kernel
    time (busy share) and the kernels that take the most device time, with
    the port's kernels (names containing one of ``ours``) always shown.
    Returns the device kernel time (us) and the profiler's kernel rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device-side copies of user annotations (Optimizer.step) are ranges,
    # not kernels.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"profile of {label}: wall {wall_us:.0f} us, device kernels "
          f"{busy_us:.0f} us ({100 * busy_us / wall_us:.1f}% busy), "
          f"{sum(e.count for e in kernels)} kernel launches")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    mine = [e for e in ranked if any(name in e.key for name in ours)]
    for e in ranked[:top] + [e for e in mine if e not in ranked[:top]]:
        print(f"  {e.self_device_time_total:9.1f} us  {e.count:4d}x  "
              f"{e.key[:100]}")
    return busy_us, kernels


TUNE_TRIALS = 6  # past the pruner's 5 startup trials
TUNE_MEMORY_SLACK = 64 << 20  # bytes a trial may leave behind; one
# leaked trial holds about 494 MB (41.2M parameters, two Adam moments)
TUNE_GAMMAS = (1.0, 3.0)  # the search space's gamma edges
TUNE_BATCH_SIZES = (2, 4, 8)  # the search space's batch sizes
GAN_FIXTURE = os.path.join(REPO, "tests", "data", "jax_gan_state_nd5_ngf4")
GAN_FIXTURE_ARGS = ["--num-downs", "5", "--ngf", "4", "--ndf", "8",
                    "--n-layers", "2", "--target-size", "32x32"]
GAN_RESUME_RTOL = 1e-5  # one fp32 D+G step, card (TF32 off) vs JAX (CPU)


def tuning_expected_counts(trials, n_train, n_val):
    """Kernel (calls, launches) a study's trials imply: per epoch a trial
    ran (its reports), ceil(n_train / batch) train steps of two native
    photometric calls, one loss forward and one backward, and ceil(n_val /
    batch) validation forwards; one launch a call."""
    native = fwd = bwd = 0
    for t in trials:
        bs, epochs = t.params["batch_size"], len(t.intermediate_values)
        steps = -(-n_train // bs)
        native += 2 * steps * epochs
        fwd += (steps + -(-n_val // bs)) * epochs
        bwd += steps * epochs
    return ({"native": (native, native), "flip": (0, 0)},
            {"fwd": (fwd, fwd), "bwd": (bwd, bwd)})


def phase_tuning(torch, root):
    """Phase 14a: ``python -m gan_aug_pfa_torch.train --tune --n-trials
    6`` at its defaults (128x128, native augmentation, bf16, 15 epochs a
    trial) over a 14-city tree, in this process from a fresh working
    directory, with the FocalDice, photometric and confusion (calls,
    launches) set to 0 just before and read just after (the confusion
    counts must stay (0, 0)); the study file, the report of
    ``show_optuna_results`` and the memory left allocated after each
    trial."""
    from gan_aug_pfa_torch import show_optuna_results, tune
    from gan_aug_pfa_torch.data.scanner import create_sample_lists
    from gan_aug_pfa_torch.ops.kernels import confusion_counts as cc
    from gan_aug_pfa_torch.ops.kernels import photometric as ph
    from gan_aug_pfa_torch.ops.kernels.fused_loss import FocalDiceLossFn
    from gan_aug_pfa_torch.train import __main__ as train_cli
    from gan_aug_pfa_torch.tuning import TrialState, load_study

    write_oscd_tree(root)
    work = os.path.join(root, "work")
    os.makedirs(work)
    seconds, memory = [], []
    make_objective = tune.make_objective

    def measured(*args, **kwargs):
        objective = make_objective(*args, **kwargs)

        def timed(trial):
            t0 = time.perf_counter()
            try:
                return objective(trial)
            finally:
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                memory.append(torch.cuda.memory_allocated())
        return timed

    cwd = os.getcwd()
    tune.make_objective = measured
    confusion = cc.confusion_counts_batch
    os.chdir(work)
    try:
        reset_photometric_counts(ph)
        reset_loss_counts(FocalDiceLossFn)
        confusion.calls = confusion.launches = 0
        t0 = time.time()
        run_captured(train_cli.main, ["--root-dir", root, "--tune",
                                      "--n-trials", str(TUNE_TRIALS)])
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = photometric_counts(ph)
        loss = loss_counts(FocalDiceLossFn)
        counts["confusion"] = (confusion.calls, confusion.launches)
        _, report = run_captured(show_optuna_results.main, [])
    finally:
        os.chdir(cwd)
        tune.make_objective = make_objective
    study = load_study(tune.STUDY_NAME, "sqlite:///" + os.path.join(
        work, "optuna_study.db"))
    trials = study.trials
    n = {mode: len(create_sample_lists(root, SUBDIR, mode=mode,
                                       verbose=False))
         for mode in ("train", "val")}
    want_counts, want_loss = tuning_expected_counts(trials, n["train"],
                                                    n["val"])
    # Tuning reports only the validation loss: no confusion counts.
    want_counts["confusion"] = (0, 0)
    states = [t.state for t in trials]
    completed = [t.value for t in trials if t.state == TrialState.COMPLETE]
    drift = [m - memory[0] for m in memory]
    print(f"tuning: {len(trials)} trials {[s.value for s in states]}, "
          f"epochs {[len(t.intermediate_values) for t in trials]}, batch "
          f"sizes {[t.params['batch_size'] for t in trials]}; study wall "
          f"{wall:.2f} s; per-trial seconds median "
          f"{float(np.median(seconds)):.3f} (range {min(seconds):.3f}-"
          f"{max(seconds):.3f}); photometric and confusion (calls, "
          f"launches) {counts} (expected {want_counts}), fused loss {loss} "
          f"(expected "
          f"{want_loss}); allocated after each trial {memory} bytes, "
          f"drift from trial 1 {drift}")
    if (len(trials) != TUNE_TRIALS
            or not set(states) <= {TrialState.COMPLETE, TrialState.PRUNED}
            or not completed
            or study.best_trial.value != min(completed)):
        raise AssertionError(f"tuning study: states {states}")
    if counts != want_counts or loss != want_loss:
        raise AssertionError("tuning kernel counts differ from the trials'")
    if f"Number of trials: {TUNE_TRIALS}" not in report:
        raise AssertionError("show_optuna_results does not report the "
                             "study")
    if len(memory) != TUNE_TRIALS or max(map(abs, drift)) > \
            TUNE_MEMORY_SLACK:
        raise AssertionError(f"memory left after the trials: {drift}")
    return {"trials": trials, "counts": counts, "loss": loss,
            "wall": wall, "seconds": seconds, "memory": memory,
            "n_train": n["train"], "n_val": n["val"]}


def batch_sizes(n, bs):
    """The batch sizes of one pass over ``n`` samples in batches of
    ``bs``: full batches and the tail."""
    return {b for b in (min(bs, n), n % bs) if b}


def phase_tuning_kernels(torch, fl, ph, tuning, native_ds):
    """Phase 14b: the kernels of the tuning path against their plain
    versions at every batch the path can give them: each batch size of the
    search space over the tuning tree's train and validation sets, full
    batches and tails.  The fused FocalDice forward and backward on
    (B, 1, 128, 128) bf16 logits at each trial's (alpha, gamma, beta,
    smooth) and at the search space's gamma edges, with phase 3's
    tolerances; ``photometric_native_chw`` on the tree's padded native
    (B, 3, H, W) with the train set's mixed extents, as phase 5 checks it.
    Returns the largest |dloss|, max|ddx| and photometric error."""
    trials = tuning["trials"]
    if not {t.params["batch_size"] for t in trials} <= set(TUNE_BATCH_SIZES):
        raise AssertionError("a trial's batch size is outside the checked "
                             "ones")
    train_b = sorted({b for bs in TUNE_BATCH_SIZES
                      for b in batch_sizes(tuning["n_train"], bs)})
    loss_b = sorted(set(train_b) | {b for bs in TUNE_BATCH_SIZES
                                    for b in batch_sizes(tuning["n_val"],
                                                         bs)})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 14)
    g = torch.tensor(0.73, device="cuda")
    cases = [(trial.params["focal_alpha"], trial.params["focal_gamma"],
              trial.params["loss_beta"], trial.params["dice_smooth"])
             for trial in trials]
    cases += [(cases[0][0], gamma, cases[0][2], cases[0][3])
              for gamma in TUNE_GAMMAS]
    worst = [0.0, 0.0, 0.0]
    for b in loss_b:
        x, t = loss_inputs(torch, (b, *TRAIN_SHAPE[1:]), gen,
                           dtype="bfloat16")
        xf, tf = x.reshape(-1), t.reshape(-1)
        for alpha, gamma, beta, smooth in cases:
            kw = {"beta": beta, "focal_alpha": alpha, "dice_smooth": smooth}
            loss, sums = fl.launch_forward(xf, tf, beta, gamma, alpha,
                                           smooth)
            dx = fl.launch_backward(xf, tf, sums, g, beta, gamma, alpha,
                                    smooth)
            torch.cuda.synchronize()
            dloss, ddx, excess, tol, ref_loss, ok = loss_errors(
                torch, fl, xf, tf, gamma, loss, dx, g, kw)
            worst[:2] = [max(worst[0], dloss), max(worst[1], ddx)]
            print(f"loss kernels B={b} at alpha={alpha:.4f} "
                  f"gamma={gamma:.4f} beta={beta:.4f} smooth={smooth:.3e}: "
                  f"loss {float(loss):.7f} vs {ref_loss:.7f} (|d| "
                  f"{dloss:.2e}), max|ddx| {ddx:.2e}, beyond a bf16 step "
                  f"{excess:.2e} (tol {tol:.2e}) {'OK' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"fused loss kernels != plain version "
                                     f"at B={b} and a trial's "
                                     f"hyperparameters {kw}, gamma {gamma}")
    sizes = native_ds.sizes.tolist()
    for b in train_b:
        shape = (b, 3, *native_ds.img1.shape[1:3])
        extents = [sizes[(3 * i + b) % len(sizes)] for i in range(b)]
        err, _ = check_photometric(torch, ph, "native", shape, extents, gen)
        worst[2] = max(worst[2], err)
    return worst


def tree_leaves(tree):
    """The leaves of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def phase_gan_resume(torch, root):
    """Phase 14c: the JAX-written GAN resume pair (tests/data, from
    tools/make_gan_resume_fixture.py) through ``python -m
    gan_aug_pfa_torch.train_gan --resume`` for one more epoch; then, in
    this process, the Adam moments it maps (element for element against
    the file's) and one fp32 D+G step on the card (TF32 off) from the
    loaded state against the JAX losses saved beside it."""
    import shutil

    from gan_aug_pfa_torch import checkpoint, interop, train_gan
    from gan_aug_pfa_torch.config import GANTrainConfig
    from gan_aug_pfa_torch.train.gan import GANTrainer

    expected = np.load(GAN_FIXTURE + "_expected.npz")
    epoch = int(expected["epoch"]) + 1
    write_oscd_tree(root)
    ckpt = os.path.join(root, "gan_checkpoints")
    shutil.copytree(GAN_FIXTURE, ckpt)
    t0 = time.time()
    history, text = run_captured(train_gan.main, [
        "--root-dir", root, *GAN_FIXTURE_ARGS, "--resume",
        "--num-epochs", str(epoch)])
    wall = time.time() - t0
    files = {f"{kind}_epoch_{epoch}.pth"
             for kind in ("generator", "discriminator")}
    if (f"Resumed GAN from epoch {epoch}." not in text or history is None
            or len(history["loss_d"]) != 1
            or not files <= set(os.listdir(ckpt))):
        raise AssertionError("the JAX GAN state did not resume through "
                             "train_gan")
    trainer = GANTrainer(GANTrainConfig(
        num_downs=5, ngf=4, ndf=8, n_layers=2, target_size=(32, 32),
        compute_dtype="float32"), "cuda")
    for stem, model, opt in (
            ("last_generator", trainer.generator, trainer.opt_g),
            ("last_discriminator", trainer.discriminator, trainer.opt_d)):
        path = os.path.join(GAN_FIXTURE, stem + ".msgpack")
        checkpoint.restore_gan_state_from_jax(path, model, opt)
        adam = interop.variables_from_msgpack(path)["opt_state"][
            "inner_state"]["1"]
        for key, field in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            # The layout changes where an element sits, not its value.
            want = np.sort(np.concatenate(
                [np.asarray(v, np.float32).ravel()
                 for v in tree_leaves(adam[key])]))
            got = np.sort(torch.cat([opt.state[p][field].reshape(-1)
                                     for p in model.parameters()]
                                    ).cpu().numpy())
            if not (got.shape == want.shape and (got == want).all()):
                raise AssertionError(f"{stem} {key}: the moments on the "
                                     "card differ from the file's")
        steps = {float(opt.state[p]["step"]) for p in model.parameters()}
        if steps != {float(adam["count"])}:
            raise AssertionError(f"{stem}: steps {steps}, count "
                                 f"{adam['count']}")
    a, b = (torch.from_numpy(expected[k]).cuda().permute(0, 3, 1, 2)
            for k in ("a", "b"))
    loss_d, loss_g = (float(v) for v in trainer.train_batch(a, b))
    err = {"loss_d": abs(loss_d / float(expected["loss_d"]) - 1),
           "loss_g": abs(loss_g / float(expected["loss_g"]) - 1)}
    print(f"JAX GAN state on the card: train_gan --resume wall {wall:.2f} "
          f"s; moments equal the file's; one fp32 D+G step loss_D "
          f"{loss_d:.7f} vs JAX {float(expected['loss_d']):.7f}, loss_G "
          f"{loss_g:.7f} vs {float(expected['loss_g']):.7f}, relative "
          f"{err} (limit {GAN_RESUME_RTOL})")
    if max(err.values()) > GAN_RESUME_RTOL:
        raise AssertionError("the resumed GAN step differs from JAX's")
    return err


# Phase 15: serving artifacts.  An fp32 or int8 artifact on the card (TF32
# off) computes what the eager port model computes with the same weights
# (dequantized, for int8) with the same cuDNN calls: both are the same ATen
# ops, and their outputs have agreed within float32 rounding.
SERVE_TOL = 1e-5
SERVE_BATCHES = (1, 4)
SERVE_PASSES = 3  # timed evaluation passes an artifact and batch size
SERVE_REPS = 8  # copies of the 14 pairs in the timed evaluation cache
# A bf16 artifact runs eager bf16 autocast's casts as explicit graph ops;
# its distance from the eager bf16 forward may not exceed the bf16
# rounding that the eager forward itself shows against fp32 (the largest
# |eager bf16 - eager fp32| on the same inputs).
# An int8 artifact's file and its weights in device memory against the
# fp32 artifact's: int8 weights and a float32 scale a channel for every
# large conv weight, so about 0.25x; tests/test_quantize.py:166 bounds it.
SERVE_INT8_RATIO = 0.45

SERVE_CHILD = r"""
import gc, json, sys, time
t0 = time.perf_counter()
sys.modules["gan_aug_pfa_torch.models"] = None  # the model code is gone
import numpy as np
import torch
from gan_aug_pfa_torch import serve
device, batches, jobs = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3:]
t1 = time.perf_counter()
torch.zeros(1, device=device)
torch.cuda.synchronize()
t2 = time.perf_counter()
for path, inputs, outputs in zip(jobs[0::3], jobs[1::3], jobs[2::3]):
    gc.collect()
    before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    header, fn = serve.load_serving_fn(path, aot="never", device=device)
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.perf_counter() - t)
    weights = torch.cuda.memory_allocated() - before
    t = time.perf_counter()
    serve.load_serving_fn(path, aot="never", device=device)  # again
    torch.cuda.synchronize()
    reload_ms = 1e3 * (time.perf_counter() - t)
    d = np.load(inputs)
    xs = [d[k] for k in sorted(d.files)]
    out, ms, peak = {}, {}, {}
    for i, bs in enumerate(batches):
        runs = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(1 if i == 0 else 5):
            t = time.perf_counter()
            y = fn(*[x[:bs] for x in xs])
            torch.cuda.synchronize()
            runs.append(1e3 * (time.perf_counter() - t))
        out[f"b{bs}"] = y.cpu().numpy()
        ms[bs] = runs
        peak[bs] = torch.cuda.max_memory_allocated() - before
    np.savez(outputs, **out)
    print(json.dumps({
        "arch": header["arch"], "compute_dtype": header["compute_dtype"],
        "quantize": header.get("quantize"), "load_ms": load_ms,
        "reload_ms": reload_ms, "weight_bytes": weights, "batch_ms": ms,
        "peak_bytes": peak}))
    del fn, y
print(json.dumps({"import_s": t1 - t0, "context_s": t2 - t1,
                  "model_modules": sorted(
                      m for m, v in sys.modules.items()
                      if v is not None and ".models" in m)}))
"""


def serve_child(jobs, device):
    """Load each artifact of ``jobs`` ((path, inputs) pairs) in turn in one
    fresh process that cannot import the port's model code, serve the
    first 1 and 4 of its inputs, and return (the process's JSON report,
    [(each artifact's report, its outputs by batch)]).  The first load
    pays torch.export's imports."""
    with tempfile.TemporaryDirectory() as tmp:
        argv = []
        for i, (path, inputs) in enumerate(jobs):
            np.savez(os.path.join(tmp, f"in{i}.npz"), *inputs)
            argv += [path, os.path.join(tmp, f"in{i}.npz"),
                     os.path.join(tmp, f"out{i}.npz")]
        proc = subprocess.run(
            [sys.executable, "-c", SERVE_CHILD, device,
             json.dumps(SERVE_BATCHES), *argv],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"serving in a fresh process failed:"
                                 f"\n{proc.stderr[-4000:]}")
        lines = [json.loads(line) for line in
                 proc.stdout.strip().splitlines()[-len(jobs) - 1:]]
        results = []
        for i, report in enumerate(lines[:-1]):
            with np.load(os.path.join(tmp, f"out{i}.npz")) as d:
                results.append((report, {int(k[1:]): d[k] for k in d.files}))
    if lines[-1]["model_modules"]:
        raise AssertionError(f"the serving process imported "
                             f"{lines[-1]['model_modules']}")
    return lines[-1], results


def serving_refs(torch, arch, model, inputs, compute_dtype, device):
    """The eager port model's output on ``inputs``, by the artifact's
    contract."""
    from gan_aug_pfa_torch.device import tf32_off
    from gan_aug_pfa_torch.train.gan import generate
    from gan_aug_pfa_torch.train.siamese import predict_normalized

    xs = [torch.from_numpy(x).to(device) for x in inputs]
    with torch.no_grad():
        if arch == "siamese":
            y = predict_normalized(model, *(x.permute(0, 3, 1, 2) for x in xs),
                                   compute_dtype).permute(0, 2, 3, 1)
        elif arch == "generator":
            y = generate(model, xs[0], compute_dtype)
        else:
            with tf32_off():
                y = model(torch.cat(xs, dim=-1).permute(0, 3, 1, 2))
            y = y.permute(0, 2, 3, 1)
    return y.float().cpu().numpy()


def phase_serving(torch, root, device="cuda", sidecar_job=None):
    """Phase 15: serving artifacts on the card.  ``python -m
    gan_aug_pfa_torch.export_model --backend cuda`` at full width from
    seeded checkpoints: the Siamese net at fp32, bf16 and int8 (128x128),
    the generator at fp32 and int8 and the discriminator at fp32
    (256x256).  Each artifact loads in a fresh process with the model code
    blocked and serves batches 1 and 4, held against the eager port model
    (fp32 and int8: within 1e-5 of the eager model with the same,
    dequantized, weights; bf16: within the eager bf16 forward's own
    distance from fp32); then ``evaluate --serving-artifact`` (confusion
    counts (7, 7), the checkpoint path's counts at fp32 within the phase-5
    rule), ``generate_synthetic --serving-artifact`` (img2 within 1 LSB of
    the checkpoint path on at most 0.5% of pixels), then the executable
    sidecar (``phase_serving_sidecar``).  Prints export seconds, load ms
    and first batch latency in a fresh process, evaluation pairs/s at bs 2
    and 16 through each artifact against the checkpoint path, and the fp32
    and int8 artifacts' file and device bytes."""
    from gan_aug_pfa_torch import evaluate, pipelines
    from gan_aug_pfa_torch import generate_synthetic as synth_cli
    from gan_aug_pfa_torch import quantize as qz
    from gan_aug_pfa_torch import serve
    from gan_aug_pfa_torch.config import EvalConfig
    from gan_aug_pfa_torch.data import png
    from gan_aug_pfa_torch.data.loader import build_cached_dataset
    from gan_aug_pfa_torch.data.scanner import create_sample_lists
    from gan_aug_pfa_torch.ops.kernels import confusion_counts as cc

    # Every artifact comes from start_sidecar_export's children, started
    # early when the caller gave the job.
    job = sidecar_job or start_sidecar_export(torch, root, device)
    walls, children = finish_sidecar_export(job)
    models = serving_models(torch)
    pths, arts = serving_paths(root)
    export_s = children["exports"]["export_s"]
    for (arch, dtype, quant), path in arts.items():
        took = (f"in {export_s[path]:.2f} s" if path in export_s else
                "and compiled its sidecar, done within "
                f"{walls['float32' if quant is None else 'int8']:.2f} s of "
                "the children's start")
        print(f"serving: exported {arch} {quant or dtype} in a child "
              f"process {took} ({os.path.getsize(path)} bytes)")

    # The artifacts in one fresh process, each against the eager model.
    rng = np.random.RandomState(SEED + 15)
    reports, jobs = {}, []
    for arch, dtype, quant in arts:
        size = 128 if arch == "siamese" else 256
        lo = 0.0 if arch == "generator" else -1.0
        jobs.append([(rng.rand(max(SERVE_BATCHES), size, size, 3) * (1 - lo)
                      + lo).astype(np.float32)
                     for _ in range(1 if arch == "generator" else 2)])
    process, results = serve_child(list(zip(arts.values(), jobs)), device)
    print(f"serving: one fresh process for the {len(arts)} artifacts: "
          f"import {process['import_s']:.2f} s, CUDA context "
          f"{process['context_s']:.2f} s (the first load pays "
          "torch.export's imports)")
    for (key, path), inputs, (report, outputs) in zip(arts.items(), jobs,
                                                      results):
        arch, dtype, quant = key
        reports[key] = report
        model = models[arch].to(device)
        if quant:
            qtree, _ = qz.quantize_tree(model.state_dict(),
                                        out_axes=qz.out_channel_axes(model))
            model = type(model)()
            model.load_state_dict(qz.dequantize_tree(qtree), strict=True)
            model = model.to(device).eval()
        # At each batch size, as convolution algorithms are chosen by shape.
        want = {bs: serving_refs(torch, arch, model, [x[:bs] for x in inputs],
                                 dtype, device) for bs in SERVE_BATCHES}
        errs = {bs: float(np.abs(outputs[bs] - want[bs]).max())
                for bs in SERVE_BATCHES}
        if dtype == "float32":
            limit = SERVE_TOL
        else:
            limit = max(float(np.abs(
                want[bs] - serving_refs(torch, arch, model,
                                        [x[:bs] for x in inputs], "float32",
                                        device)).max())
                for bs in SERVE_BATCHES)
        ms = report["batch_ms"]
        print(f"serving: {arch} {quant or dtype}: load "
              f"{report['load_ms']:.1f} ms (a second load {report['reload_ms']:.1f} ms), weights on "
              f"the device {report['weight_bytes']} bytes; "
              f"first batch (bs 1) {ms['1'][0]:.2f} ms, bs 4 median "
              f"{float(np.median(ms['4'])):.2f} ms; peak "
              f"{report['peak_bytes']} bytes; max |artifact - eager| by "
              f"batch {errs} (limit {limit})")
        if max(errs.values()) > limit or not all(
                np.isfinite(o).all() for o in outputs.values()):
            raise AssertionError(f"{path}: the artifact disagrees with the "
                                 "eager model")
        if dtype == "bfloat16":
            # It computes in bf16, not silently in fp32.
            _, program = serve.load_artifact(path, device=device)
            convs = {str(n.meta["val"].dtype) for n in program.graph.nodes
                     if n.target == torch.ops.aten.convolution.default}
            print(f"serving: {arch} bf16 artifact's convolution dtypes "
                  f"{sorted(convs)}")
            if convs != {"torch.bfloat16"} or limit == 0.0:
                raise AssertionError("the bf16 artifact does not compute in "
                                     "bf16")
    for arch in ("siamese", "generator"):
        fp = arts[(arch, "float32", None)]
        q8 = arts[(arch, "float32", "int8")]
        file_ratio = os.path.getsize(q8) / os.path.getsize(fp)
        dev_ratio = (reports[(arch, "float32", "int8")]["weight_bytes"]
                     / reports[(arch, "float32", None)]["weight_bytes"])
        print(f"serving: {arch} int8 vs fp32: file {os.path.getsize(q8)} vs "
              f"{os.path.getsize(fp)} bytes ({file_ratio:.4f}x), device "
              f"weights {dev_ratio:.4f}x (limit {SERVE_INT8_RATIO}x)")
        if max(file_ratio, dev_ratio) > SERVE_INT8_RATIO:
            raise AssertionError(f"the int8 {arch} artifact is not smaller")

    # The evaluation CLI through the fp32 artifact, against the checkpoint
    # path at fp32.
    fn = cc.confusion_counts_batch
    siamese_fp32 = arts[("siamese", "float32", None)]
    fn.calls = fn.launches = 0
    t0 = time.time()
    art_result, _ = run_captured(evaluate.main, [
        "--root-dir", root, "--serving-artifact", siamese_fp32,
        "--serving-aot", "never", "--device", device, "--json-out",
        os.path.join(root, "artifact.json")])
    counts = (fn.calls, fn.launches)
    print(f"serving: evaluate --serving-artifact wall {time.time() - t0:.2f} "
          f"s, confusion counts (calls, launches) {counts}")
    if art_result is None or counts != (7, 7):
        raise AssertionError(f"evaluate --serving-artifact: (calls, "
                             f"launches) {counts}, expected (7, 7)")
    check_report(art_result, os.path.join(root, "artifact.json"))
    with open(os.path.join(root, "artifact.json")) as f:
        if json.load(f)["checkpoints"] != [siamese_fp32]:
            raise AssertionError("the report does not name the artifact")
    ckpt_result, _ = run_captured(evaluate.main, [
        "--root-dir", root, "--checkpoint-path", pths["siamese"],
        "--compute-dtype", "float32", "--device", device])
    ds = build_cached_dataset(
        create_sample_lists(root, SUBDIR, mode="all", verbose=False),
        (128, 128), verbose=False)
    cache = pipelines.DeviceCache.from_dataset(ds, device)
    _, serve_fn = serve.load_serving_fn(siamese_fp32, aot="never",
                                        device=device)
    probs = {"artifact": pipelines.artifact_fn(serve_fn),
             "checkpoint": pipelines.ensemble_fn([models["siamese"]],
                                                 "float32")}
    p = {k: f(cache.img1.permute(0, 2, 3, 1),
              cache.img2.permute(0, 2, 3, 1)).cpu()
         for k, f in probs.items()}
    dprob = float((p["artifact"] - p["checkpoint"]).abs().max())
    near = ((p["checkpoint"] - 0.5).abs() <= dprob).sum(dim=(1, 2)).numpy()
    dcounts = np.abs(art_result["counts"] - ckpt_result["counts"]).max(axis=1)
    print(f"serving: evaluation artifact vs checkpoint (fp32): max |dprob| = "
          f"{dprob}, max |dcount| per sample {dcounts.tolist()}, "
          f"near-threshold pixels {near.tolist()}")
    if dprob > SERVE_TOL or (dcounts > near).any():
        raise AssertionError("evaluation through the artifact disagrees with "
                             "the checkpoint path")

    # Evaluation pairs/s through each Siamese artifact against the
    # checkpoint path in the same dtype.
    big = pipelines.DeviceCache(cache.img1.repeat(SERVE_REPS, 1, 1, 1),
                                cache.img2.repeat(SERVE_REPS, 1, 1, 1),
                                cache.labels.repeat(SERVE_REPS, 1, 1))
    cities = ds.cities * SERVE_REPS
    paths = {"checkpoint fp32": probs["checkpoint"],
             "artifact fp32": probs["artifact"],
             "checkpoint bf16": pipelines.ensemble_fn([models["siamese"]],
                                                      "bfloat16")}
    for name, key in (("artifact bf16", ("siamese", "bfloat16", None)),
                      ("artifact int8", ("siamese", "float32", "int8"))):
        paths[name] = pipelines.artifact_fn(
            serve.load_serving_fn(arts[key], aot="never", device=device)[1])
    for bs in (2, 16):
        cfg = EvalConfig(batch_size=bs)
        for name, probs_fn in paths.items():
            pipelines.evaluate_cached(probs_fn, big, cities, cfg)
            rates = []
            for _ in range(SERVE_PASSES):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pipelines.evaluate_cached(probs_fn, big, cities, cfg)
                torch.cuda.synchronize()
                rates.append(len(big) / (time.perf_counter() - t0))
            print(f"serving: eval throughput ({name}, 128x128, {len(big)} "
                  f"pairs, bs {bs}): median {float(np.median(rates)):.1f} "
                  f"pairs/s over {SERVE_PASSES} passes, range "
                  f"[{min(rates):.1f}, {max(rates):.1f}]")
    del big, paths

    # Synthesis through the fp32 generator artifact against the checkpoint.
    out = {k: os.path.join(root, f"synth_{k}")
           for k in ("artifact", "checkpoint")}
    t0 = time.time()
    n_art, _ = run_captured(synth_cli.main, [
        "--root-dir", root, "--device", device, "--synthetic-data-dir",
        out["artifact"], "--serving-artifact",
        arts[("generator", "float32", None)]])
    wall = time.time() - t0
    n_ckpt, _ = run_captured(synth_cli.main, [
        "--root-dir", root, "--device", device, "--synthetic-data-dir",
        out["checkpoint"], "--generator-checkpoint-name",
        "generator_epoch_1.pth"])
    if n_art != len(CITIES) or n_ckpt != len(CITIES):
        raise AssertionError(f"synthesis wrote {n_art} and {n_ckpt} samples")
    diffs = []
    for i, city in enumerate(CITIES):
        for kind, name in (("images", f"img1_synth_{i}.png"),
                           ("images", f"img2_synth_{i}.png"),
                           ("labels", f"cm_synth_{i}.png")):
            a, b = (png.decode_rgb(os.path.join(out[k], kind, city, name))
                    if kind == "images" else
                    png.decode_gray(os.path.join(out[k], kind, city, name))
                    for k in ("artifact", "checkpoint"))
            if name.startswith("img2"):
                diffs.append(np.abs(a.astype(int) - b).ravel())
            elif not np.array_equal(a, b):
                raise AssertionError(f"synthesis {city}/{name} differs")
    diffs = np.concatenate(diffs)
    share = float((diffs > 0).mean())
    print(f"serving: generate_synthetic --serving-artifact {n_art} triples "
          f"in {wall:.2f} s; img2 vs the checkpoint path max {diffs.max()} "
          f"LSB on {100 * share:.4f}% of pixels (limit 1 LSB on "
          f"{100 * SYNTH_LSB_SHARE}%)")
    if diffs.max() > 1 or share > SYNTH_LSB_SHARE:
        raise AssertionError("synthesis through the artifact disagrees")

    first = reports[("siamese", "float32", None)]
    pt2_cold = (process["import_s"] + process["context_s"],
                (first["load_ms"] + first["batch_ms"]["1"][0]) / 1e3)
    sidecar = phase_serving_sidecar(
        torch, root, siamese_fp32, arts[("siamese", "float32", "int8")],
        arts[("discriminator", "float32", None)], children, cache,
        ds.cities, pt2_cold, device)
    return {"confusion_counts": counts, **sidecar}


# Phase 15, the executable sidecar: AOTInductor packages of the fp32
# Siamese artifact.  A package runs Inductor's kernels (fused elementwise
# work, its own choice of convolution calls) where the .pt2 runs ATen's op
# by op, so the two agree within float32 rounding, TF32 off in both.
AOT_TOL = 1e-5  # max |package - .pt2| on probabilities at batch 2
AOT_BATCH = 2  # the evaluation CLI's default batch
AOT_RECOMPILE_BATCH = 4
AOT_EXPORT_TIMEOUT_S = 900.0

# The evaluation CLI in a fresh process, timed from its start to its first
# batch served and from the artifact's load to it (the artifact's function
# is wrapped to wait for that batch).
AOT_EVAL_CHILD = r"""
import json, sys, time
t0 = time.perf_counter()
from gan_aug_pfa_torch import evaluate, serve
from gan_aug_pfa_torch.ops.kernels import confusion_counts as cc
fn = cc.confusion_counts_batch
fn.calls = fn.launches = 0
t = {"imports": time.perf_counter()}
load = serve.load_serving_fn


def timed_load(*args, **kwargs):
    t["load"] = time.perf_counter()
    header, serve_fn = load(*args, **kwargs)

    def first(*xs):
        y = serve_fn(*xs)
        if "first" not in t:
            y.sum().item()
            t["first"] = time.perf_counter()
        return y

    return header, first


serve.load_serving_fn = timed_load
result = evaluate.main(sys.argv[1:])
print(json.dumps({"counts": [fn.calls, fn.launches],
                  "ok": result is not None, "import_s": t["imports"] - t0,
                  "to_first_batch_s": t["first"] - t0,
                  "load_to_first_batch_s": t["first"] - t["load"],
                  "wall_s": time.perf_counter() - t0}))
"""


SERVE_CASES = [("siamese", "float32", None), ("siamese", "bfloat16", None),
               ("siamese", "float32", "int8"), ("generator", "float32", None),
               ("generator", "float32", "int8"),
               ("discriminator", "float32", None)]
SERVE_STEMS = {"siamese": "siamese_checkpoints/best_model",
               "generator": "gan_checkpoints/generator_epoch_1",
               "discriminator": "gan_checkpoints/discriminator_epoch_1"}

# Phase 15's exports, in child processes beside phases 18-21.  The int8
# Siamese artifact's child also holds its package against its .pt2 at
# AOT_BATCH on seeded inputs; the third child exports the other artifacts
# and compiles the discriminator's at AOT_RECOMPILE_BATCH beside a stale
# batch-AOT_BATCH package, which the compile must remove.  Each prints a
# JSON line last.
INT8_SIDECAR_CHILD = r"""
import json, sys, torch
from gan_aug_pfa_torch import export_model, serve
pth, artifact, device, bs, seed = sys.argv[1:6]
bs = int(bs)
export_model.main(["--checkpoint-path", pth, "--output", artifact,
                   "--backend", device, "--quantize", "int8",
                   "--aot-batch-sizes", str(bs)])
gen = torch.Generator().manual_seed(int(seed))
xs = [torch.rand((bs, 128, 128, 3), generator=gen) * 2 - 1 for _ in range(2)]
_, package = serve.load_serving_fn(artifact, aot="require", device=device)
_, program = serve.load_serving_fn(artifact, aot="never", device=device)
print(json.dumps({"max_abs_err": float(
    (package(*xs) - program(*xs)).abs().max())}))
"""
EXPORTS_CHILD = r"""
import json, os, sys, time
from gan_aug_pfa_torch import export_model, serve
device, jobs, disc, bs, recompile_bs = sys.argv[1:6]
seconds = {}
for out, argv in json.loads(jobs):
    t = time.perf_counter()
    export_model.main(argv + ["--output", out, "--backend", device])
    seconds[out] = time.perf_counter() - t
with open(f"{disc}.aotc.bs{bs}.pt2", "wb") as f:
    f.write(b"a stale package")
t = time.perf_counter()
serve._main([disc, recompile_bs, "--device", device])
name = os.path.basename(disc)
print(json.dumps({"export_s": seconds,
                  "recompile_s": time.perf_counter() - t,
                  "left": sorted(f for f in os.listdir(os.path.dirname(disc))
                                 if f.startswith(name + ".aotc"))}))
"""


def serving_models(torch):
    """Phase 15's seeded full-width models, equal on every call."""
    from gan_aug_pfa_torch.models import (
        NLayerDiscriminator,
        SiameseUNet,
        UNetGenerator,
    )

    with torch.random.fork_rng(devices=[]):
        return {"siamese": seeded_model(torch, SiameseUNet),
                "generator": UNetGenerator().eval(),
                "discriminator": NLayerDiscriminator().eval()}


def serving_paths(root):
    """Phase 15's checkpoints ({arch: path}) and artifacts ({case:
    path})."""
    pths = {arch: os.path.join(root, stem + ".pth")
            for arch, stem in SERVE_STEMS.items()}
    arts = {case: os.path.join(root, "artifacts",
                               f"{case[0]}_{case[2] or case[1]}.pt2")
            for case in SERVE_CASES}
    return pths, arts


def start_sidecar_export(torch, root, device="cuda"):
    """Phase 15's exports, which may start early: the phase's tree and
    seeded checkpoints, then three child processes started together
    (output to files in ``root``): ``python -m
    gan_aug_pfa_torch.export_model --aot-batch-sizes 2`` on the fp32
    Siamese artifact; the same with ``--quantize int8``, then that
    package against its ``.pt2`` (INT8_SIDECAR_CHILD); and the other
    artifacts with the discriminator's recompile (EXPORTS_CHILD).
    Returns the job."""
    from gan_aug_pfa_torch import checkpoint

    write_oscd_tree(root)
    pths, arts = serving_paths(root)
    for arch, model in serving_models(torch).items():
        checkpoint.save_model(pths[arch], model)
    siamese = pths["siamese"]
    others = [(arts[case], ["--checkpoint-path", pths[case[0]],
                            "--compute-dtype", case[1]]
               + (["--quantize", case[2]] if case[2] else []))
              for case in SERVE_CASES[1:] if case != SERVE_CASES[2]]
    commands = {
        "float32": ["-m", "gan_aug_pfa_torch.export_model",
                    "--checkpoint-path", siamese, "--output",
                    arts[SERVE_CASES[0]], "--backend", device,
                    "--aot-batch-sizes", str(AOT_BATCH)],
        "int8": ["-c", INT8_SIDECAR_CHILD, siamese, arts[SERVE_CASES[2]],
                 device, str(AOT_BATCH), str(SEED + 16)],
        "exports": ["-c", EXPORTS_CHILD, device, json.dumps(others),
                    arts[SERVE_CASES[5]], str(AOT_BATCH),
                    str(AOT_RECOMPILE_BATCH)]}
    children = {}
    for name, args in commands.items():
        log = os.path.join(root, f"sidecar_export_{name}.log")
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-u", *args], cwd=REPO, stdout=out,
                stderr=subprocess.STDOUT, text=True)
        children[name] = {"proc": proc, "log": log}
    return {"children": children, "t0": time.perf_counter()}


def finish_sidecar_export(job):
    """Wait for ``start_sidecar_export``'s children (killed
    ``AOT_EXPORT_TIMEOUT_S`` after their start), echo their output and
    return ({child: its wall seconds from the start, at most}, {child: the
    JSON of its last line, or None}); raises if one failed."""
    walls, results = {}, {}
    for name, child in job["children"].items():
        proc = child["proc"]
        try:
            rc = proc.wait(timeout=max(1.0, AOT_EXPORT_TIMEOUT_S - (
                time.perf_counter() - job["t0"])))
        except subprocess.TimeoutExpired:
            stop_sidecar_export(job)
            raise AssertionError(f"phase 15's {name} child still running "
                                 f"after {AOT_EXPORT_TIMEOUT_S} s")
        walls[name] = time.perf_counter() - job["t0"]
        with open(child["log"]) as f:
            lines = f.read().splitlines()
        for line in lines:
            print(f"  {name} | {line}")
        if rc != 0:
            raise AssertionError(f"phase 15's {name} child exited {rc}")
        reports = [line for line in lines if line.startswith("{")]
        results[name] = json.loads(reports[-1]) if reports else None
    return walls, results


def stop_sidecar_export(job):
    """Kill ``start_sidecar_export``'s children that still run."""
    for child in job["children"].values():
        if child["proc"].poll() is None:
            child["proc"].kill()
            child["proc"].wait()


def phase_serving_sidecar(torch, root, artifact, int8_artifact,
                          disc_artifact, results, cache, cities, pt2_cold,
                          device="cuda"):
    """Phase 15's executable sidecar of the full-width fp32 Siamese
    artifact, which ``export_model --aot-batch-sizes 2`` wrote: its
    compile seconds and package bytes; the package against the ``.pt2`` at
    batch 2 within ``AOT_TOL``; ``evaluate --serving-aot require`` in a
    fresh process with the report of the ``.pt2`` (phase 15's ``evaluate
    --serving-aot never``, ``artifact.json``) and confusion counts (7, 7);
    its time to the first batch beside the ``.pt2``'s (``pt2_cold``:
    import and context, load and first batch, read in phase 15's fresh
    process) and evaluation pairs/s at bs 2, package against ``.pt2``; a
    damaged package (``require`` raises naming it, ``auto`` serves through
    the ``.pt2``); and from ``start_sidecar_export``'s children
    (``results``), the full-width discriminator's artifact compiled at
    batch 4 beside a stale batch-2 package, which the compile removes (the
    Siamese net's compile takes minutes), and the int8 artifact's package
    against its ``.pt2`` within ``AOT_TOL``."""
    from gan_aug_pfa_torch import pipelines, serve
    from gan_aug_pfa_torch.config import EvalConfig

    package = f"{artifact}.aotc.bs{AOT_BATCH}.pt2"
    entries, why = serve._load_aot_sidecar(artifact, device)
    with open(serve.aot_sidecar_path(artifact), "rb") as f:
        index = json.loads(f.read()[len(serve.AOT_MAGIC):])
    info = index["shapes"][str(AOT_BATCH)]
    print(f"serving sidecar: compile {info['compile_s']} s at batch "
          f"{AOT_BATCH}, package {info['bytes']} bytes (the .pt2 "
          f"{os.path.getsize(artifact)} bytes); index {index['device_name']}"
          f", torch {index['torch_version']}, CUDA {index['cuda_version']}")
    if entries is None or sorted(entries) != [AOT_BATCH]:
        raise AssertionError(f"the sidecar is not usable: {why}")

    # The package against the .pt2, in this process.
    header, aot_fn = serve.load_serving_fn(artifact, aot="require",
                                           device=device)
    _, pt2_fn = serve.load_serving_fn(artifact, aot="never", device=device)
    if header["aot_batch_sizes"] != [AOT_BATCH]:
        raise AssertionError(f"aot_batch_sizes {header['aot_batch_sizes']}")
    gen = torch.Generator().manual_seed(SEED + 16)
    xs = [torch.rand((AOT_BATCH, 128, 128, 3), generator=gen) * 2 - 1
          for _ in range(2)]
    t0 = time.perf_counter()
    got = aot_fn(*xs)
    load_s = time.perf_counter() - t0
    want = pt2_fn(*xs)
    err = float((got - want).abs().max())
    print(f"serving sidecar: this process loaded the package and served "
          f"its first batch in {load_s:.2f} s")
    print(f"serving sidecar: max |package - .pt2| at batch {AOT_BATCH} = "
          f"{err} (limit {AOT_TOL}); finite {bool(torch.isfinite(got).all())}")
    if not err <= AOT_TOL or got.shape != (AOT_BATCH, 128, 128, 1):
        raise AssertionError("the sidecar disagrees with the .pt2")

    # Evaluation through the sidecar in a fresh process: the .pt2's report.
    out = os.path.join(root, "aot_require.json")
    t0 = time.perf_counter()
    rc, lines, _ = run_child(
        ["-c", AOT_EVAL_CHILD, "--root-dir", root, "--serving-artifact",
         artifact, "--serving-aot", "require", "--device", device,
         "--json-out", out], timeout=300)
    wall = time.perf_counter() - t0
    child = json.loads(lines[-1])
    print(f"serving sidecar: evaluate --serving-aot require in a fresh "
          f"process exited {rc}: confusion counts (calls, launches) "
          f"{tuple(child['counts'])}; evaluation {child['wall_s']:.2f} s, "
          f"process wall {wall:.2f} s")
    if rc != 0 or not child["ok"] or child["counts"] != [7, 7]:
        raise AssertionError("evaluate --serving-aot require failed")
    if not any(f"aot=[{AOT_BATCH}]" in line for line in lines):
        raise AssertionError("evaluate did not serve the sidecar")
    print(f"serving sidecar: a fresh process to its first batch: package "
          f"{child['import_s']:.2f} s of imports, then "
          f"{child['load_to_first_batch_s']:.2f} s from load_serving_fn "
          f"(evaluate's first batch {child['to_first_batch_s']:.2f} s after "
          f"its start); .pt2 {pt2_cold[0]:.2f} s of imports and context, "
          f"then {pt2_cold[1]:.2f} s from load_serving_fn (phase 15's "
          "fresh process, bs 1)")
    check_report_file(out)
    with open(out) as f:
        a = json.load(f)
    with open(os.path.join(root, "artifact.json")) as f:
        b = json.load(f)
    same = a == b
    if not same:
        # Only pixels within the two paths' largest probability difference
        # of the threshold may flip.
        pa, pb = (pipelines.artifact_fn(f)(cache.img1.permute(0, 2, 3, 1),
                                           cache.img2.permute(0, 2, 3, 1))
                  for f in (aot_fn, pt2_fn))
        dprob = float((pa - pb).abs().max())
        flips = int(((pa > 0.5) != (pb > 0.5)).sum())
        near = int(((pb - 0.5).abs() <= dprob).sum())
        print(f"serving sidecar: {flips} pixels flip between the paths, "
              f"{near} lie within max |dprob| = {dprob} of the threshold")
        if flips > near:
            raise AssertionError("the sidecar's evaluation differs beyond "
                                 "its probabilities")
    print(f"serving sidecar: report require vs never (the .pt2) equal: "
          f"{same}; overall {a['overall']} vs {b['overall']}")

    # Pairs/s at bs 2, package against .pt2, in turns.
    big = pipelines.DeviceCache(cache.img1.repeat(SERVE_REPS, 1, 1, 1),
                                cache.img2.repeat(SERVE_REPS, 1, 1, 1),
                                cache.labels.repeat(SERVE_REPS, 1, 1))
    cfg = EvalConfig(batch_size=AOT_BATCH)
    rates = {"package": [], ".pt2": []}
    fns = {"package": pipelines.artifact_fn(aot_fn),
           ".pt2": pipelines.artifact_fn(pt2_fn)}
    for name in fns:
        pipelines.evaluate_cached(fns[name], big, cities * SERVE_REPS, cfg)
    for _ in range(SERVE_PASSES):
        for name in ("package", ".pt2"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipelines.evaluate_cached(fns[name], big, cities * SERVE_REPS,
                                      cfg)
            torch.cuda.synchronize()
            rates[name].append(len(big) / (time.perf_counter() - t0))
    for name, r in rates.items():
        print(f"serving sidecar: eval throughput ({name}, 128x128, "
              f"{len(big)} pairs, bs {AOT_BATCH}): median "
              f"{float(np.median(r)):.1f} pairs/s over {SERVE_PASSES} passes"
              f" in turns, range [{min(r):.1f}, {max(r):.1f}]")
    del big, fns

    # A damaged package: require raises naming it, auto serves the .pt2.
    with open(package, "r+b") as f:
        f.seek(os.path.getsize(package) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    _, damaged = serve.load_serving_fn(artifact, aot="require", device=device)
    try:
        damaged(*xs)
    except ValueError as e:
        if package not in str(e):
            raise AssertionError(f"the error does not name {package}: {e}")
        print(f"serving sidecar: damaged package, require raised: {e}")
    else:
        raise AssertionError("require served a damaged package")
    _, auto = serve.load_serving_fn(artifact, aot="auto", device=device)
    fell, printed = run_captured(auto, *xs)
    dfall = float((fell - want).abs().max())
    print(f"serving sidecar: damaged package, auto served the .pt2: max "
          f"|auto - .pt2| = {dfall}")
    if f"serving batch {AOT_BATCH} through the exported program" not in \
            printed or dfall > AOT_TOL:
        raise AssertionError("auto did not fall back to the .pt2")

    # From the children: the discriminator's compile at batch 4 removed the
    # stale batch-2 package beside it; the int8 package against its .pt2.
    name, disc = os.path.basename(disc_artifact), results["exports"]
    print(f"serving sidecar: discriminator compiled at batch "
          f"{AOT_RECOMPILE_BATCH} in {disc['recompile_s']:.2f} s beside a "
          f"stale batch-{AOT_BATCH} package; sidecar files {disc['left']}")
    if disc["left"] != [name + ".aotc",
                        f"{name}.aotc.bs{AOT_RECOMPILE_BATCH}.pt2"]:
        raise AssertionError("the compile left a stale package")
    with open(serve.aot_sidecar_path(int8_artifact), "rb") as f:
        info8 = json.loads(f.read()[len(serve.AOT_MAGIC):])["shapes"][
            str(AOT_BATCH)]
    err8, int8_bytes = results["int8"]["max_abs_err"], info8["bytes"]
    print(f"serving sidecar: int8 package {int8_bytes} bytes against "
          f"the fp32 package's {info['bytes']} "
          f"({int8_bytes / info['bytes']:.4f}x; the .pt2 files "
          f"{os.path.getsize(int8_artifact) / os.path.getsize(artifact):.4f}"
          f"x), compile {info8['compile_s']} s; max |package - .pt2| at "
          f"batch {AOT_BATCH} {err8} (limit {AOT_TOL}, in its child)")
    if not err8 <= AOT_TOL:
        raise AssertionError("the int8 package disagrees with its .pt2")
    return {"sidecar_counts": child["counts"],
            "sidecar": {"compile_s": info["compile_s"],
                        "bytes": info["bytes"], "max_abs_err": err,
                        "int8_bytes": int8_bytes,
                        "int8_compile_s": info8["compile_s"],
                        "int8_max_abs_err": err8}}


# Phase 16: the C PNG decoder, the pooled PNG writer and --stream.
STREAM_PER_CITY = 30  # synthetic 256x256 samples written for each train city
STREAM_DEPTH = 2  # prefetch_batches' depth, the trainers' default
DECODE_SIDE = 600  # the all-Paeth and all-Average decoder cases
DECODE_THREADS = 8
WRITER_PASSES = 3


def sync_device(torch, device):
    if device == "cuda":
        torch.cuda.synchronize()


def smooth_rgb(rng, side):
    """A seeded RGB image with the smooth areas and edges of a photograph:
    8x8 blocks of random colour plus a little noise, so that PIL's filter
    choice (the port's writer) picks Sub, Up and Paeth rows."""
    blocks = rng.randint(0, 256, (side // 8, side // 8, 3))
    img = np.kron(blocks, np.ones((8, 8, 1), np.int64))
    return np.clip(img + rng.randint(-6, 7, img.shape), 0, 255).astype(
        np.uint8)


def write_stream_corpus(root, per_city, seed=SEED):
    """``per_city`` synthetic 256x256 triplets for each train city, in the
    synthetic corpus's layout, written by the port's pooled PNG writer."""
    from gan_aug_pfa_torch.config import TRAIN_CITIES
    from gan_aug_pfa_torch.data.png import PngWriterPool

    rng = np.random.RandomState(seed + 16)
    base = os.path.join(root, "synthetic_data")
    with PngWriterPool() as writer:
        for city in TRAIN_CITIES:
            images = os.path.join(base, "images", city)
            labels = os.path.join(base, "labels", city)
            os.makedirs(images)
            os.makedirs(labels)
            for i in range(per_city):
                writer.write(os.path.join(images, f"img1_synth_{i}.png"),
                             smooth_rgb(rng, 256))
                writer.write(os.path.join(images, f"img2_synth_{i}.png"),
                             smooth_rgb(rng, 256))
                writer.write(os.path.join(labels, f"cm_synth_{i}.png"),
                             (rng.rand(256, 256) > 0.8).astype(np.uint8)
                             * 255)


def decode_rates(decode, path, threads, reps):
    """MB/s of decoded bytes: ``reps`` decodes of the file one after the
    other on one thread, then ``threads`` decodes on ``threads`` threads."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    nbytes = sum(decode(path).nbytes for _ in range(reps)) // reps
    one = reps * nbytes / 1e6 / (time.perf_counter() - t0)
    with ThreadPoolExecutor(max_workers=threads) as ex:
        t0 = time.perf_counter()
        list(ex.map(decode, [path] * threads))
        many = threads * nbytes / 1e6 / (time.perf_counter() - t0)
    return one, many


def stream_decoder(root):
    """The C decoder against ``data/png.py`` byte for byte on every file of
    the 14-city tree and on all-Paeth and all-Average 600x600 RGB files;
    MB/s of both, one thread and 8; set-up seconds of the scan and the
    decode-once cache on the tree through each."""
    from gan_aug_pfa_torch.data import native_loader as nl
    from gan_aug_pfa_torch.data import png
    from gan_aug_pfa_torch.data.loader import build_cached_dataset
    from gan_aug_pfa_torch.data.scanner import create_sample_lists

    files = []
    for dirpath, _, names in os.walk(os.path.join(root, SUBDIR)):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".png")]
    for path in sorted(files):
        gray = os.path.basename(path) == "cm.png"
        fast, plain = ((nl.decode_gray, png.decode_gray) if gray
                       else (nl.decode_rgb, png.decode_rgb))
        if not np.array_equal(fast(path), plain(path)):
            raise AssertionError(f"C decoder differs from png.py on {path}")
    rng = np.random.RandomState(SEED)
    rates = {}
    for name, ftype in (("paeth", 4), ("average", 3)):
        path = os.path.join(root, f"{name}.png")
        arr = rng.randint(0, 256, (DECODE_SIDE, DECODE_SIDE, 3))
        write_png(path, arr, filter_type=ftype)
        got = nl.decode_rgb(path)
        if not (np.array_equal(got, arr) and np.array_equal(
                got, png.decode_rgb(path))):
            raise AssertionError(f"all-{name} file decoded wrong")
        # png.py's Python loop takes about 0.2-0.6 s a file: one decode.
        for label, decode, reps in (("C", nl.decode_rgb, 16),
                                    ("png.py", png.decode_rgb, 1)):
            rates[name, label] = decode_rates(decode, path, DECODE_THREADS,
                                              reps)
    print(f"decoder: C equals png.py byte for byte on the tree's "
          f"{len(files)} files and on all-Paeth and all-Average "
          f"{DECODE_SIDE}x{DECODE_SIDE} RGB files")
    for (name, label), (one, many) in rates.items():
        print(f"decoder MB/s (all-{name} {DECODE_SIDE}x{DECODE_SIDE} RGB, "
              f"{label}): {one:.1f} on 1 thread, {many:.1f} on "
              f"{DECODE_THREADS} threads")

    setup = {}
    for label, unfilter in (("C", nl.unfilter), ("png.py", png._unfilter)):
        saved = nl.unfilter
        nl.unfilter = unfilter  # what decode_rgb/decode_gray call
        try:
            t0 = time.perf_counter()
            samples = create_sample_lists(root, SUBDIR, mode="all",
                                          verbose=False)
            t1 = time.perf_counter()
            ds = build_cached_dataset(samples, (128, 128), verbose=False)
            t2 = time.perf_counter()
        finally:
            nl.unfilter = saved
        setup[label] = (t1 - t0, t2 - t1, ds)
    c, p = setup["C"], setup["png.py"]
    if not all(np.array_equal(getattr(c[2], k), getattr(p[2], k))
               for k in ("img1", "img2", "labels")):
        raise AssertionError("the caches of the two decoders differ")
    print(f"set-up on the 14-city tree (scan, cache at 128x128): C "
          f"{c[0]:.3f} + {c[1]:.3f} s, png.py {p[0]:.3f} + {p[1]:.3f} s "
          f"({(p[0] + p[1]) / (c[0] + c[1]):.1f}x); caches equal")
    return {"rates": {f"{n} {l}": v for (n, l), v in rates.items()},
            "setup_s": {k: v[:2] for k, v in setup.items()}}


def stream_writer(root):
    """A synthesis pass's 42 PNG writes (the 14 pairs' img1 replay, a
    generator-like img2 and the label at 256x256), serially with
    ``write_png`` and through ``PngWriterPool``: ms and equal bytes."""
    from gan_aug_pfa_torch.data import png
    from gan_aug_pfa_torch.data.loader import (
        build_cached_dataset,
        float_to_uint8,
    )
    from gan_aug_pfa_torch.data.scanner import create_sample_lists

    ds = build_cached_dataset(
        create_sample_lists(root, SUBDIR, mode="all", verbose=False),
        (256, 256), verbose=False)
    arrays = []
    for i in range(len(ds)):
        arrays += [(f"a{i}.png", float_to_uint8(ds.img1[i])),
                   (f"b{i}.png", float_to_uint8(ds.img2[i] * 0.5 + 0.25)),
                   (f"c{i}.png", ds.labels[i].astype(np.uint8) * 255)]
    times = {"serial": [], "pool": []}
    for rep in range(WRITER_PASSES):
        for kind in ("serial", "pool"):
            out = os.path.join(root, f"writer_{kind}_{rep}")
            os.makedirs(out)
            t0 = time.perf_counter()
            if kind == "serial":
                for name, arr in arrays:
                    png.write_png(os.path.join(out, name), arr)
            else:
                with png.PngWriterPool() as writer:
                    for name, arr in arrays:
                        writer.write(os.path.join(out, name), arr)
            times[kind].append(1e3 * (time.perf_counter() - t0))
    for name, _ in arrays:
        with open(os.path.join(root, "writer_serial_0", name), "rb") as f:
            want = f.read()
        for rep in range(WRITER_PASSES):
            with open(os.path.join(root, f"writer_pool_{rep}", name),
                      "rb") as f:
                if f.read() != want:
                    raise AssertionError(f"pooled writer's {name} differs")
    s, p = (float(np.median(times[k])) for k in ("serial", "pool"))
    print(f"PNG writer ({len(arrays)} files at 256x256, median of "
          f"{WRITER_PASSES}): serial {s:.1f} ms (range "
          f"[{min(times['serial']):.1f}, {max(times['serial']):.1f}]), "
          f"pool of 8 threads {p:.1f} ms (range [{min(times['pool']):.1f}, "
          f"{max(times['pool']):.1f}]), {s / p:.2f}x; files byte-identical")
    return times


def stream_cli_training(torch, root, extra):
    """One epoch of ``train --use-synthetic`` over the tree and its
    synthetic corpus with ``--stream host`` and ``--stream decode``, each
    under ``deterministic``, with the FocalDice (calls, launches) set to 0
    just before each and read just after."""
    from gan_aug_pfa_torch.ops.kernels.fused_loss import FocalDiceLossFn
    from gan_aug_pfa_torch.train import __main__ as train_cli

    runs = {}
    for mode in ("host", "decode"):
        reset_loss_counts(FocalDiceLossFn)
        t0 = time.time()
        with deterministic(torch):
            history = train_cli.main(
                ["--root-dir", root, "--use-synthetic", "--num-epochs", "1",
                 "--stream", mode, "--checkpoint-dir", f"stream_ckpt_{mode}",
                 *extra])
        wall = time.time() - t0
        runs[mode] = (history["train_loss"][0], history["val_loss"][0],
                      loss_counts(FocalDiceLossFn), wall)
        print(f"train --stream {mode}: wall {wall:.2f} s, train loss "
              f"{runs[mode][0]!r}, val loss {runs[mode][1]!r}, fused-loss "
              f"(calls, launches) {runs[mode][2]}")
    return runs


def stream_check_training(runs, resident_loss, n_train, bs=4):
    """The streamed CLI epochs against the resident epoch of the same init
    and order, all three under ``deterministic``: train losses equal in
    bits to the resident epoch's, and the two streams' val losses equal; one
    forward a train and a val step, one backward a train step."""
    steps = -(-n_train // bs)
    want = {"fwd": (steps + 1, steps + 1), "bwd": (steps, steps)}
    for mode, (loss, val, counts, _) in runs.items():
        print(f"train --stream {mode} against the resident epoch: train "
              f"loss {loss!r} against {resident_loss!r}, difference "
              f"{loss - resident_loss!r} (must be 0)")
        if loss != resident_loss:
            raise AssertionError(f"--stream {mode} train loss differs")
        if counts != want:
            raise AssertionError(f"--stream {mode} fused-loss counts "
                                 f"{counts}; expected {want}")
    vals = [run[1] for run in runs.values()]
    print(f"streamed val losses {vals!r}, difference {vals[0] - vals[1]!r} "
          "(must be 0)")
    if vals[0] != vals[1]:
        raise AssertionError(f"streamed val losses {vals} differ")


def batch_bytes(bs, size=128):
    """A staged Siamese batch: two NCHW float32 images and float32 labels."""
    return bs * (2 * 3 + 1) * size * size * 4


class StepMemory:
    """Device memory around each ``train_batch`` call of ``trainer``: the
    peak since the last step ended (the put of the next batches while the
    last one is still held), the bytes allocated as a step starts, and the
    step's own peak above them (its activations, gradients and workspace,
    the partial batch's too)."""

    def __init__(self, torch, trainer):
        self.cuda = torch.cuda
        self.gap, self.start, self.own = [], [], []
        step = trainer.train_batch

        def probed(*args, **kw):
            self.gap.append(self.cuda.max_memory_allocated())
            self.start.append(self.cuda.memory_allocated())
            self.cuda.reset_peak_memory_stats()
            out = step(*args, **kw)
            self.own.append(self.cuda.max_memory_allocated() - self.start[-1])
            self.cuda.reset_peak_memory_stats()
            return out

        self.trainer = trainer
        trainer.train_batch = probed

    def close(self):
        del self.trainer.train_batch  # the class's method again

    def excess(self, base):
        """(the epoch's peak less ``base`` and the largest step's own, the
        most held as a step starts, the most held between steps), each
        above ``base``."""
        peak = max([a + o for a, o in zip(self.start, self.own)]
                   + self.gap)
        return (peak - base - max(self.own), max(self.start) - base,
                max(self.gap) - base)


def stream_memory_and_rates(torch, samples, device):
    """In this process, at the Siamese net's full width (128x128, bf16):
    the resident epoch of a fresh trainer under ``deterministic`` (the
    streamed CLI epochs' init and order: their reference loss); steps/s of a resident, a ``host`` and a
    ``decode`` epoch at batch 4 and 16; and at batch 4 each epoch's device
    memory above what the model, the optimizer and the gradients hold
    (``StepMemory``): streamed, the peak less the largest step's own and
    the most held between steps within (depth + 2) batches; resident, at
    least the corpus held as each step starts."""
    from gan_aug_pfa_torch.config import SiameseTrainConfig
    from gan_aug_pfa_torch.data.loader import build_cached_dataset
    from gan_aug_pfa_torch.data.stream import StreamingSource
    from gan_aug_pfa_torch.pipelines import DeviceCache
    from gan_aug_pfa_torch.train.siamese import SiameseTrainer

    cuda = device == "cuda"
    ds = build_cached_dataset(samples, (128, 128), verbose=False)
    sources = {mode: StreamingSource(samples, (128, 128), cache=mode,
                                     verbose=False)
               for mode in ("host", "decode")}
    rates, excess, resident_loss, base = {}, {}, None, None
    try:
        for bs in (4, 16):
            trainer = SiameseTrainer(SiameseTrainConfig(batch_size=bs),
                                     device)
            cache = DeviceCache.from_dataset(ds, device)
            with (deterministic(torch) if bs == 4
                  else contextlib.nullcontext()):
                loss = trainer.train_epoch(cache, np.random.RandomState(SEED))
            if bs == 4:
                resident_loss = loss
            del cache
            steps = -(-len(ds) // bs)
            for mode in ("host", "decode", "hbm"):
                probe = None
                if cuda and bs == 4:
                    sync_device(torch, device)
                    base = torch.cuda.memory_allocated()
                    probe = StepMemory(torch, trainer)
                cache = (DeviceCache.from_dataset(ds, device)
                         if mode == "hbm" else None)
                rng = np.random.RandomState(SEED)
                sync_device(torch, device)
                if cuda:
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                if cache is None:
                    trainer.train_epoch_streaming(sources[mode], rng,
                                                  depth=STREAM_DEPTH)
                else:
                    trainer.train_epoch(cache, rng)
                sync_device(torch, device)
                rates[mode, bs] = steps / (time.perf_counter() - t0)
                if probe is not None:
                    probe.close()
                    excess[mode] = probe.excess(base)
                del cache
            del trainer
            if cuda:
                torch.cuda.empty_cache()
    finally:
        for src in sources.values():
            src.close()
    for (mode, bs), r in rates.items():
        print(f"train steps/s ({len(ds)} pairs, 128x128, bf16, bs {bs}, "
              f"{mode}): {r:.2f}")
    if excess:
        bound = (STREAM_DEPTH + 2) * batch_bytes(4)
        corpus = len(ds) * batch_bytes(1)
        print(f"device memory at batch 4 above the model, optimizer and "
              f"gradients ({base / 1e6:.2f} MB): the peak less the largest "
              f"step's own, the most held as a step starts, the most held "
              f"between steps")
        for mode, (peak, held, gap) in excess.items():
            print(f"  {mode}: {peak / 1e6:.2f}, {held / 1e6:.2f}, "
                  f"{gap / 1e6:.2f} MB")
        print(f"  a stream's bound: (depth + 2) x {batch_bytes(4)} B = "
              f"{bound / 1e6:.2f} MB; the resident corpus of {len(ds)} "
              f"pairs {corpus / 1e6:.2f} MB")
        if max(max(excess[m][0], excess[m][2])
               for m in ("host", "decode")) > bound:
            raise AssertionError("a streamed epoch held more than "
                                 "(depth + 2) batches on the device")
        if excess["hbm"][1] < corpus:
            raise AssertionError("the resident epoch does not hold the "
                                 "corpus")
    return rates, excess, resident_loss


def stream_augment(torch, root, extra):
    """One ``--augment --stream host`` epoch over the 11 train pairs: the
    note, the fixed-size chain, ``photometric_flip_chw`` once for each
    image of each step and never the native kernel."""
    from gan_aug_pfa_torch.ops.kernels import photometric as ph
    from gan_aug_pfa_torch.train import __main__ as train_cli

    reset_photometric_counts(ph)
    history, text = run_captured(train_cli.main, [
        "--root-dir", root, "--augment", "--stream", "host", "--num-epochs",
        "1", "--checkpoint-dir", "stream_ckpt_augment", *extra])
    counts = photometric_counts(ph)
    steps = -(-(len(CITIES) - 3) // 4)  # the 11 train cities
    print(f"train --augment --stream host: photometric (calls, launches) "
          f"{counts}, train loss {history['train_loss']}")
    if ("streaming the fixed-size chain instead" not in text
            or counts != {"native": (0, 0),
                          "flip": (2 * steps, 2 * steps)}
            or not np.isfinite(history["train_loss"]).all()):
        raise AssertionError(f"augmented stream: counts {counts}")
    return counts["flip"]


def stream_synthesis_files(synth_cli, root, mode, extra):
    """``generate_synthetic --stream mode`` with the GAN epoch's generator
    into a corpus of its own: {relative path: bytes}."""
    out = f"stream_synth_{mode}"
    n = synth_cli.main([
        "--root-dir", root, "--gan-checkpoint-dir", "stream_gan_hbm",
        "--generator-checkpoint-name", "generator_epoch_1.pth",
        "--synthetic-data-dir", out, "--stream", mode, *extra])
    if n != len(CITIES):
        raise AssertionError(f"synthesis --stream {mode} wrote {n}")
    files = {}
    base = os.path.join(root, out)
    for dirpath, _, names in os.walk(base):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                files[os.path.relpath(path, base)] = f.read()
    return files


def stream_gan_synthesis_eval(torch, root, device, extra):
    """``train_gan`` for one epoch at its defaults (256x256, batch 1, bf16,
    full width), resident and ``--stream decode``, under ``deterministic``:
    losses equal in bits; then ``generate_synthetic`` with its generator,
    resident and ``--stream decode``, under ``deterministic``: files
    byte-identical; then ``evaluate``
    of a seeded checkpoint, resident, ``--stream host`` and ``--stream
    decode``, with the confusion counts' (calls, launches) set to 0 just
    before each and read just after: (7, 7) each, the JSON reports
    equal."""
    from gan_aug_pfa_torch import checkpoint, evaluate
    from gan_aug_pfa_torch import generate_synthetic as synth_cli
    from gan_aug_pfa_torch import train_gan as gan_cli
    from gan_aug_pfa_torch.models import SiameseUNet
    from gan_aug_pfa_torch.ops.kernels import confusion_counts as cc

    gan = {}
    for mode in ("hbm", "decode"):
        t0 = time.time()
        with deterministic(torch):
            history = gan_cli.main([
                "--root-dir", root, "--num-epochs", "1", "--stream", mode,
                "--checkpoint-dir", f"stream_gan_{mode}", "--output-dir",
                f"stream_gan_samples_{mode}", *extra])
        gan[mode] = (history["loss_d"][0], history["loss_g"][0],
                     time.time() - t0)
        print(f"train_gan --stream {mode}: wall {gan[mode][2]:.2f} s, loss "
              f"D {gan[mode][0]!r}, loss G {gan[mode][1]!r}")
    diff = [a - b for a, b in zip(gan["decode"][:2], gan["hbm"][:2])]
    print(f"train_gan --stream decode against resident (both under "
          f"deterministic mode): loss differences {diff} (must be 0)")
    if any(diff):
        raise AssertionError("the streamed GAN epoch differs")

    # cuDNN's conv-transpose (its backward-data algorithms) may add in any
    # order: both runs take deterministic algorithms, so that the files
    # show what the stream feeds the generator and nothing else.
    synth = {}
    with deterministic(torch):
        for mode in ("hbm", "decode"):
            synth[mode] = stream_synthesis_files(
                synth_cli, root, mode, extra)
    differ = sorted(k for k in synth["hbm"]
                    if synth["decode"].get(k) != synth["hbm"][k])
    if differ or len(synth["hbm"]) != 3 * len(CITIES):
        raise AssertionError(f"generate_synthetic --stream decode files "
                             f"differ from the resident run's: {differ}")
    print(f"generate_synthetic --stream decode: {len(synth['hbm'])} files "
          "byte-identical to the resident run's (cuDNN deterministic)")

    model = seeded_model(torch, SiameseUNet)
    pth = os.path.join(root, "stream_eval", "model.pth")
    checkpoint.save_model(pth, model)
    fn = cc.confusion_counts_batch
    reports, counts = {}, {}
    for mode in ("hbm", "host", "decode"):
        path = os.path.join(root, f"stream_report_{mode}.json")
        fn.calls = fn.launches = 0
        result = evaluate.main([
            "--root-dir", root, "--checkpoint-path", pth, "--json-out", path,
            "--stream", mode, "--output-dir", f"stream_eval_{mode}", *extra])
        sync_device(torch, device)
        counts[mode] = (fn.calls, fn.launches)
        check_report(result, path)
        with open(path) as f:
            reports[mode] = json.load(f)
        print(f"evaluate --stream {mode}: confusion counts (calls, "
              f"launches) {counts[mode]}")
    if any(c != (7, 7) for c in counts.values()):
        raise AssertionError(f"evaluation counts {counts}")
    if not reports["hbm"] == reports["host"] == reports["decode"]:
        raise AssertionError("the streamed evaluation reports differ")
    print("evaluate --stream host and decode: JSON reports equal the "
          "resident one")
    return {"gan": gan, "eval_counts": counts}


def phase_stream(torch, root, device="cuda"):
    """Phase 16: the C PNG decoder, the pooled PNG writer and ``--stream``
    at full width.  Returns the kernels' counts of the streamed runs."""
    from gan_aug_pfa_torch.data.scanner import create_sample_lists
    from gan_aug_pfa_torch.ops.kernels import build

    extra = [] if device == "cuda" else ["--device", "cpu"]
    t0 = time.time()
    write_oscd_tree(root)
    decoder = stream_decoder(root)
    writer = stream_writer(root)
    t1 = time.time()
    write_stream_corpus(root, STREAM_PER_CITY)
    print(f"stream corpus: {STREAM_PER_CITY} synthetic 256x256 triplets for "
          f"each of the 11 train cities written in {time.time() - t1:.2f} s "
          "(pooled writer)")
    samples = create_sample_lists(root, SUBDIR, mode="train",
                                  use_synthetic=True, verbose=False)
    rates, excess, resident_loss = stream_memory_and_rates(torch, samples,
                                                           device)
    runs = stream_cli_training(torch, root, extra)
    stream_check_training(runs, resident_loss, len(samples))
    flip = stream_augment(torch, root, extra)
    rest = stream_gan_synthesis_eval(torch, root, device, extra)
    print(f"phase 16 (stream) took {time.time() - t0:.1f} s")
    return {"loss": runs["decode"][2], "flip": flip,
            "confusion_counts": rest["eval_counts"]["decode"],
            "decoder": decoder, "writer": writer, "rates": rates,
            "excess": excess, "build": build.BUILD_DIR}


# The JAX package's training knobs (phase 17).  Each Siamese knob's flags,
# its SiameseTrainConfig fields, and the same for the GAN's.
SIAMESE_KNOBS = {
    "batched_encoder": (["--batched-encoder"], dict(batched_encoder=True)),
    "concat_free": (["--concat-free"], dict(concat_free=True)),
    "remat": (["--remat"], dict(remat=True)),
    "grad_accum": (["--grad-accum", "2"], dict(grad_accum=2)),
    "momentum_bf16": (["--momentum-dtype", "bfloat16"],
                      dict(opt_momentum_dtype="bfloat16")),
    "flat_opt_state": (["--flat-opt-state"], dict(opt_flat_state=True)),
}
# All six at once, at k 4: two epochs of 3 steps leave 2 of 4 gradients
# held, so that the resume starts in the middle of an accumulation.
ALL_KNOB_FLAGS = ["--batched-encoder", "--concat-free", "--remat",
                  "--grad-accum", "4", "--momentum-dtype", "bfloat16",
                  "--flat-opt-state"]
GAN_KNOBS = {
    "batched_disc": (["--batched-disc"], dict(batched_disc=True)),
    "concat_free_disc": (["--concat-free-disc"],
                         dict(concat_free_disc=True)),
    "shared_gen_fwd": (["--shared-gen-fwd"], dict(shared_gen_fwd=True)),
    "momentum_bf16": (["--momentum-dtype", "bfloat16"],
                      dict(opt_momentum_dtype="bfloat16")),
    "flat_opt_state": (["--flat-opt-state"], dict(opt_flat_state=True)),
}
KNOB_REPS = 8  # copies of the 11 train pairs in the timed Siamese epochs
KNOB_PASSES = 1  # timed epochs a configuration, after one warm-up epoch


def knob_cli_training(torch, root, extra, val_steps=1, train_steps=3):
    """``python -m gan_aug_pfa_torch.train`` for 2 epochs with each knob,
    then all six with ``--augment --stream host`` and a resumed third
    epoch, in this process, with the FocalDice and photometric (calls,
    launches) set to 0 just before each run and read just after: a
    forward a train and a val step, a backward a train step, the flip
    kernel twice a streamed augmented step, one launch a call."""
    from gan_aug_pfa_torch.ops.kernels import photometric as ph
    from gan_aug_pfa_torch.ops.kernels.fused_loss import FocalDiceLossFn
    from gan_aug_pfa_torch.train import __main__ as train_cli

    def run(name, flags, epochs, augment=False, keep=False):
        ckpt = os.path.join(root, f"knob_{name}")
        reset_loss_counts(FocalDiceLossFn)
        reset_photometric_counts(ph)
        t0 = time.time()
        history = train_cli.main(["--root-dir", root, "--checkpoint-dir",
                                  ckpt, "--num-epochs", str(epochs), *flags,
                                  *extra])
        wall = time.time() - t0
        loss, photo = loss_counts(FocalDiceLossFn), photometric_counts(ph)
        ran = len(history["train_loss"])
        steps = train_steps * ran
        want = {"fwd": (steps + val_steps * ran,) * 2, "bwd": (steps,) * 2}
        want_photo = {"native": (0, 0),
                      "flip": (2 * steps,) * 2 if augment else (0, 0)}
        losses = history["train_loss"] + history["val_loss"]
        print(f"train {' '.join(flags)}: {ran} epochs, wall {wall:.2f} s, "
              f"train loss {history['train_loss']}, val loss "
              f"{history['val_loss']}, fused-loss (calls, launches) {loss}, "
              f"photometric {photo}")
        if loss != want or photo != want_photo or not np.isfinite(
                losses).all():
            raise AssertionError(f"{name}: counts {loss} {photo}, expected "
                                 f"{want} {want_photo}; losses {losses}")
        state = torch.load(os.path.join(ckpt, "last_state.pth"),
                           map_location="cpu", weights_only=True)
        if not keep:
            shutil.rmtree(ckpt)
        return {"loss": loss, "photometric": photo, "wall": wall,
                "epochs": ran, "state": state}

    runs = {}
    for name, (flags, _) in SIAMESE_KNOBS.items():
        runs[name] = run(name, flags, 2)
        runs[name].pop("state")
    flags = ALL_KNOB_FLAGS + ["--augment", "--stream", "host"]
    runs["all"] = run("all", flags, 2, augment=True, keep=True)
    runs["resume"] = run("all", flags + ["--resume"], 3, augment=True)
    for name, epoch, count, mini in (("all", 2, 1, 2), ("resume", 3, 2, 1)):
        state = runs[name].pop("state")
        opt = state["optimizer"]
        got = (state["epoch"], opt["count"], opt["mini_step"], opt["layout"])
        layout = {"mu_dtype": "bfloat16", "flat": True, "multi_steps": True,
                  "grad_accum": 4}
        print(f"{name}: last_state.pth at epoch {got[0]}, Adam count "
              f"{got[1]}, mini_step {got[2]} of 4, layout {got[3]}")
        if got != (epoch, count, mini, layout):
            raise AssertionError(f"{name}: resume state {got}, expected "
                                 f"{(epoch, count, mini, layout)}")
    if runs["resume"]["epochs"] != 1:
        raise AssertionError("the resume ran more than one epoch")
    return runs


def knob_train_card_vs_cpu(torch, ds, devices=("cuda", "cpu")):
    """For each Siamese knob, one fp32 train step (TF32 off) from one
    seeded init on the card and on the CPU, the loss within phase 6's
    1e-5 relative."""
    from gan_aug_pfa_torch.config import SiameseTrainConfig
    from gan_aug_pfa_torch.pipelines import DeviceCache
    from gan_aug_pfa_torch.train.siamese import SiameseTrainer

    out = {}
    for name, (_, knobs) in SIAMESE_KNOBS.items():
        losses = []
        for device in devices:
            trainer = SiameseTrainer(SiameseTrainConfig(
                compute_dtype="float32", **knobs), device)
            cache = DeviceCache.from_dataset(ds, device)
            losses.append(float(trainer.train_step(
                cache, torch.arange(4, device=device))))
            del trainer, cache
        out[name] = abs(losses[0] - losses[1]) / abs(losses[1])
        print(f"knob {name}: fp32 train step card vs CPU, loss "
              f"{losses[0]!r} vs {losses[1]!r}, relative difference "
              f"{out[name]:.3e}")
        if out[name] > TRAIN_STEP1_RTOL:
            raise AssertionError(f"{name}: the train step on the card "
                                 "disagrees with the CPU")
    return out


# The optimizer knobs, as make_optimizer's arguments.
OPTIMIZER_KNOBS = {
    "momentum_bf16": dict(mu_dtype="bfloat16"),
    "flat_opt_state": dict(flat_state=True),
    "grad_accum": dict(grad_accum=2),
    "all": dict(mu_dtype="bfloat16", flat_state=True, grad_accum=2),
}
OPTIMIZER_RTOL = 1e-6  # after 3 mini-steps, card vs CPU, of each tensor's max


def knob_optimizer_card_vs_cpu(torch, devices=("cuda", "cpu"), steps=3):
    """Each optimizer knob, Adam and AdamW, over the full-width
    discriminator's parameters on the card and on the CPU from the same
    seeded values and gradients: the parameters, first moments and
    accumulator after ``steps`` mini-steps within 1e-6 of each tensor's
    largest value, the counters equal, and bf16 first moments equal bit
    for bit (their sums are formed in float64 and rounded once, the same
    on both)."""
    from gan_aug_pfa_torch.models import NLayerDiscriminator
    from gan_aug_pfa_torch.train.optim import make_optimizer

    gen = torch.Generator().manual_seed(SEED)
    shapes = [p.shape for p in NLayerDiscriminator().parameters()]
    start = [torch.randn(s, generator=gen) * 0.05 for s in shapes]
    grads = [[torch.randn(s, generator=gen) * 10.0 ** float(
        torch.empty(1).uniform_(-4, 0, generator=gen)) for s in shapes]
        for _ in range(steps)]
    worst = {}
    for name, knobs in OPTIMIZER_KNOBS.items():
        for opt_name in ("adamw", "adam"):
            runs = []
            for device in devices:
                params = [torch.nn.Parameter(p.to(device, copy=True))
                          for p in start]
                opt = make_optimizer(opt_name, params, 1e-3, 1e-2, **knobs)
                for g in grads:
                    for p, gi in zip(params, g):
                        p.grad = gi.to(device)
                    opt.step()
                sd = opt.state_dict()
                runs.append(([p.detach().cpu() for p in params],
                             [t.cpu() for t in sd["exp_avg"]],
                             [t.cpu() for t in sd["acc"] or []],
                             (sd["count"], sd["mini_step"])))
            (pa, ma, aa, ca), (pb, mb, ab, cb) = runs
            # Each tensor's largest difference over its largest value: a
            # parameter an update moves through 0 has no relative error of
            # its own.
            rel = max(float((a.float() - b.float()).abs().max()
                            / b.float().abs().max())
                      for a, b in zip(pa + ma + aa, pb + mb + ab))
            worst[name, opt_name] = rel
            bf16 = knobs.get("mu_dtype") == "bfloat16"
            equal = ca == cb and (not bf16 or all(
                torch.equal(a, b) for a, b in zip(ma, mb)))
            print(f"optimizer {opt_name} {name}: {steps} mini-steps card vs "
                  f"CPU, parameters, first moments and accumulator within "
                  f"{rel:.3e} relative, counters {ca} and {cb}"
                  + (", bf16 moments equal" if bf16 and equal else ""))
            if rel > OPTIMIZER_RTOL or not equal:
                raise AssertionError(f"{opt_name} {name}: the card's "
                                     "optimizer disagrees with the CPU's")
    return worst


def timed_epochs(torch, trainer, cache, device, passes=KNOB_PASSES):
    """One warm-up epoch, then ``passes`` timed ones: the walls (s) and the
    device memory the timed epochs held at their peak above what was
    allocated before them (None on the CPU)."""
    rng = np.random.RandomState(SEED)
    trainer.train_epoch(cache, rng)
    sync_device(torch, device)
    cuda = device == "cuda"
    if cuda:
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(passes):
        t0 = time.perf_counter()
        trainer.train_epoch(cache, rng)
        sync_device(torch, device)
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base if cuda else None
    return walls, peak


def knob_train_throughput(torch, ds, device="cuda", reps=KNOB_REPS):
    """Train steps/s (bf16, full width) of the plain trainer and of each
    knob at batch 4 and 16 over ``reps`` copies of the train pairs, in
    this process; the device memory each timed epoch held above the model,
    the optimizer and the cache; then kernel launches a step of one plain
    train epoch for the plain trainer, ``--batched-encoder``,
    ``--concat-free`` and ``--flat-opt-state`` (profiled last: a profiler
    session slows a process's later launch-bound steps)."""
    from gan_aug_pfa_torch.config import SiameseTrainConfig
    from gan_aug_pfa_torch.pipelines import DeviceCache
    from gan_aug_pfa_torch.train.siamese import SiameseTrainer

    cache = DeviceCache.from_dataset(ds, device)
    big = DeviceCache(cache.img1.repeat(reps, 1, 1, 1),
                      cache.img2.repeat(reps, 1, 1, 1),
                      cache.labels.repeat(reps, 1, 1))
    configs = {"plain": {}, **{k: v[1] for k, v in SIAMESE_KNOBS.items()}}
    profiled = ("plain", "batched_encoder", "concat_free", "flat_opt_state")
    rates, memory, keep = {}, {}, {}
    for bs in (4, 16):
        for name, knobs in configs.items():
            trainer = SiameseTrainer(SiameseTrainConfig(batch_size=bs,
                                                        **knobs), device)
            walls, peak = timed_epochs(torch, trainer, big, device)
            steps = -(-len(big) // bs)
            rates[name, bs] = [steps / w for w in walls]
            memory[name, bs] = peak
            print(f"train {name} (bf16, 128x128, bs {bs}, {len(big)} "
                  f"pairs): median {float(np.median(rates[name, bs])):.2f} "
                  f"steps/s over {len(walls)} epochs "
                  f"{[round(r, 2) for r in rates[name, bs]]}, device memory "
                  f"above the model, optimizer and cache "
                  f"{peak if peak is None else round(peak / 2**20, 1)} MiB")
            if bs == 4 and name in profiled:
                keep[name] = trainer
            del trainer
            if device == "cuda":
                torch.cuda.empty_cache()
    launches = {}
    if device == "cuda":
        for name in profiled:
            rng = np.random.RandomState(SEED)
            trainer = keep.pop(name)
            _, kernels = device_breakdown(
                torch, lambda: trainer.train_epoch(cache, rng),
                f"one bs-4 train epoch, {name} ({len(cache)} pairs, 3 "
                f"steps, bf16)", ("focal_dice",), top=3)
            launches[name] = sum(e.count for e in kernels) / 3
            print(f"train {name}: {launches[name]:.1f} kernel launches a "
                  "step")
    return {"steps_s": rates, "memory": memory, "launches": launches}


def knob_gan_cli(torch, root, extra):
    """``python -m gan_aug_pfa_torch.train_gan`` for one epoch with each GAN
    knob, in this process: finite losses and the epoch's files."""
    from gan_aug_pfa_torch import train_gan as gan_cli

    out = {}
    for name, (flags, _) in GAN_KNOBS.items():
        ckpt = f"gan_knob_{name}"
        t0 = time.time()
        history = gan_cli.main(["--root-dir", root, "--num-epochs", "1",
                                "--checkpoint-dir", ckpt, "--output-dir",
                                f"gan_samples_{name}", *flags, *extra])
        wall = time.time() - t0
        losses = history["loss_d"] + history["loss_g"]
        files = sorted(os.listdir(os.path.join(root, ckpt)))
        print(f"train_gan {' '.join(flags)}: wall {wall:.2f} s, losses "
              f"{losses}, files {files}")
        if len(losses) != 2 or not np.isfinite(losses).all() or files != [
                "discriminator_epoch_1.pth", "generator_epoch_1.pth",
                "last_discriminator.pth", "last_generator.pth"]:
            raise AssertionError(f"train_gan {name}: {losses} {files}")
        shutil.rmtree(os.path.join(root, ckpt))
        out[name] = {"losses": losses, "wall": wall}
    return out


def knob_gan_card_vs_cpu(torch, ds, devices=("cuda", "cpu"), arch=None):
    """One fp32 D+G step (TF32 off) from one seeded init on the card and
    on the CPU for each GAN knob: phase 9's tolerances (1e-5) on both
    losses.  loss_G reads D's update, the optimizers' knobs included."""
    from gan_aug_pfa_torch.config import GANTrainConfig
    from gan_aug_pfa_torch.train.gan import GANTrainer

    out = {}
    for name, (_, knobs) in GAN_KNOBS.items():
        losses = []
        for device in devices:
            trainer = GANTrainer(GANTrainConfig(compute_dtype="float32",
                                                **(arch or {}), **knobs),
                                 device)
            a, b = (torch.from_numpy(x[:1]).permute(0, 3, 1, 2).contiguous()
                    .to(device) for x in (ds.img1, ds.img2))
            losses.append([float(v) for v in trainer.train_batch(a, b)])
            del trainer
        rel = [abs(c - p) / abs(p) for c, p in zip(*losses)]
        out[name] = rel
        print(f"GAN knob {name}: fp32 D+G step card vs CPU, (loss_D, "
              f"loss_G) {losses[0]} vs {losses[1]}, relative differences "
              f"{rel}")
        if rel[0] > GAN_LOSS_D_RTOL or rel[1] > GAN_LOSS_G_RTOL:
            raise AssertionError(f"GAN {name}: the card disagrees with the "
                                 "CPU")
    return out


def knob_gan_throughput(torch, ds, device="cuda", arch=None):
    """GAN steps/s (bf16, batch 1) of the plain step and each GAN knob over
    the 14 pairs, in this process; then kernel launches a step and the
    device's busy share of one profiled epoch each."""
    from gan_aug_pfa_torch.config import GANTrainConfig
    from gan_aug_pfa_torch.pipelines import DeviceCache
    from gan_aug_pfa_torch.train.gan import GANTrainer

    cache = DeviceCache.from_dataset(ds, device)
    configs = {"plain": {}, **{k: v[1] for k, v in GAN_KNOBS.items()}}
    trainers, rates = {}, {}
    for name, knobs in configs.items():
        trainer = GANTrainer(GANTrainConfig(**(arch or {}), **knobs), device)
        walls, _ = timed_epochs(torch, trainer, cache, device)
        rates[name] = [len(cache) / w for w in walls]
        print(f"GAN {name} (bf16, batch 1, {len(cache)} steps an epoch): "
              f"median {float(np.median(rates[name])):.2f} steps/s "
              f"{[round(r, 2) for r in rates[name]]}")
        trainers[name] = trainer
    profiles = {}
    # Half an epoch profiled (the trace's processing took most of the
    # phase's time at 14 steps).
    half = DeviceCache(*(t[:len(cache) // 2] for t in (
        cache.img1, cache.img2, cache.labels)))
    if device == "cuda":
        for name, trainer in trainers.items():
            rng = np.random.RandomState(SEED)
            busy_us, kernels = device_breakdown(
                torch, lambda: trainer.train_epoch(half, rng),
                f"one GAN epoch, {name} ({len(half)} steps)", (), top=3)
            profiles[name] = {
                "launches": sum(e.count for e in kernels) / len(half),
                "busy_us": busy_us}
            print(f"GAN {name}: {profiles[name]['launches']:.1f} kernel "
                  "launches a step")
    return {"steps_s": rates, "profiles": profiles}


def phase_knobs(torch, root):
    """Phase 17: the JAX package's training knobs at full width on the
    phase-6 tree.  Returns the kernels' counts of the CLI runs."""
    from gan_aug_pfa_torch.data.loader import build_cached_dataset
    from gan_aug_pfa_torch.data.scanner import create_sample_lists

    t0 = last = time.time()

    def lap(label):
        nonlocal last
        now = time.time()
        print(f"phase 17: {label} {now - last:.1f} s")
        last = now

    write_oscd_tree(root)
    runs = knob_cli_training(torch, root, [])
    lap("train CLI runs")
    train_ds = build_cached_dataset(create_sample_lists(
        root, SUBDIR, mode="train", verbose=False), (128, 128),
        verbose=False)
    knob_train_card_vs_cpu(torch, train_ds)
    knob_optimizer_card_vs_cpu(torch)
    lap("card vs CPU (train steps, optimizers)")
    throughput = knob_train_throughput(torch, train_ds)
    torch.cuda.empty_cache()
    lap("train throughput")
    gan = knob_gan_cli(torch, root, [])
    gan_ds = build_cached_dataset(create_sample_lists(
        root, SUBDIR, mode="all", verbose=False), (256, 256), verbose=False)
    knob_gan_card_vs_cpu(torch, gan_ds)
    lap("GAN CLI runs, card vs CPU")
    gan_rates = knob_gan_throughput(torch, gan_ds)
    lap("GAN throughput")
    print(f"phase 17 (knobs) took {time.time() - t0:.1f} s")
    return {"runs": runs, "throughput": throughput, "gan": gan,
            "gan_throughput": gan_rates}


# -- phase 18: data-parallel training -------------------------------------

DP_WORLD = 2  # ranks sharing the one card over gloo
# (b) one fp32 step on two ranks against one process: the loss within
# 1e-5; the gradients (but the conv biases that feed a BatchNorm, whose
# gradient is rounding noise) no farther from the float64 step's than
# DP_GRAD_FACTOR times the one-process fp32 step's (this model's fp32
# gradients lie about 1e-3 of their maximum from float64 ones, ROADMAP
# §C2, so two fp32 orders of sums differ by that much); the parameters
# within 2 lr everywhere (Adam's first step moves an element by lr times
# the sign of its gradient, and a gradient within rounding of 0 may flip)
# and within 1e-6 on DP_PARAM_SHARE of the elements (measured 99.11%).
DP_STEP_RTOL = 1e-5
DP_GRAD_FACTOR = 2.0
DP_PARAM_ATOL, DP_PARAM_SHARE = 1e-6, 0.98
# (c) bf16 epoch losses on two ranks against one process (ROADMAP §C7).
DP_LOSS_RTOL = 1e-3
DP_CHILD = ("import sys, chip_smoke; "
            "sys.exit(chip_smoke.{fn}(*sys.argv[1:]))")


def dp_step_setup(torch, mesh, device="cuda"):
    """A fp32 Siamese trainer at the defaults (on ``mesh`` when given)
    and a device cache of 4 seeded 128x128 pairs: one step's input."""
    from gan_aug_pfa_torch.config import SiameseTrainConfig
    from gan_aug_pfa_torch.pipelines import DeviceCache
    from gan_aug_pfa_torch.train.siamese import SiameseTrainer

    rng = np.random.RandomState(SEED)
    img = [torch.from_numpy(rng.rand(4, 3, 128, 128).astype(np.float32))
           for _ in range(2)]
    labels = torch.from_numpy((rng.rand(4, 128, 128) > 0.8).astype(
        np.float32))
    trainer = SiameseTrainer(SiameseTrainConfig(compute_dtype="float32"),
                             device, mesh=mesh)
    dev = trainer.device
    return trainer, DeviceCache(img[0].to(dev), img[1].to(dev),
                                labels.to(dev))


def dp_step_rank(out_dir):
    """(b) in a child: one rank of DP_WORLD on the one card (gloo), one fp32
    step of batch 4 (2 rows a rank); rank 0 saves the loss, parameters and
    summed gradients, rank 1 how far its parameters lie from rank 0's."""
    import torch
    import torch.distributed as dist

    from gan_aug_pfa_torch.parallel.mesh import (
        make_mesh,
        maybe_distributed_init,
    )

    if not maybe_distributed_init("cuda"):
        raise AssertionError("no process group from the environment")
    try:
        mesh = make_mesh(device="cuda")
        print(f"rank {mesh.rank} of {mesh.world_size} on {mesh.device}, "
              f"backend {mesh.backend}")
        if (mesh.world_size, mesh.backend) != (DP_WORLD, "gloo"):
            raise AssertionError(f"mesh {mesh}")
        trainer, cache = dp_step_setup(torch, mesh)
        loss = trainer.train_step(cache, torch.arange(4, device=mesh.device))
        params = dict(trainer.model.named_parameters())
        spread = max(float((mesh.broadcast(p.detach().clone())
                            - p.detach()).abs().max())
                     for p in params.values())
        if mesh.rank == 0:
            torch.save({"loss": float(loss),
                        "params": {k: p.detach().cpu()
                                   for k, p in params.items()},
                        "grads": {k: p.grad.cpu()
                                  for k, p in params.items()}},
                       os.path.join(out_dir, "step.pt"))
        else:
            with open(os.path.join(out_dir, "spread.json"), "w") as f:
                json.dump(spread, f)
    finally:
        dist.destroy_process_group()
    return 0


def dp_cli_rank(out_dir, module, *argv):
    """(c), (d) in a child: ``module.main(argv)`` as one rank (the torchrun
    variables in the environment), with the FocalDice and photometric
    (calls, launches) set to 0 just before and read just after, and the
    checkpoint files this rank wrote; into ``out_dir/rank<R>.json``."""
    import importlib

    from gan_aug_pfa_torch import checkpoint as ckpt
    from gan_aug_pfa_torch.ops.kernels import photometric as ph
    from gan_aug_pfa_torch.ops.kernels.fused_loss import FocalDiceLossFn

    writes, save = [], ckpt.save

    def counted(path, payload):
        writes.append(os.path.basename(path))
        save(path, payload)

    ckpt.save = counted
    cli = importlib.import_module(module)
    reset_loss_counts(FocalDiceLossFn)
    reset_photometric_counts(ph)
    history = cli.main(list(argv))
    out = {"loss": loss_counts(FocalDiceLossFn),
           "photometric": photometric_counts(ph), "writes": writes,
           "history": {k: v for k, v in history.items()
                       if k in ("train_loss", "val_loss", "loss_d",
                                "loss_g")}}
    with open(os.path.join(out_dir, f"rank{os.environ['RANK']}.json"),
              "w") as f:
        json.dump(out, f)
    return 0


def run_ranks(fn, args, timeout=300.0, world=DP_WORLD):
    """``chip_smoke.fn(*args)`` as ranks 0..world-1 of one group, each in
    a child process with torchrun's variables (a free port on localhost),
    their output in files and echoed after; raises unless every rank
    exits 0.  Kills what still runs."""
    from gan_aug_pfa_torch.parallel.mesh import free_port

    port = str(free_port())
    logs = [tempfile.TemporaryFile("w+") for _ in range(world)]
    procs = []
    try:
        for rank, log in enumerate(logs):
            env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(rank),
                       LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
            procs.append(subprocess.Popen(
                [sys.executable, "-u", "-c", DP_CHILD.format(fn=fn),
                 *map(str, args)], cwd=REPO, env=env, stdout=log,
                stderr=subprocess.STDOUT, text=True))
        deadline = time.time() + timeout
        rcs = [p.wait(timeout=max(1.0, deadline - time.time()))
               for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, log in enumerate(logs):
        log.seek(0)
        lines = log.read().splitlines()
        log.close()
        for line in lines[-40:]:
            print(f"  rank {rank} | {line}")
    if rcs != [0] * world:
        raise AssertionError(f"{fn}: ranks exited {rcs}")


def dp_nccl_one_rank(torch):
    """(a) one NCCL rank (a group of one, in this process): a collective
    runs on the card, the trainer takes the one-rank mesh as no mesh (no
    global BatchNorm), and its fp32 step (TF32 off) under ``deterministic``
    gives the step without a group's loss and parameters bit for bit."""
    import torch.distributed as dist

    from gan_aug_pfa_torch.parallel.batchnorm import GlobalBatchNorm2d
    from gan_aug_pfa_torch.parallel.mesh import default_mesh, free_port, \
        make_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(device="cuda")
        t = mesh.all_reduce_sum(torch.arange(4.0, device="cuda"))
        if (mesh.world_size, mesh.backend) != (1, "nccl") or t.tolist() != [
                0.0, 1.0, 2.0, 3.0] or mesh.agree(False):
            raise AssertionError(f"one-rank NCCL mesh {mesh}: {t}")
        if default_mesh(True, "cuda") is not None:
            raise AssertionError("a one-rank group gave the trainers a mesh")
        runs = []
        with deterministic(torch):
            for m in (mesh, None):
                trainer, cache = dp_step_setup(torch, m)
                if trainer.mesh is not None or any(
                        isinstance(b, GlobalBatchNorm2d)
                        for b in trainer.model.modules()):
                    raise AssertionError("a one-rank mesh changed the "
                                         "trainer")
                loss = trainer.train_step(cache,
                                          torch.arange(4, device="cuda"))
                runs.append((loss, [p.detach().clone()
                                    for p in trainer.model.parameters()]))
        diffs = torch.cat([(a - b).abs().flatten()
                           for a, b in zip(runs[0][1], runs[1][1])])
        equal = torch.equal(runs[0][0], runs[1][0])
        same = all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
        print(f"phase 18 (a): one NCCL rank, fp32 step loss "
              f"{float(runs[0][0]):.8f}, equal bits to no group: {equal}; "
              f"parameters equal bits: {same} (max|d| "
              f"{float(diffs.max()):.2e})")
        if not (equal and same):
            raise AssertionError("a one-rank NCCL step differs from the "
                                 "step without a group")
    finally:
        dist.destroy_process_group()


def biases_before_batchnorm(model):
    """Names of the conv biases that feed a train-mode BatchNorm (the
    attention gates' ``W_g.0``, ``W_x.0`` and ``psi.0``): their gradient
    is 0 in exact arithmetic, and what a step computes is rounding noise,
    which differs with the order of the BatchNorm's sums."""
    from torch import nn

    return {f"{name}.0.bias" for name, m in model.named_modules()
            if isinstance(m, nn.Sequential) and len(m) > 1
            and isinstance(m[0], nn.Conv2d) and m[0].bias is not None
            and isinstance(m[1], nn.BatchNorm2d)}


def dp_two_ranks_step(torch, tmp):
    """(b) one fp32 step on two gloo ranks sharing the card against the
    same step in this process, and both against the step at float64."""
    from gan_aug_pfa_torch.config import SiameseTrainConfig

    run_ranks("dp_step_rank", [tmp])
    got = torch.load(os.path.join(tmp, "step.pt"), weights_only=True)
    with open(os.path.join(tmp, "spread.json")) as f:
        spread = json.load(f)
    os.remove(os.path.join(tmp, "step.pt"))
    steps = {}
    for dtype in (torch.float32, torch.float64):
        trainer, cache = dp_step_setup(torch, None)
        if dtype == torch.float64:
            trainer.model.double()
            cache = type(cache)(cache.img1.double(), cache.img2.double(),
                                cache.labels)
        loss = float(trainer.train_step(cache, torch.arange(4,
                                                            device="cuda")))
        steps[dtype] = (loss, {k: p.grad.float().cpu() for k, p in
                               trainer.model.named_parameters()},
                        {k: p.detach().cpu() for k, p in
                         trainer.model.named_parameters()})
    loss, grads, params = steps[torch.float32]
    exact = steps[torch.float64][1]
    zero = biases_before_batchnorm(trainer.model)
    big = max(float(g.abs().max()) for g in exact.values())

    def off(gs):  # largest distance from the float64 gradients, of max|g|
        return max(float((gs[k] - g).abs().max()) for k, g in exact.items()
                   if k not in zero) / big

    two, one = off(got["grads"]), off(grads)
    diffs = torch.cat([(got["params"][k] - p).abs().flatten()
                       for k, p in params.items()])
    share = float((diffs <= DP_PARAM_ATOL).double().mean())
    lr = SiameseTrainConfig().learning_rate
    rel = abs(got["loss"] - loss) / abs(loss)
    print(f"phase 18 (b): two gloo ranks on one card, fp32 step loss "
          f"{got['loss']:.8f} vs one process {loss:.8f} (rel {rel:.2e}); "
          f"gradients from the float64 step's, of its max|g| {big:.2e}: "
          f"two ranks {two:.2e}, one process {one:.2e} (biases before a "
          f"BatchNorm left out: {len(zero)}); parameters max|d| "
          f"{float(diffs.max()):.2e}, {share:.4%} within {DP_PARAM_ATOL}; "
          f"rank 1 vs rank 0 {spread}")
    if not (rel <= DP_STEP_RTOL and two <= DP_GRAD_FACTOR * one + 1e-6
            and float(diffs.max()) <= 2 * lr and share >= DP_PARAM_SHARE
            and spread == 0.0):
        raise AssertionError("two-rank step differs from one process")
    return {"loss_rel": rel, "grad_off_two_ranks": two,
            "grad_off_one_process": one, "param_share": share}


def dp_cli(torch, root, tmp, module, argv, name):
    """(c), (d): the CLI ``module`` on DP_WORLD ranks; returns both ranks'
    reports (``dp_cli_rank``)."""
    out = os.path.join(tmp, name)
    os.makedirs(out)
    t0 = time.time()
    run_ranks("dp_cli_rank", [out, module, "--root-dir", root, *argv])
    wall = time.time() - t0
    reports = []
    for rank in range(DP_WORLD):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            reports.append(json.load(f))
    print(f"phase 18 {name}: {DP_WORLD} ranks, {wall:.1f} s; "
          + "; ".join(f"rank {r}: {rep}" for r, rep in enumerate(reports)))
    if reports[1]["writes"] or not reports[0]["writes"]:
        raise AssertionError(f"{name}: files written {reports[0]['writes']}"
                             f" by rank 0, {reports[1]['writes']} by rank 1")
    if reports[0]["history"] != reports[1]["history"]:
        raise AssertionError(f"{name}: the ranks' losses differ")
    return reports


def phase_data_parallel(torch, root, reference):
    """Phase 18: data-parallel training on one card.  ``reference``: the
    single-process histories of phases 6 and 7 on the same tree.  Returns
    each CLI run's (calls, launches) by rank."""
    from gan_aug_pfa_torch.models import SiameseUNet, UNetGenerator

    t0 = time.time()
    write_oscd_tree(root)
    dp_nccl_one_rank(torch)
    tmp = os.path.join(root, "dp")
    os.makedirs(tmp)
    step = dp_two_ranks_step(torch, tmp)
    result = {"step": step, "cli": {}}
    # (c): 11 train pairs at batch 4: steps of 4 and 4 (2 rows a rank) and
    # a replicated 3; 3 val pairs, replicated.
    for name, flags, epochs, ref in (
            ("train", [], 2, reference["train"]),
            ("augment", ["--augment"], 1, reference["augment"])):
        ckpt_dir = f"dp_{name}_checkpoints"
        reports = dp_cli(torch, root, tmp, "gan_aug_pfa_torch.train.__main__",
                         ["--num-epochs", str(epochs), "--save-every", "2",
                          "--checkpoint-dir", ckpt_dir, *flags], name)
        steps = 3 * epochs
        want_loss = {"fwd": [steps + epochs] * 2, "bwd": [steps] * 2}
        want_photo = {"native": [2 * steps] * 2 if flags else [0, 0],
                      "flip": [0, 0]}
        history = reports[0]["history"]
        rel = [abs(a - b) / abs(b) for k in ("train_loss", "val_loss")
               for a, b in zip(history[k], ref[k][:epochs])]
        print(f"phase 18 (c) {name}: epoch losses {history} vs one process "
              f"{ {k: v[:epochs] for k, v in ref.items()} } (rel {rel})")
        for rank, rep in enumerate(reports):
            if rep["loss"] != want_loss or rep["photometric"] != want_photo:
                raise AssertionError(f"{name} rank {rank}: counts "
                                     f"{rep['loss']} {rep['photometric']}, "
                                     f"expected {want_loss} {want_photo}")
        if not all(r <= DP_LOSS_RTOL for r in rel) or len(rel) != 2 * epochs:
            raise AssertionError(f"{name}: two-rank losses differ from one "
                                 "process")
        model = SiameseUNet()
        for f in set(reports[0]["writes"]):
            if f != "last_state.pth":
                model.load_state_dict(torch.load(
                    os.path.join(root, ckpt_dir, f), weights_only=True),
                    strict=True)
        result["cli"][name] = [{"loss": r["loss"],
                                "photometric": r["photometric"]}
                               for r in reports]
    # (d): 14 pairs at batch 2, one a rank: 7 sharded D+G steps.
    reports = dp_cli(torch, root, tmp, "gan_aug_pfa_torch.train_gan",
                     ["--num-epochs", "1", "--batch-size", "2"], "gan")
    history = reports[0]["history"]
    if not np.isfinite(history["loss_d"] + history["loss_g"]).all():
        raise AssertionError(f"GAN losses {history}")
    UNetGenerator().load_state_dict(torch.load(
        os.path.join(root, "gan_checkpoints", "generator_epoch_1.pth"),
        weights_only=True), strict=True)
    strips = os.listdir(os.path.join(root, "gan_samples"))
    if len(strips) != 1:
        raise AssertionError(f"GAN strips {strips}")
    print(f"phase 18 (d): GAN epoch at batch 2 on {DP_WORLD} ranks, losses "
          f"{history}; generator_epoch_1.pth loads strictly; strips "
          f"{strips}")
    print(f"phase 18 (data parallel) took {time.time() - t0:.1f} s")
    return result


# -- phase 19: tuning over data-parallel sub-meshes ------------------------

SUB_WORLD, SUB_PARALLEL = 4, 2  # four gloo ranks on the one card: two
# partitions of two ranks, one trial at a time each
# One epoch a trial (the CLI's 15; two took the phase to 60 s alone).
SUB_TRIALS, SUB_EPOCHS = 2, 1
SUB_SIZE = 128
# A trial's first step on two ranks against one process, relative: the
# same weights, batch and draws, the sums (BatchNorm's, the loss's) in
# another order, at bf16.  Its first epoch is printed, not held to this:
# Adam's first steps, lr times the sign of each gradient, turn bf16
# rounding into lr-sized moves (the search space's lr reaches 5e-3, 50
# times the CLI's).  Two runs of the trial in one process under
# ``deterministic`` give equal bits: its first step and first epoch.
SUB_STEP_RTOL = DP_LOSS_RTOL


def first_step_losses(trainer_cls):
    """Record, by trial (the trainer's seed is the trial number), the loss
    of each trial's first train step: a dict filled while the returned
    undo callable has not been called."""
    seen, step = {}, trainer_cls.train_step

    def recorded(self, *args, **kwargs):
        loss = step(self, *args, **kwargs)
        if self.config.seed not in seen:
            seen[self.config.seed] = float(loss)
        return loss

    trainer_cls.train_step = recorded
    return seen, lambda: setattr(trainer_cls, "train_step", step)


def tune_sub_rank(out_dir, root, device="cuda", size=SUB_SIZE):
    """Phase 19 in a child: one rank of SUB_WORLD (gloo, every rank on the
    one card), ``tune.run_tuning`` on the group's ranks with
    ``--parallel-trials`` SUB_PARALLEL, the FocalDice and photometric
    (calls, launches) set to 0 just before and read just after; its
    partition, mesh, counts, trials and each trial's first step loss into
    ``out_dir/rank<R>.json``."""
    import torch
    import torch.distributed as dist

    from gan_aug_pfa_torch import tune
    from gan_aug_pfa_torch.config import DataConfig
    from gan_aug_pfa_torch.ops.kernels import photometric as ph
    from gan_aug_pfa_torch.ops.kernels.fused_loss import FocalDiceLossFn
    from gan_aug_pfa_torch.parallel.mesh import maybe_distributed_init

    if not maybe_distributed_init(device, tune.GROUP_TIMEOUT):
        raise AssertionError("no process group from the environment")
    first, _ = first_step_losses(tune.SiameseTrainer)
    try:
        reset_loss_counts(FocalDiceLossFn)
        reset_photometric_counts(ph)
        t0 = time.time()
        report = tune.run_tuning(
            DataConfig(root_dir=root, target_size=(int(size), int(size))),
            n_trials=SUB_TRIALS, trial_epochs=SUB_EPOCHS, verbose=False,
            storage="sqlite:///" + os.path.join(out_dir, "study.db"),
            n_parallel=SUB_PARALLEL, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        out = {"partition": report["partition"],
               "mesh": [report["mesh"].world_size, report["mesh"].rank,
                        str(report["mesh"].device), report["mesh"].backend],
               "seconds": time.time() - t0,
               "loss": loss_counts(FocalDiceLossFn),
               "photometric": photometric_counts(ph),
               "trials": report["trials"], "first_step": first}
    finally:
        dist.destroy_process_group()
    print(f"rank {os.environ['RANK']}: partition {out['partition']}, mesh "
          f"{out['mesh']}, {out['seconds']:.1f} s")
    with open(os.path.join(out_dir, f"rank{os.environ['RANK']}.json"),
              "w") as f:
        json.dump(out, f)
    return 0


def sub_expected_counts(trials, n_train, n_val):
    """A rank's kernel (calls, launches) of its partition's trials (its
    records): per epoch, ceil(n_train / batch) train steps of two native
    photometric calls, a loss forward and a backward on the rank's rows
    (or the whole batch, when it does not divide), and ceil(n_val / batch)
    validation forwards; one launch a call."""
    native = fwd = bwd = 0
    for t in trials:
        bs, epochs = t["params"]["batch_size"], len(t["val_loss"])
        steps = -(-n_train // bs)
        native += 2 * steps * epochs
        fwd += (steps + -(-n_val // bs)) * epochs
        bwd += steps * epochs
    return ({"native": [native, native], "flip": [0, 0]},
            {"fwd": [fwd, fwd], "bwd": [bwd, bwd]})


def phase_tuning_submesh(torch, root, device="cuda", size=SUB_SIZE):
    """Phase 19: a study of SUB_TRIALS trials, SUB_EPOCHS epochs each, at
    ``size`` (native augmentation, bf16, full width) over a 14-city tree,
    on SUB_WORLD gloo ranks sharing the card: two partitions of two ranks
    (``tune.tune_on_ranks``).  Checks the study's rows (numbers unique,
    COMPLETE or PRUNED), each rank's kernel counts against its trials, the
    two ranks of a partition against each other, each trial's first step
    against the same trial in this process (SUB_STEP_RTOL), and two runs of
    the trial in this process under ``deterministic`` against each other
    (first step and first epoch equal in bits); prints the ranks' first
    epoch against them.  Returns each
    rank's counts, the relative differences and the phase's seconds."""
    from gan_aug_pfa_torch import tune
    from gan_aug_pfa_torch.config import DataConfig
    from gan_aug_pfa_torch.data.scanner import create_sample_lists
    from gan_aug_pfa_torch.tuning import TrialState, load_study

    t0 = time.time()
    write_oscd_tree(root)
    out = os.path.join(root, "tune_submesh")
    os.makedirs(out)
    run_ranks("tune_sub_rank", [out, root, device, size], world=SUB_WORLD)
    reports = []
    for rank in range(SUB_WORLD):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            reports.append(json.load(f))
    trials = load_study(tune.STUDY_NAME, "sqlite:///" + os.path.join(
        out, "study.db")).trials
    n = {mode: len(create_sample_lists(root, SUBDIR, mode=mode,
                                       verbose=False))
         for mode in ("train", "val")}
    rows = [(t.number, t.state.value, t.params["batch_size"],
             len(t.intermediate_values)) for t in trials]
    ranks = [(r["partition"], r["mesh"], r["loss"], r["photometric"])
             for r in reports]
    print(f"phase 19: study (number, state, batch, epochs) {rows}; ranks "
          f"(partition, mesh, loss and photometric counts) {ranks}")
    if (sorted(t.number for t in trials) != list(range(SUB_TRIALS))
            or not {t.state for t in trials} <= {TrialState.COMPLETE,
                                                 TrialState.PRUNED}):
        raise AssertionError(f"phase 19 study rows: {trials}")
    for rank, rep in enumerate(reports):
        want = (rank // 2, [2, rank % 2])
        if (rep["partition"], rep["mesh"][:2]) != want:
            raise AssertionError(f"rank {rank}: partition {rep['partition']}"
                                 f", mesh {rep['mesh']}, expected {want}")
        want_photo, want_loss = sub_expected_counts(rep["trials"],
                                                    n["train"], n["val"])
        if rep["loss"] != want_loss or rep["photometric"] != want_photo:
            raise AssertionError(f"rank {rank}: counts {rep['loss']} "
                                 f"{rep['photometric']}, expected "
                                 f"{want_loss} {want_photo}")
        if rank % 2 and rep["trials"] != reports[rank - 1]["trials"]:
            raise AssertionError(f"rank {rank}'s trials differ from its "
                                 "partition's rank 0")
    data = DataConfig(root_dir=root, target_size=(size, size))
    datasets = tune.load_tuning_datasets(data, verbose=False)
    first, undo = first_step_losses(tune.SiameseTrainer)
    rel = {}
    try:
        for rep in reports[::2]:
            for t in rep["trials"]:
                ones = []
                for _ in range(2):  # the one-process run, and again
                    first.clear()
                    objective = tune.make_objective(
                        data, verbose=False, trial_epochs=1, device=device,
                        datasets=datasets)
                    with deterministic(torch):
                        objective(tune.SharedTrial(t["number"],
                                                   t["params"]))
                    ones.append([first[t["number"]]] + [
                        objective.trials[0][k][0]
                        for k in ("train_loss", "val_loss")])
                got = [rep["first_step"][str(t["number"])]] + [
                    t[k][0] for k in ("train_loss", "val_loss")]
                rel[t["number"]] = {
                    "lr": t["params"]["lr"],
                    "batch": t["params"]["batch_size"],
                    "ranks_vs_one": [abs(a - b) / abs(b)
                                     for a, b in zip(got, ones[0])],
                    "one_vs_one": [a - b for a, b in zip(ones[1],
                                                         ones[0])]}
    finally:
        undo()
    seconds = time.time() - t0
    print(f"phase 19: each trial's (first step, first epoch's train and "
          f"val) losses: two ranks vs one process, relative, and one "
          f"process vs itself under deterministic mode, the difference: "
          f"{rel}; ranks' own seconds "
          f"{[round(r['seconds'], 1) for r in reports]}")
    if sorted(rel) != list(range(SUB_TRIALS)) or max(
            v["ranks_vs_one"][0] for v in rel.values()) > SUB_STEP_RTOL:
        raise AssertionError("phase 19: a sub-mesh trial's first step "
                             "differs from the same step in one process")
    if any(d != 0 for v in rel.values() for d in v["one_vs_one"]):
        raise AssertionError("phase 19: a trial run twice in one process "
                             "under deterministic mode differs")
    print(f"phase 19 (tuning over sub-meshes) took {seconds:.1f} s")
    return {"loss": [r["loss"] for r in reports],
            "photometric": [r["photometric"] for r in reports],
            "rel": rel, "seconds": seconds}

# -- phase 20: the tensor-parallel 'model' axis -----------------------------

MA_WORLD, MA_SHAPE = 4, (2, 2)  # four gloo ranks on the card: (data, model)
MA_BATCH, MA_STEPS = 4, 3  # the Siamese defaults' batch, 2 rows a data rank
# A (data 2, model 2) step's loss against the (data 2) step on the same
# rows from the same weights: the first equal in bits, the later ones
# within this.  Under bf16 autocast torch casts each weight once a forward
# and adds the two encoder passes' weight gradients in bf16; a sharded
# conv casts at each call and adds them in float32, as flax does (ROADMAP
# §C16: 3.4e-5, then 2.3e-4 relative on the CPU); and on the card these
# steps run outside deterministic mode, where cuDNN may pick a bf16
# backward algorithm that adds with atomics (§C7).
MA_LOSS_RTOL = DP_LOSS_RTOL
MA_GAN_RTOL = DP_LOSS_RTOL  # one bf16 D+G step, (2, 2) against one process


def leaf_bytes(model, plan, m, names=None):
    """(exact bytes, the most the CUDA caching allocator may count for
    them) of ``model``'s leaves (``names``: those only) as a rank of a
    'model' extent ``m`` holds them under ``plan``.  The allocator rounds
    a block up to 512 bytes and keeps a remainder of up to 1 MiB of a
    larger block's segment in the block."""
    exact = most = 0
    for k, t in model.state_dict().items():
        if names is not None and k not in names:
            continue
        n = t.numel() * t.element_size() // (m if k in plan else 1)
        exact += n
        most += -(-max(n, 1) // 512) * 512 + ((1 << 20) if n > 1 << 20
                                               else 0)
    return exact, most


def own_bytes(tensors):
    """The bytes of ``tensors`` themselves."""
    return sum(t.numel() * t.element_size() for t in tensors)


def model_axis_rank(out_dir, root, device="cuda"):
    """Phase 20 in a child: one rank of MA_WORLD (gloo, every rank on the
    one card).  MA_STEPS ``--augment`` steps (native chain, bf16, full
    width, batch MA_BATCH from the seed) on the (data 2, model 2) mesh,
    then on the (data 2) mesh of its pair of ranks ({0, 1} or {2, 3}),
    each with the FocalDice and photometric (calls, launches) set to 0
    just before and read just after, its parameter and optimizer-state
    bytes (``torch.cuda.memory_allocated`` deltas) and each step's peak;
    the (2, 2) train state saved whole (rank 0) and each rank's own
    blocks; one GAN step at 256x256, batch 1, on the (2, 2) mesh (rank 0:
    also in one process).  Into ``out_dir/rank<R>.json``."""
    import gc

    import torch
    import torch.distributed as dist

    from gan_aug_pfa_torch import checkpoint as ckpt
    from gan_aug_pfa_torch.config import GANTrainConfig, SiameseTrainConfig
    from gan_aug_pfa_torch.data.loader import (
        build_cached_dataset,
        build_padded_native_dataset,
    )
    from gan_aug_pfa_torch.data.scanner import create_sample_lists
    from gan_aug_pfa_torch.ops.kernels import photometric as ph
    from gan_aug_pfa_torch.ops.kernels.fused_loss import FocalDiceLossFn
    from gan_aug_pfa_torch.parallel import mesh as pm
    from gan_aug_pfa_torch.pipelines import DeviceCache, NativeDeviceCache
    from gan_aug_pfa_torch.train import plateau
    from gan_aug_pfa_torch.train.gan import GANTrainer
    from gan_aug_pfa_torch.train.siamese import SiameseTrainer

    t0 = time.time()
    if not pm.maybe_distributed_init(device):
        raise AssertionError("no process group from the environment")
    cuda = device == "cuda"

    def allocated():
        if not cuda:
            return 0
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    try:
        rank = dist.get_rank()
        mesh = pm.make_mesh(MA_WORLD, ("data", "model"), MA_SHAPE,
                            device=device)
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        data = pm.DataMesh(2, rank % 2, mesh.device, mesh.backend,
                           group=pairs[rank // 2])
        dev = mesh.device
        samples = create_sample_lists(root, SUBDIR, mode="all",
                                      verbose=False)
        cache = NativeDeviceCache.from_dataset(build_padded_native_dataset(
            samples, verbose=False), dev)
        perm = np.random.RandomState(SEED).permutation(len(samples))
        batches = [torch.from_numpy(perm[i * MA_BATCH:(i + 1) * MA_BATCH])
                   .to(dev) for i in range(MA_STEPS)]
        seconds = {"setup": time.time() - t0}
        t0 = time.time()
        out = {"mesh": [mesh.world_size, mesh.rank, mesh.model_size,
                        mesh.model_rank, str(dev), mesh.backend],
               "runs": {}, "seconds": seconds}
        for name, m in (("model", mesh), ("data", data)):
            base = allocated()
            trainer = SiameseTrainer(SiameseTrainConfig(
                batch_size=MA_BATCH, seed=SEED), device, augment=True,
                native_out_size=(SUB_SIZE, SUB_SIZE), mesh=m)
            model = trainer.model
            run = {"param_bytes": allocated() - base, "opt_bytes": None,
                   "param_own": own_bytes(list(model.parameters())
                                          + list(model.buffers())),
                   "loss": [], "peak": []}
            step, opt = trainer.optimizer.step, trainer.optimizer

            def measured_step(*args, step=step, run=run, opt=opt, **kwargs):
                before = allocated()
                result = step(*args, **kwargs)
                if run["opt_bytes"] is None:  # the moments, made lazily
                    run["opt_bytes"] = allocated() - before
                    run["opt_own"] = own_bytes(
                        t for st in opt.state.values() for t in st.values()
                        if torch.is_tensor(t) and t.device == dev)
                return result

            trainer.optimizer.step = measured_step
            reset_loss_counts(FocalDiceLossFn)
            reset_photometric_counts(ph)
            for idx in batches:
                if cuda:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                run["loss"].append(float(trainer.train_step(cache, idx)))
                run["peak"].append(torch.cuda.max_memory_allocated()
                                   if cuda else 0)
            run["loss_counts"] = loss_counts(FocalDiceLossFn)
            run["photometric"] = photometric_counts(ph)
            if name == "model":
                sched = plateau.make_plateau_scheduler(trainer.optimizer)
                payload = ckpt.train_state(
                    trainer.model, trainer.optimizer, sched,
                    plateau.EarlyStopping(3), 1, run["loss"][-1])
                if rank == 0:
                    ckpt.save(os.path.join(out_dir, "state22.pth"), payload)
                del payload
                ckpt.save(os.path.join(out_dir, f"local{rank}.pth"), {
                    "model": trainer.model.state_dict(),
                    "optimizer": trainer.optimizer.state_dict()})
            out["runs"][name] = run
            seconds[name] = time.time() - t0
            t0 = time.time()
            del trainer, step, opt, model
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        gan_cache = DeviceCache.from_dataset(build_cached_dataset(
            samples[:1], (256, 256), verbose=False), dev)
        idx = torch.zeros(1, dtype=torch.int64, device=dev)
        cfg = GANTrainConfig(seed=SEED)
        out["gan"] = [float(v) for v in GANTrainer(cfg, device, mesh=mesh)
                      .train_step(gan_cache, idx)]
        seconds["gan"] = time.time() - t0
        if rank == 0:
            out["gan_one"] = [float(v) for v in GANTrainer(cfg, device)
                              .train_step(gan_cache, idx)]
        seconds["gan_one"] = time.time() - t0 - seconds["gan"]
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def phase_model_axis(torch, root, device="cuda"):
    """Phase 20: the tensor-parallel 'model' axis on MA_WORLD gloo ranks
    sharing the card, (data 2, model 2) (``model_axis_rank``).  Checks
    each rank's place on the mesh, each step's loss against the (data 2)
    run's (MA_LOSS_RTOL), the FocalDice (calls, launches) against the
    steps and the native photometric count against the (data 2) run's,
    the parameter and optimizer-state bytes against the rule's
    prediction, the GAN step against one process (MA_GAN_RTOL), and the
    (2, 2) train state restored in this process bit for bit, each rank's
    blocks its own.  Prints each rank's peaks against the (data 2) rank's.
    Returns each rank's counts and the phase's seconds."""
    from gan_aug_pfa_torch import checkpoint as ckpt
    from gan_aug_pfa_torch.config import SiameseTrainConfig
    from gan_aug_pfa_torch.models import SiameseUNet
    from gan_aug_pfa_torch.parallel import tensor as tp
    from gan_aug_pfa_torch.train import plateau
    from gan_aug_pfa_torch.train.siamese import SiameseTrainer

    t0 = time.time()
    card = card_name()
    write_oscd_tree(root)
    out = os.path.join(root, "model_axis")
    os.makedirs(out)
    run_ranks("model_axis_rank", [out, root, device], world=MA_WORLD)
    reports = []
    for rank in range(MA_WORLD):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            reports.append(json.load(f))
    full = SiameseUNet()
    plan = tp.shard_plan(full, MA_SHAPE[1])
    params = dict(full.named_parameters())
    want_bytes = {
        "model": (leaf_bytes(full, plan, MA_SHAPE[1]),
                  [2 * b for b in leaf_bytes(full, plan, MA_SHAPE[1],
                                             params)]),
        "data": (leaf_bytes(full, {}, 1),
                 [2 * b for b in leaf_bytes(full, {}, 1, params)])}
    want_loss = {"fwd": [MA_STEPS] * 2, "bwd": [MA_STEPS] * 2}
    failures = []
    for rank, rep in enumerate(reports):
        model, data = rep["runs"]["model"], rep["runs"]["data"]
        rel = [abs(a - b) / abs(b) for a, b in zip(model["loss"],
                                                   data["loss"])]
        same = model["loss"] == data["loss"]
        print(f"phase 20 rank {rank} ({card}): mesh {rep['mesh']}; step "
              f"losses (2, 2) {model['loss']} vs (data 2) {data['loss']}: "
              + ("equal in bits" if same else
                 f"rel {rel} (not bit-equal after step 1: autocast's cached "
                 "bf16 weights add the encoder passes' gradients in bf16, a "
                 "sharded conv in float32, ROADMAP §C16; cuDNN's bf16 "
                 "backward outside deterministic mode, §C7)"))
        for name, run in (("model", model), ("data", data)):
            (p_exact, p_most), (o_exact, o_most) = want_bytes[name]
            print(f"phase 20 rank {rank} {name} run ({card}): parameter "
                  f"and buffer bytes {run['param_own']} (rule {p_exact}), "
                  f"memory_allocated delta {run['param_bytes']} (at most "
                  f"{p_most}); Adam moments {run.get('opt_own')} bytes "
                  f"(rule {o_exact}), delta {run['opt_bytes']} (at most "
                  f"{o_most}); step peaks {run['peak']}; counts "
                  f"{run['loss_counts']} {run['photometric']}")
            if (run["param_own"] != p_exact
                    or device == "cuda" and not (
                        run["opt_own"] == o_exact
                        and p_exact <= run["param_bytes"] <= p_most
                        and o_exact <= run["opt_bytes"] <= o_most)):
                failures.append(f"rank {rank} {name}: bytes")
        print(f"phase 20 rank {rank} ({card}): step peak (2, 2) "
              f"{max(model['peak'])} vs (data 2) {max(data['peak'])} "
              f"bytes ({max(model['peak']) / max(1, max(data['peak'])):.3f}"
              "x)")
        if (rep["mesh"][:4] != [2, rank // 2, 2, rank % 2]
                or rel[0] != 0.0 and device != "cuda"
                or max(rel) > MA_LOSS_RTOL):
            failures.append(f"rank {rank}: mesh {rep['mesh']}, rel {rel}")
        for name, run in (("model", model), ("data", data)):
            if (run["loss_counts"] != want_loss
                    or run["photometric"]["flip"] != [0, 0]
                    or run["photometric"]["native"]
                    != data["photometric"]["native"]
                    or run["photometric"]["native"][0] == 0):
                failures.append(f"rank {rank} {name}: counts "
                                f"{run['loss_counts']} {run['photometric']}")
    gan, one = reports[0]["gan"], reports[0]["gan_one"]
    gan_rel = [abs(a - b) / abs(b) for a, b in zip(gan, one)]
    print(f"phase 20 GAN step at 256x256, batch 1 ({card}): (loss_D, "
          f"loss_G) on (2, 2) by rank {[r['gan'] for r in reports]}, one "
          f"process {one} (rel {gan_rel})")
    if max(gan_rel) > MA_GAN_RTOL:
        failures.append(f"GAN rel {gan_rel}")
    # The (2, 2) state, restored in this process: bit for bit, and each
    # rank's own blocks are the blocks of it.
    path = os.path.join(out, "state22.pth")
    saved = torch.load(path, weights_only=True)
    trainer = SiameseTrainer(SiameseTrainConfig(batch_size=MA_BATCH,
                                                seed=SEED), device)
    sched, stopper = (plateau.make_plateau_scheduler(trainer.optimizer),
                      plateau.EarlyStopping(3))
    info = ckpt.restore_train_state(path, trainer.model, trainer.optimizer,
                                    sched, stopper)
    again = ckpt.train_state(trainer.model, trainer.optimizer, sched,
                             stopper, info["epoch"], info["best_val_loss"])
    mismatch = [compare_nested(torch, ckpt._map(again, lambda t: t.cpu()),
                               saved)]
    names = [k for k, _ in trainer.model.named_parameters()]
    for rank in range(MA_WORLD):
        local = torch.load(os.path.join(out, f"local{rank}.pth"),
                           weights_only=True)
        k_rank = rank % MA_SHAPE[1]

        def block(key, t):
            if key not in plan:
                return t
            n = t.shape[plan[key]] // MA_SHAPE[1]
            return t.narrow(plan[key], k_rank * n, n)

        want = {"model": {k: block(k, v) for k, v in saved["model"].items()},
                "optimizer": {i: {k: block(names[i], v) if v.dim() else v
                                  for k, v in st.items()}
                              for i, st in saved["optimizer"]["state"]
                              .items()}}
        mismatch.append(compare_nested(torch, {
            "model": local["model"],
            "optimizer": local["optimizer"]["state"]}, want,
            f"rank {rank} "))
    mismatch = [m for m in mismatch if m]
    print(f"phase 20 checkpoint ({card}): the (2, 2) state "
          f"({os.path.getsize(path)} bytes) restored in one process: "
          f"{'bit for bit' if not mismatch else mismatch[:5]}; each rank's "
          "blocks its own")
    if mismatch:
        failures.append(f"checkpoint: {mismatch[:5]}")
    seconds = time.time() - t0
    print(f"phase 20: each rank's seconds {[r['seconds'] for r in reports]}")
    print(f"phase 20 (the 'model' axis) took {seconds:.1f} s")
    if failures:
        raise AssertionError(f"phase 20: {failures}")
    return {"loss": [r["runs"]["model"]["loss_counts"] for r in reports],
            "photometric": [r["runs"]["model"]["photometric"]["native"]
                            for r in reports],
            "seconds": seconds}


# -- phase 21: the 'spatial' axis -------------------------------------------

SP_WORLD, SP_SHAPE = 4, (2, 2)  # four gloo ranks on the card: (data, spatial)
SP_GAN_SHAPE = (1, 4)  # the GAN at the reference's batch of 1: height only
# Steps on height blocks against the (data 2) mesh's and one process's: the
# same function, the sums in another order (the halo'd convs' and the
# BatchNorm and loss sums over data x spatial).  Under bf16 autocast every
# conv rounds its output to bf16 (8 bits) on other shapes, so even the first
# step's loss differs by more than TRAIN_STEP1_RTOL (8.3e-5 on an H100), and
# on the card these steps run outside deterministic mode, where cuDNN may
# pick a bf16 backward algorithm that adds with atomics (ROADMAP §C7): the
# bf16 steps are held at SP_LOSS_RTOL, and the first step at float32 (TF32
# off) at TRAIN_STEP1_RTOL (ROADMAP §C20).
SP_LOSS_RTOL = DP_LOSS_RTOL
SP_GAN_RTOL = DP_LOSS_RTOL
# The knobs that change a conv's form, under the axis: the Siamese steps
# again with both of these, the GAN step with its own.
SP_KNOBS = {"concat_free": True, "remat": True}
SP_GAN_KNOBS = {"concat_free_disc": True}
# (the split run, the run it is held against): plain, then with SP_KNOBS.
SP_PAIRS = (("spatial", "data"), ("spatial_knobs", "data_knobs"))


def spatial_axis_rank(out_dir, root, device="cuda"):
    """Phase 21 in a child: one rank of SP_WORLD (gloo, every rank on the
    one card).  MA_STEPS ``--augment`` steps (native chain, bf16, full
    width, batch MA_BATCH from the seed) on the (data 2) mesh of the ranks
    that share its spatial index (first: it takes the process's first-use
    costs), then on the (data 2, spatial 2) mesh, each with the FocalDice
    and photometric (calls, launches) set to 0 just before and read just
    after, each step's peak and seconds; then both again with SP_KNOBS;
    then the first step of each of the four runs again at float32 (TF32
    off).  One GAN step at 256x256, batch 1, on (data 1, spatial 4) with
    its peak, and at float32, each without and with SP_GAN_KNOBS (rank 0:
    all four also in one process).  Into ``out_dir/rank<R>.json``."""
    import gc

    import torch
    import torch.distributed as dist

    from gan_aug_pfa_torch.config import GANTrainConfig, SiameseTrainConfig
    from gan_aug_pfa_torch.data.loader import (
        build_cached_dataset,
        build_padded_native_dataset,
    )
    from gan_aug_pfa_torch.data.scanner import create_sample_lists
    from gan_aug_pfa_torch.ops.kernels import photometric as ph
    from gan_aug_pfa_torch.ops.kernels.fused_loss import FocalDiceLossFn
    from gan_aug_pfa_torch.parallel import mesh as pm
    from gan_aug_pfa_torch.pipelines import DeviceCache, NativeDeviceCache
    from gan_aug_pfa_torch.train.gan import GANTrainer
    from gan_aug_pfa_torch.train.siamese import SiameseTrainer

    t0 = time.time()
    if not pm.maybe_distributed_init(device):
        raise AssertionError("no process group from the environment")
    cuda = device == "cuda"

    def peak_of(fn):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        result = fn()
        if cuda:
            torch.cuda.synchronize()
        return result, torch.cuda.max_memory_allocated() if cuda else 0

    try:
        rank = dist.get_rank()
        mesh = pm.make_mesh(SP_WORLD, ("data", "spatial"), SP_SHAPE,
                            device=device)
        gan_mesh = pm.make_mesh(SP_WORLD, ("data", "spatial"), SP_GAN_SHAPE,
                                device=device)
        data = dataclasses.replace(mesh, spatial_size=1, spatial_rank=0,
                                   spatial_group=None,
                                   data_spatial_group=None)
        dev = mesh.device
        samples = create_sample_lists(root, SUBDIR, mode="all",
                                      verbose=False)
        cache = NativeDeviceCache.from_dataset(build_padded_native_dataset(
            samples, verbose=False), dev)
        perm = np.random.RandomState(SEED).permutation(len(samples))
        batches = [torch.from_numpy(perm[i * MA_BATCH:(i + 1) * MA_BATCH])
                   .to(dev) for i in range(MA_STEPS)]
        seconds = {"setup": time.time() - t0}
        t0 = time.time()
        out = {"mesh": [mesh.world_size, mesh.rank, mesh.spatial_size,
                        mesh.spatial_rank, str(dev), mesh.backend],
               "gan_mesh": [gan_mesh.world_size, gan_mesh.spatial_size,
                            gan_mesh.spatial_rank],
               "runs": {}, "seconds": seconds}
        def release():
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()

        def siamese(m, dtype, knobs):
            return SiameseTrainer(SiameseTrainConfig(
                batch_size=MA_BATCH, seed=SEED, compute_dtype=dtype,
                **knobs), device, augment=True,
                native_out_size=(SUB_SIZE, SUB_SIZE), mesh=m)

        runs = (("data", data, {}), ("spatial", mesh, {}),
                ("data_knobs", data, SP_KNOBS),
                ("spatial_knobs", mesh, SP_KNOBS))
        for name, m, knobs in runs:
            trainer = siamese(m, "bfloat16", knobs)
            run = {"loss": [], "peak": [], "seconds": []}
            reset_loss_counts(FocalDiceLossFn)
            reset_photometric_counts(ph)
            for idx in batches:
                t1 = time.time()
                loss, peak = peak_of(
                    lambda idx=idx: float(trainer.train_step(cache, idx)))
                run["loss"].append(loss)
                run["peak"].append(peak)
                run["seconds"].append(time.time() - t1)
            run["loss_counts"] = loss_counts(FocalDiceLossFn)
            run["photometric"] = photometric_counts(ph)
            out["runs"][name] = run
            seconds[name] = time.time() - t0
            t0 = time.time()
            del trainer
            release()
        for name, m, knobs in runs:
            trainer = siamese(m, "float32", knobs)
            out["runs"][name]["fp32_step1"] = float(trainer.train_step(
                cache, batches[0]))
            del trainer
            release()
        seconds["fp32"] = time.time() - t0
        t0 = time.time()
        del cache
        gan_cache = DeviceCache.from_dataset(build_cached_dataset(
            samples[:1], (256, 256), verbose=False), dev)
        idx = torch.zeros(1, dtype=torch.int64, device=dev)

        def gan_step(m, dtype, knobs):
            trainer = GANTrainer(GANTrainConfig(seed=SEED,
                                                compute_dtype=dtype,
                                                **knobs),
                                 device, mesh=m)
            losses, peak = peak_of(lambda: trainer.train_step(gan_cache, idx))
            del trainer
            release()
            return [float(v) for v in losses], peak

        gans = (("gan", {}), ("gan_cfd", SP_GAN_KNOBS))
        for name, knobs in gans:
            out[name], out[f"{name}_peak"] = gan_step(gan_mesh, "bfloat16",
                                                      knobs)
            out[f"{name}32"] = gan_step(gan_mesh, "float32", knobs)[0]
        seconds["gan"] = time.time() - t0
        t0 = time.time()
        if rank == 0:
            for name, knobs in gans:
                out[f"{name}_one"], out[f"{name}_one_peak"] = gan_step(
                    None, "bfloat16", knobs)
                out[f"{name}_one32"] = gan_step(None, "float32", knobs)[0]
        seconds["gan_one"] = time.time() - t0
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def phase_spatial_axis(torch, root, device="cuda"):
    """Phase 21: the 'spatial' axis on SP_WORLD gloo ranks sharing the
    card (``spatial_axis_rank``).  Checks each rank's place on both
    meshes; for the plain steps and those with SP_KNOBS (SP_PAIRS), each
    bf16 Siamese step's loss on (data 2, spatial 2) against the (data 2)
    run's (SP_LOSS_RTOL) and the float32 first step's
    (TRAIN_STEP1_RTOL), the FocalDice (calls, launches) against the steps
    and the native photometric count against the (data 2) run's; each
    rank's plain step peak below the (data 2) rank's; and the GAN step on
    (data 1, spatial 4), without and with SP_GAN_KNOBS, against one
    process (bf16: SP_GAN_RTOL; float32: TRAIN_STEP1_RTOL).  Prints each
    rank's peaks against the (data 2) rank's, the SP_KNOBS step's against
    the plain (2, 2) step's, and the GAN's against one process's.  Returns
    each rank's counts of both split runs, the peaks and the phase's
    seconds."""
    t0 = time.time()
    card = card_name()
    write_oscd_tree(root)
    out = os.path.join(root, "spatial_axis")
    os.makedirs(out)
    run_ranks("spatial_axis_rank", [out, root, device], world=SP_WORLD)
    reports = []
    for rank in range(SP_WORLD):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            reports.append(json.load(f))
    want_loss = {"fwd": [MA_STEPS] * 2, "bwd": [MA_STEPS] * 2}
    failures = []
    for rank, rep in enumerate(reports):
        if (rep["mesh"][:4] != [2, rank // 2, 2, rank % 2]
                or rep["gan_mesh"] != [1, 4, rank]):
            failures.append(f"rank {rank}: mesh {rep['mesh']}, GAN mesh "
                            f"{rep['gan_mesh']}")
        for split_name, data_name in SP_PAIRS:
            split, data = rep["runs"][split_name], rep["runs"][data_name]
            rel = [abs(a - b) / abs(b) for a, b in zip(split["loss"],
                                                       data["loss"])]
            rel32 = (abs(split["fp32_step1"] - data["fp32_step1"])
                     / abs(data["fp32_step1"]))
            ratio = max(split["peak"]) / max(1, max(data["peak"]))
            print(f"phase 21 rank {rank} {split_name} ({card}): mesh "
                  f"{rep['mesh']}, GAN mesh {rep['gan_mesh']}; bf16 step "
                  f"losses (2, 2) {split['loss']} vs (data 2) "
                  f"{data['loss']}: rel {rel}; float32 first step "
                  f"{split['fp32_step1']} vs {data['fp32_step1']}: rel "
                  f"{rel32}; step seconds (2, 2) {split['seconds']} vs "
                  f"(data 2) {data['seconds']}; step peaks (2, 2) "
                  f"{split['peak']} vs (data 2) {data['peak']} bytes "
                  f"({ratio:.3f}x); counts {split['loss_counts']} "
                  f"{split['photometric']} vs {data['loss_counts']} "
                  f"{data['photometric']}")
            if (max(rel) > SP_LOSS_RTOL or rel32 > TRAIN_STEP1_RTOL
                    or device == "cuda" and split_name == "spatial"
                    and ratio >= 1.0):
                failures.append(f"rank {rank} {split_name}: rel {rel}, "
                                f"float32 rel {rel32}, peak ratio {ratio}")
            for name, run in ((split_name, split), (data_name, data)):
                if (run["loss_counts"] != want_loss
                        or run["photometric"]["flip"] != [0, 0]
                        or run["photometric"]["native"]
                        != data["photometric"]["native"]
                        or run["photometric"]["native"][0] == 0):
                    failures.append(f"rank {rank} {name}: counts "
                                    f"{run['loss_counts']} "
                                    f"{run['photometric']}")
        knob_peak = max(rep["runs"]["spatial_knobs"]["peak"])
        plain_peak = max(rep["runs"]["spatial"]["peak"])
        print(f"phase 21 rank {rank} ({card}): the (2, 2) step peak with "
              f"--concat-free --remat {knob_peak} against the plain "
              f"(2, 2) step's {plain_peak} bytes "
              f"({knob_peak / max(1, plain_peak):.3f}x)")
    for name, flags in (("gan", ""), ("gan_cfd", " --concat-free-disc")):
        gans = [r[name] for r in reports]
        one = reports[0][f"{name}_one"]
        gan_rel = [abs(a - b) / abs(b) for a, b in zip(gans[0], one)]
        gans32 = [r[f"{name}32"] for r in reports]
        gan_rel32 = [abs(a - b) / abs(b) for a, b in
                     zip(gans32[0], reports[0][f"{name}_one32"])]
        one_peak = reports[0][f"{name}_one_peak"]
        gan_ratio = [r[f"{name}_peak"] / max(1, one_peak) for r in reports]
        print(f"phase 21 GAN step{flags} at 256x256, batch 1 ({card}): "
              f"(loss_D, loss_G) on (1, 4) by rank {gans}, one process "
              f"{one} (rel {gan_rel}); float32 {gans32[0]} vs "
              f"{reports[0][f'{name}_one32']} (rel {gan_rel32}); step "
              f"peaks {[r[f'{name}_peak'] for r in reports]} vs one "
              f"process {one_peak} bytes "
              f"({', '.join(f'{x:.3f}' for x in gan_ratio)}x)")
        if (max(gan_rel) > SP_GAN_RTOL or max(gan_rel32) > TRAIN_STEP1_RTOL
                or any(g != gans[0] for g in gans)
                or any(g != gans32[0] for g in gans32)):
            failures.append(f"{name} rel {gan_rel}, float32 rel "
                            f"{gan_rel32}, by rank {gans} {gans32}")
    seconds = time.time() - t0
    print(f"phase 21: each rank's seconds {[r['seconds'] for r in reports]}")
    print(f"phase 21 (the 'spatial' axis) took {seconds:.1f} s")
    if failures:
        raise AssertionError(f"phase 21: {failures}")
    result = {run: {"loss": [r["runs"][run]["loss_counts"]
                             for r in reports],
                    "photometric": [r["runs"][run]["photometric"]["native"]
                                    for r in reports]}
              for run in ("spatial", "spatial_knobs")}
    result["peaks"] = {
        "siamese": [[max(r["runs"][n]["peak"]) for n in
                     ("spatial", "data", "spatial_knobs", "data_knobs")]
                    for r in reports],
        "gan": [[r["gan_peak"], r["gan_cfd_peak"]] for r in reports],
        "gan_one": [reports[0]["gan_one_peak"],
                    reports[0]["gan_cfd_one_peak"]]}
    result["seconds"] = seconds
    return result


# -- phase 22: deterministic train steps -------------------------------------

# The train steps that phase 22 runs twice from one state under
# ``deterministic``: the Siamese net at the defaults (128x128, batch 4,
# bf16, full width), plain and with the model knobs, DET_STEPS steps each;
# the GAN at its defaults (256x256, batch 1, bf16, full width), one D+G
# step.  Each pair must give equal bits.
DET_SIAMESE_FORMS = {
    "plain": {},
    "batched_encoder_concat_free_remat": dict(
        batched_encoder=True, concat_free=True, remat=True)}
DET_STEPS = 2


def state_bits(module):
    """Every parameter and buffer of ``module``, cloned."""
    return [t.detach().clone() for t in (*module.parameters(),
                                         *module.buffers())]


def phase_determinism(torch, device="cuda"):
    """Phase 22: under ``deterministic``, DET_STEPS bf16 Siamese train
    steps of each DET_SIAMESE_FORMS form from one seeded state, run twice,
    give equal losses, parameters and buffers in bits, and one bf16 GAN
    D+G step likewise; no op raises.  Returns its seconds."""
    from gan_aug_pfa_torch.config import GANTrainConfig, SiameseTrainConfig
    from gan_aug_pfa_torch.train.gan import GANTrainer
    from gan_aug_pfa_torch.train.siamese import SiameseTrainer

    t0 = time.time()
    rng = np.random.RandomState(SEED + 22)
    siamese = [torch.from_numpy(rng.rand(4, 3, 128, 128).astype(
        np.float32)).to(device) for _ in range(2)]
    labels = torch.from_numpy((rng.rand(4, 128, 128) > 0.8).astype(
        np.float32)).to(device)
    pair = [torch.from_numpy(rng.rand(1, 3, 256, 256).astype(
        np.float32)).to(device) for _ in range(2)]
    runs = {}
    with deterministic(torch):
        for name, knobs in DET_SIAMESE_FORMS.items():
            runs[name] = []
            for _ in range(2):
                trainer = SiameseTrainer(SiameseTrainConfig(**knobs), device)
                losses = torch.stack([trainer.train_batch(*siamese, labels)
                                      for _ in range(DET_STEPS)])
                runs[name].append((losses, state_bits(trainer.model)))
                del trainer
        runs["gan"] = []
        for _ in range(2):
            trainer = GANTrainer(GANTrainConfig(), device)
            losses = torch.stack(trainer.train_batch(*pair))
            runs["gan"].append((losses, state_bits(trainer.generator)
                                + state_bits(trainer.discriminator)))
            del trainer
    failed = []
    for name, ((la, sa), (lb, sb)) in runs.items():
        equal = torch.equal(la, lb) and all(torch.equal(a, b)
                                            for a, b in zip(sa, sb))
        worst = max(float((a.double() - b.double()).abs().max())
                    for a, b in zip(sa, sb))
        print(f"phase 22 {name}: losses {la.tolist()} and {lb.tolist()}; "
              f"{len(sa)} parameters and buffers, max|d| {worst!r}: equal "
              f"bits {equal}")
        if not equal:
            failed.append(name)
    if failed:
        raise AssertionError(f"phase 22: two runs of {failed} from one "
                             "state differ under deterministic mode")
    seconds = time.time() - t0
    print(f"phase 22 (deterministic steps) took {seconds:.1f} s")
    return seconds


@functools.lru_cache(maxsize=None)
def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main():
    # Before the first CUDA call, so that deterministic mode may call cuBLAS
    # (CUBLAS_WORKSPACE); children inherit it.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    from gan_aug_pfa_torch.data import native_loader as nl
    from gan_aug_pfa_torch.data.loader import (
        build_cached_dataset,
        build_padded_native_dataset,
    )
    from gan_aug_pfa_torch.data.scanner import create_sample_lists
    from gan_aug_pfa_torch.models import SiameseUNet
    from gan_aug_pfa_torch.ops.kernels import build
    from gan_aug_pfa_torch.ops.kernels import confusion_counts as cc
    from gan_aug_pfa_torch.ops.kernels import fused_loss as fl
    from gan_aug_pfa_torch.ops.kernels import photometric as ph
    from gan_aug_pfa_torch.train.siamese import predict

    smi = card_name()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.time()
    logs = build.build([cc.NAME, fl.NAME, ph.NAME, nl.NAME])
    print(f"kernel build (with the host C decoder {nl.NAME}, all at once): "
          f"{time.time() - t0:.1f} s ({', '.join(logs) or 'already built'})")
    for name, log in logs.items():
        if log.strip():
            print(f"nvcc {name}:\n{log.strip()}")

    t_start = last = time.time()

    def stamp(label):
        nonlocal last
        now = time.time()
        print(f"[{label} took {now - last:.1f} s; {now - t_start:.1f} s in all]")
        last = now

    max_err, timings = phase_kernel(torch, cc)
    loss_errs, loss_t = phase_loss_kernel(torch, fl)
    phase_model(torch, SiameseUNet, predict)
    stamp("phases 1-4")
    with tempfile.TemporaryDirectory() as root:
        launches = phase_main_path(torch, root)
        stamp("phase 5")
    with tempfile.TemporaryDirectory() as root:
        train_counts = phase_training(torch, root)
        train_ds = build_cached_dataset(
            create_sample_lists(root, "Onera Satellite Change Detection "
                                "Dataset", mode="train", verbose=False),
            (128, 128), verbose=False)
    phase_train_card_vs_cpu(torch, train_ds)
    train_throughput(torch, train_ds)
    with tempfile.TemporaryDirectory() as root:
        aug_runs = phase_aug_training(torch, root)
        native_ds = build_padded_native_dataset(
            create_sample_lists(root, "Onera Satellite Change Detection "
                                "Dataset", mode="train", verbose=False),
            verbose=False)
    phase_aug_card_vs_cpu(torch, native_ds, train_ds)
    aug_throughput(torch, native_ds)
    stamp("phases 6-7")
    native_shape = (4, 3, *native_ds.img1.shape[1:3])
    photo_errs, photo_t = phase_photometric(
        torch, ph, native_shape, native_ds.sizes[:4].tolist())
    stamp("phase 8")
    phase_determinism(torch)
    stamp("phase 22")
    with tempfile.TemporaryDirectory() as root:
        phase_gan(torch, root)
        gan_ds = build_cached_dataset(
            create_sample_lists(root, SUBDIR, mode="all", verbose=False),
            (256, 256), verbose=False)
        phase_gan_card_vs_cpu(torch, gan_ds)
        gan_throughput(torch, gan_ds)
        phase_synthesis(torch, root)
        phase_loop(torch, root)
        stamp("phases 9-10")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        run_control = phase_run_control(torch, root)
    phase_run_control_in_process(torch, train_ds)
    stamp("phase 11")
    with tempfile.TemporaryDirectory() as root:
        phase_jax_checkpoint(torch, root)
        stamp("phase 12")
    with tempfile.TemporaryDirectory() as root:
        eval_extras = phase_eval_extras(torch, root)
        stamp("phase 13")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        tuning = phase_tuning(torch, root)
        tuning_ds = build_padded_native_dataset(
            create_sample_lists(root, SUBDIR, mode="train", verbose=False),
            verbose=False)
    tuning_errs = phase_tuning_kernels(torch, fl, ph, tuning, tuning_ds)
    stamp("phase 14")
    with tempfile.TemporaryDirectory() as root:
        phase_gan_resume(torch, root)
        stamp("phase 14c")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        stream = phase_stream(torch, root)
        stamp("phase 16")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        knobs = phase_knobs(torch, root)
        stamp("phase 17")
    torch.cuda.empty_cache()
    # Serving runs last: its executable sidecar's compile and packages
    # bring Inductor, Triton and their worker processes into this process,
    # which the phases that time host-bound steps should not share.  The
    # sidecar's export and compile (minutes) run in a child process beside
    # phase 18, which times nothing.
    with tempfile.TemporaryDirectory() as serve_root:
        job = start_sidecar_export(torch, serve_root)
        try:
            with tempfile.TemporaryDirectory() as root:
                data_parallel = phase_data_parallel(torch, root, {
                    "train": train_counts["history"],
                    "augment": aug_runs["native"]["history"]})
                stamp("phase 18 (the sidecar's compile beside it)")
            with tempfile.TemporaryDirectory() as root:
                submesh = phase_tuning_submesh(torch, root)
                stamp("phase 19 (the sidecar's compile beside it)")
            with tempfile.TemporaryDirectory() as root:
                model_axis = phase_model_axis(torch, root)
                stamp("phase 20 (the sidecar's compile beside it)")
            with tempfile.TemporaryDirectory() as root:
                spatial_axis = phase_spatial_axis(torch, root)
                stamp("phase 21 (the sidecar's compile beside it)")
            torch.cuda.empty_cache()
            serving = phase_serving(torch, serve_root, sidecar_job=job)
            stamp("phase 15")
        finally:
            stop_sidecar_export(job)

    # The main numbers are each path's shape: the evaluation's bs 2 for the
    # confusion counts (bs 16 and 16x1024x1024 beside them), the train
    # step's bf16 logits for the loss kernels (float32 and
    # 16x1x1024x1024 beside them).
    keys = ("ms", "graph_ms", "wrapper_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_graph_ms")
    eval_t = timings[CONFUSION_SHAPES[0]]
    calls, n_launches = launches[cc.NAME]
    kernels = [{
        "name": cc.NAME,
        "route": "cuda",
        "source": "gan_aug_pfa_torch/csrc/confusion_counts.cu",
        "replaces": "gan_aug_pfa_tpu/ops/pallas_kernels/metrics.py:37",
        "launches": n_launches,
        "calls": calls,
        "max_abs_err": max_err,
        **{k: eval_t[k] for k in keys},
        "kernel_ms": eval_t["ms"],
        "library_call": "torch.histc over 2-bit codes",
        "run_control": list(run_control["confusion_counts"]),
        "eval_extras": {k: list(v) for k, v in eval_extras.items()},
        "tuning": list(tuning["counts"]["confusion"]),
        "serving": list(serving["confusion_counts"]),
        "serving_sidecar": list(serving["sidecar_counts"]),
        "stream": list(stream["confusion_counts"]),
        "shape": list(CONFUSION_SHAPES[0]),
        "plan": eval_t["plan"],
        "other": {"x".join(map(str, shape)): {
            k: timings[shape][k] for k in keys}
            for shape in CONFUSION_SHAPES[1:]},
    }]
    for name, line, library in (
            ("fwd", 120, "F.binary_cross_entropy_with_logits(sum)"),
            ("bwd", 131, "torch.mul(x, t)")):
        t = loss_t[(TRAIN_SHAPE, "bfloat16")][name]
        calls, n_launches = train_counts[name]
        kernels.append({
            "name": f"{fl.NAME}_{name}",
            "route": "cuda",
            "source": "gan_aug_pfa_torch/csrc/focal_dice_loss.cu",
            "replaces":
                f"gan_aug_pfa_tpu/ops/pallas_kernels/fused_loss.py:{line}",
            "launches": n_launches,
            "calls": calls,
            "max_abs_err": loss_errs[name, "float32"],
            "max_abs_err_bf16": loss_errs[name, "bfloat16"],
            **{k: t[k] for k in keys},
            "kernel_ms": t["ms"],
            "library_call": library + " (a yardstick of about the same "
                                      "bytes)",
            "run_control": list(run_control["loss"][name]),
            "tuning": list(tuning["loss"][name]),
            "tuning_max_abs_err": tuning_errs[name == "bwd"],
            "stream": list(stream["loss"][name]),
            "knobs": {run: list(r["loss"][name])
                      for run, r in knobs["runs"].items()},
            "data_parallel": {run: [list(r["loss"][name]) for r in ranks]
                              for run, ranks in
                              data_parallel["cli"].items()},
            "tuning_submesh": [r[name] for r in submesh["loss"]],
            "model_axis": [r[name] for r in model_axis["loss"]],
            "spatial_axis": [r[name] for r in
                             spatial_axis["spatial"]["loss"]],
            "spatial_axis_knobs": [r[name] for r in
                                   spatial_axis["spatial_knobs"]["loss"]],
            "shape": list(TRAIN_SHAPE),
            "logits": "bfloat16",
            "plan": t["plan"],
            "other": {f"{'x'.join(map(str, shape))} {dtype}": {
                k: loss_t[(shape, dtype)][name][k] for k in keys}
                for shape in (TRAIN_SHAPE, BIG_LOSS_SHAPE)
                for dtype in LOSS_DTYPES
                if (shape, dtype) != (TRAIN_SHAPE, "bfloat16")},
        })
    for kind, fn, line, shape, run in (
            ("native", ph.photometric_native_chw, 237, native_shape,
             "native"),
            ("flip", ph.photometric_flip_chw, 99, (4, 3, 128, 128),
             "fixed_size")):
        t = photo_t[(kind, shape)]
        calls, launches = aug_runs[run]["counts"][kind]
        kernels.append({
            "name": fn.__name__,
            "route": "cuda",
            "source": "gan_aug_pfa_torch/csrc/photometric.cu",
            "replaces":
                f"gan_aug_pfa_tpu/ops/pallas_kernels/photometric.py:{line}",
            "launches": launches,
            "calls": calls,
            "max_abs_err": photo_errs[kind],
            "ms": t["ms"],
            "kernel_ms": t["ms"],
            "graph_ms": t["graph_ms"],
            "wrapper_ms": t["wrapper_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_graph_ms": t["library_graph_ms"],
            "library_call": "torch.mul (a yardstick of the same bytes)",
            "tuning": list(tuning["counts"][kind]),
            **({"tuning_max_abs_err": tuning_errs[2],
                "data_parallel": [list(r["photometric"]["native"]) for r in
                                  data_parallel["cli"]["augment"]],
                "tuning_submesh": [r["native"]
                                   for r in submesh["photometric"]],
                "model_axis": model_axis["photometric"],
                "spatial_axis": spatial_axis["spatial"]["photometric"],
                "spatial_axis_knobs":
                    spatial_axis["spatial_knobs"]["photometric"]}
               if kind == "native" else {"stream": list(stream["flip"])}),
            "knobs": {run: list(knobs["runs"][run]["photometric"][kind])
                      for run in ("all", "resume")},
            "shape": list(shape),
            "plan": t["plan"],
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
