"""PyTorch/CUDA port of the GAN-augmented change-detection framework.

Mirrors the module layout of the JAX package (``gan_aug_pfa_tpu``) so that
each module's counterpart is easy to find, but imports only ``torch`` and
``numpy``.  Public functions keep the JAX layout (NHWC images in [0, 1],
``(B, H, W, 1)`` probabilities); inside, modules run NCHW.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.

Ported so far: the OSCD evaluation path (scan, decode-once cache, the
SiameseUNet forward, per-sample confusion counts through a hand-written
CUDA kernel, macro-averaged metrics, the threshold sweep,
post-processing, ensembles, panels and single-pair evaluation, ``python -m
gan_aug_pfa_torch.evaluate``), Siamese training with and without
augmentation (splits, FocalDice through hand-written forward and backward
CUDA kernels, photometric augmentation kernels, AdamW, ReduceLROnPlateau,
checkpoints and resume, ``python -m gan_aug_pfa_torch.train``), Pix2Pix
GAN training (``python -m gan_aug_pfa_torch.train_gan``) and synthesis of
the fake "after" corpus (``python -m gan_aug_pfa_torch.generate_synthetic``),
both trainers' run control (SIGTERM-safe resume, run log, profiler, NaN
checks, deferred and background checkpoint writes), reading the JAX
package's ``.msgpack`` checkpoints and resuming both trainers from its
train states, and hyperparameter tuning (``python -m
gan_aug_pfa_torch.train --tune``, ``python -m
gan_aug_pfa_torch.show_optuna_results``), and data-parallel training of
both models over every visible card (``parallel/``).
"""
