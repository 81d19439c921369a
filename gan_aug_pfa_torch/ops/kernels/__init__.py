"""Hand-written CUDA kernels, each beside its plain PyTorch version.

Sources live in ``gan_aug_pfa_torch/csrc/`` and build at first use
(``build.py``); importing these modules builds nothing.
"""
