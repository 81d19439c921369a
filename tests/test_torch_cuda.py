"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports neither JAX nor PIL, so that it runs on a machine
with a card and PyTorch alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips (the kernels have no CPU mode)."""

import numpy as np
import pytest
import torch

from gan_aug_pfa_torch.ops.kernels import confusion_counts as cc

SHAPES = [(2, 128, 128), (5, 33, 47), (1, 37, 53), (3, 1, 1),
          (4, 512, 512)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _inputs(shape, threshold, seed):
    rng = np.random.RandomState(seed)
    p = rng.rand(*shape).astype(np.float32)
    p.reshape(-1)[::7] = threshold  # at the threshold: negative
    t = (rng.rand(*shape) > 0.6).astype(np.float32)
    t[0] = 1.0
    if shape[0] > 1:
        t[-1] = 0.0
    return torch.from_numpy(p).cuda(), torch.from_numpy(t).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_confusion_counts_kernel_matches_reference(cuda, shape, threshold):
    p, t = _inputs(shape, threshold, seed=sum(shape))
    before = cc.confusion_counts_batch.launches
    got = cc.confusion_counts_batch(p, t, threshold)
    torch.cuda.synchronize()
    assert cc.confusion_counts_batch.launches == before + 1
    assert torch.equal(got, cc.confusion_counts_batch_reference(p, t,
                                                                threshold))
    assert bool((got.sum(dim=1) == shape[1] * shape[2]).all())


@pytest.mark.cuda
def test_confusion_counts_kernel_misaligned_view(cuda):
    """A batch slice whose data pointer is not 16-byte aligned takes the
    kernel's scalar path and gives the same counts."""
    p, t = _inputs((3, 37, 53), 0.5, seed=1)
    p, t = p[1:], t[1:]
    assert p.data_ptr() % 16 != 0
    got = cc.confusion_counts_batch(p, t)
    assert torch.equal(got, cc.confusion_counts_batch_reference(p, t))
