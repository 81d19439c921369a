"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports neither JAX nor PIL, so that it runs on a machine
with a card and PyTorch alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips (the kernels have no CPU mode)."""

import numpy as np
import pytest
import torch

from gan_aug_pfa_torch.ops.kernels import confusion_counts as cc
from gan_aug_pfa_torch.ops.kernels import fused_loss as fl

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


# The fused FocalDice kernels: the shapes chip_smoke.py checks, with the
# tuned gamma and the u^0 edge at gamma = 1.
LOSS_SHAPES = [(1, 1, 7, 9), (4, 1, 128, 128), (3, 1, 37, 53),
               (4, 1, 512, 512)]
GAMMAS = [1.7930869982898021, 1.0]
LOSS_KW = dict(beta=0.6699803915247974, focal_alpha=0.6030489822904476,
               dice_smooth=1.956571276926647e-06)


def _loss_inputs(shape, seed, extra=0):
    """Logits (B, 1, H, W) with saturated +-1e4 entries and binary targets
    (B, H, W); ``extra`` leading elements make views 4 bytes past a 16-byte
    boundary."""
    rng = np.random.RandomState(seed)
    n = int(np.prod(shape))
    x = (rng.randn(n + extra) * 4).astype(np.float32)
    x[::101] = 1e4
    x[50::101] = -1e4
    t = (rng.rand(n + extra) > 0.7).astype(np.float32)
    x = torch.from_numpy(x).cuda()[extra:]
    t = torch.from_numpy(t).cuda()[extra:]
    b, _, h, w = shape
    return x.view(shape), t.view(b, h, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LOSS_SHAPES)
@pytest.mark.parametrize("gamma", GAMMAS)
def test_fused_loss_kernels_match_plain_version(cuda, shape, gamma):
    """Forward within 1e-6 relative, dx within 1e-5 of max|dx| (1e-3 from
    2^20 elements on), launch counts, and the same bits on a rerun."""
    x, t = _loss_inputs(shape, seed=sum(shape),
                        extra=1 if shape == (3, 1, 37, 53) else 0)
    xf, tf = x.reshape(-1), t.reshape(-1)
    hyper = (LOSS_KW["beta"], gamma, LOSS_KW["focal_alpha"],
             LOSS_KW["dice_smooth"])
    g = torch.tensor(0.73, device="cuda")
    loss, sums = fl.launch_forward(xf, tf, *hyper)
    dx = fl.launch_backward(xf, tf, sums, g, *hyper)
    again, _ = fl.launch_forward(xf, tf, *hyper)
    torch.cuda.synchronize()
    ref_sums = fl.focal_dice_sums_reference(xf, tf, gamma, hyper[2])
    ref = float(fl._finalize(ref_sums, xf.numel(), hyper[0], hyper[3]))
    ref_dx = fl.focal_dice_grad_reference(xf, tf, ref_sums, g, *hyper)
    assert abs(float(loss) - ref) < 1e-6 * max(1.0, abs(ref))
    tol = 1e-3 if xf.numel() >= 1 << 20 else 1e-5
    assert bool(dx.isfinite().all())
    assert float((dx - ref_dx).abs().max()) <= tol * float(
        ref_dx.abs().max())
    assert torch.equal(loss, again)

    before = (fl.FocalDiceLossFn.fwd_launches, fl.FocalDiceLossFn.bwd_launches)
    xg = x.detach().clone().requires_grad_()
    fl.focal_dice_loss_fused(xg, t, focal_gamma=gamma, **LOSS_KW).backward()
    assert (fl.FocalDiceLossFn.fwd_launches,
            fl.FocalDiceLossFn.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert float((xg.grad.reshape(-1) - ref_dx / 0.73).abs().max()) <= (
        tol * float(ref_dx.abs().max()) / 0.73)


@pytest.mark.cuda
def test_fused_loss_backward_under_bf16_autocast(cuda):
    """Under bf16 autocast, bf16 logits reach the kernels as their fp32
    cast and dx comes back as bf16: equal to the plain version's dx at the
    same fp32 logits, cast to bf16 the same way."""
    x, t = _loss_inputs((4, 1, 128, 128), seed=3)
    xb = x.to(torch.bfloat16).detach().requires_grad_()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        loss = fl.focal_dice_loss_fused(xb, t, **LOSS_KW)
    loss.backward()
    assert loss.dtype == torch.float32 and xb.grad.dtype == torch.bfloat16
    x32 = xb.detach().float().requires_grad_()
    ref = fl.FocalDiceLossReferenceFn.apply(
        x32.reshape(-1), t.reshape(-1), LOSS_KW["beta"], 2.0,
        LOSS_KW["focal_alpha"], LOSS_KW["dice_smooth"])
    ref.backward()
    loss, ref = float(loss.detach()), float(ref.detach())
    assert abs(loss - ref) < 1e-6 * max(1.0, abs(ref))
    want = x32.grad.to(torch.bfloat16).float()
    got = xb.grad.float()
    # Equal up to one bf16 rounding step of values that agree in fp32.
    assert float((got - want).abs().max()) <= 2 ** -8 * float(
        want.abs().max())
