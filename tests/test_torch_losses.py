"""The port's losses and the fused FocalDice loss's plain version against
the JAX package, at fp32 on the CPU, from numpy inputs.

Tolerances: loss values within 1e-6 relative (tests/test_pallas.py:44);
gradients within 1e-5 of their largest magnitude (tests/test_pallas.py:55).
The JAX side runs under ``jax.jit`` (one compile per function and shape)
and its fused kernel in interpret mode.  The CUDA kernels themselves run
only on the card: tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_aug_pfa_torch import losses as tl
from gan_aug_pfa_torch.ops.kernels import fused_loss as fl
from gan_aug_pfa_tpu import losses as jl
from gan_aug_pfa_tpu.ops.pallas_kernels.fused_loss import (
    focal_dice_loss_fused as jax_fused,
)

SHAPES = [(1, 7, 9, 1), (4, 64, 64, 1)]
# The tuned constants of SiameseTrainConfig.
TUNED = dict(beta=0.6699803915247974, focal_gamma=1.7930869982898021,
             focal_alpha=0.6030489822904476, dice_smooth=1.956571276926647e-06)


def _inputs(shape, seed, scale=3.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * scale).astype(np.float32)
    t = (rng.rand(*shape) > 0.75).astype(np.float32)
    return x, t


def _close(got, want, rtol=1e-6):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * max(1.0, abs(want)), (got, want)


LOSSES = {
    "bce_with_logits": (
        lambda m, x, t: m.bce_with_logits(x, t),
        lambda m, x, t: m.bce_with_logits(x, t, pos_weight=9.0),
        lambda m, x, t: m.bce_with_logits(x, t, reduction="sum"),
    ),
    "dice_loss": (lambda m, x, t: m.dice_loss(x, t),
                  lambda m, x, t: m.dice_loss(x, t, smooth=1e-6)),
    "focal_loss": (lambda m, x, t: m.focal_loss(x, t),
                   lambda m, x, t: m.focal_loss(x, t, gamma=1.79, alpha=0.6,
                                                reduction="sum")),
    "combined_loss": (lambda m, x, t: m.combined_loss(x, t),
                      lambda m, x, t: m.combined_loss(x, t, 0.3, 1e-6, 4.0)),
    "focal_dice_loss": (lambda m, x, t: m.focal_dice_loss(x, t),
                        lambda m, x, t: m.focal_dice_loss(x, t, **TUNED)),
}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name, shape):
    x, t = _inputs(shape, seed=len(name) + shape[0])
    for fn in LOSSES[name]:
        want = jax.jit(lambda a, b: fn(jl, a, b))(x, t)
        got = fn(tl, torch.from_numpy(x), torch.from_numpy(t))
        assert got.dtype == torch.float32
        _close(got, want)


def _grad_port(x, t, kw):
    xt = torch.from_numpy(x).requires_grad_()
    loss = fl.FocalDiceLossReferenceFn.apply(
        xt.reshape(-1), torch.from_numpy(t).reshape(-1), kw["beta"],
        kw["focal_gamma"], kw["focal_alpha"], kw["dice_smooth"])
    loss.backward()
    return float(loss.detach()), xt.grad.numpy()


def _grad_jax(fn, x, t, kw):
    value, grad = jax.jit(jax.value_and_grad(
        lambda a: fn(a, jnp.asarray(t), **kw)))(x)
    return float(value), np.asarray(grad)


@pytest.mark.parametrize("gamma", [TUNED["focal_gamma"], 1.0])
def test_plain_fused_loss_matches_jax_grad(gamma):
    """The plain Function's loss and dx against ``jax.value_and_grad`` of
    the composite loss and of the Pallas kernel (interpret mode)."""
    x, t = _inputs((2, 24, 24, 1), seed=7, scale=2.0)
    x.reshape(-1)[:4] = [50.0, -50.0, 30.0, -30.0]  # saturated logits
    kw = dict(TUNED, focal_gamma=gamma)
    value, grad = _grad_port(x, t, kw)
    for fn in (jl.focal_dice_loss,
               lambda a, b, **k: jax_fused(a, b, interpret=True, **k)):
        want_value, want_grad = _grad_jax(fn, x, t, kw)
        _close(value, want_value)
        assert np.all(np.isfinite(grad))
        scale = np.abs(want_grad).max()
        assert np.abs(grad - want_grad).max() < 1e-5 * scale


def test_plain_fused_loss_gamma_one_edge():
    """gamma = 1 at saturated logits: u^(gamma-1) = 0^0 = 1, finite dx
    (tests/test_pallas.py:58-67)."""
    x = np.array([[-50.0, 0.0, 50.0, 3.0]] * 32, np.float32)
    t = np.array([[0.0, 1.0, 1.0, 0.0]] * 32, np.float32)
    kw = dict(beta=0.7, focal_gamma=1.0, focal_alpha=0.4, dice_smooth=1e-6)
    value, grad = _grad_port(x, t, kw)
    want_value, want_grad = _grad_jax(jl.focal_dice_loss, x, t, kw)
    _close(value, want_value)
    assert np.all(np.isfinite(grad))
    np.testing.assert_allclose(grad, want_grad, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_fused_loss_matches_port_composite_under_autograd(shape):
    x, t = _inputs(shape, seed=3)
    grads = []
    for fn in (fl.focal_dice_loss_fused, tl.focal_dice_loss):
        xt = torch.from_numpy(x).requires_grad_()
        loss = fn(xt, torch.from_numpy(t), **TUNED)
        loss.backward()
        grads.append((float(loss.detach()), xt.grad))
    _close(grads[0][0], grads[1][0])
    scale = float(grads[1][1].abs().max())
    assert float((grads[0][1] - grads[1][1]).abs().max()) < 1e-5 * scale


def _counts():
    fn = fl.FocalDiceLossFn
    return (fn.fwd_calls, fn.fwd_launches, fn.bwd_calls, fn.bwd_launches)


def test_wrapper_on_cpu_takes_plain_version_without_launch():
    """(B, 1, H, W) logits against (B, H, W) labels, as the trainer passes
    them; no kernel call or launch is counted on the CPU."""
    x, t = _inputs((3, 1, 16, 20), seed=5)
    before = _counts()
    xt = torch.from_numpy(x).requires_grad_()
    loss = fl.focal_dice_loss_fused(xt, torch.from_numpy(t[:, 0]), **TUNED)
    loss.backward()
    assert _counts() == before
    want = tl.focal_dice_loss(torch.from_numpy(x), torch.from_numpy(t),
                              **TUNED)
    _close(loss.detach(), want)
    assert xt.grad.shape == xt.shape and xt.grad.dtype == torch.float32


def _graph_nodes(loss):
    """Names of the autograd nodes behind ``loss``."""
    names, todo = [], [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is not None:
            names.append(type(node).__name__)
            todo.extend(fn for fn, _ in node.next_functions)
    return names


def test_wrapper_casts_low_precision_logits_outside_the_function():
    """bf16 logits reach the Function as they are (no cast node between
    the logits and the loss) and dx comes back from it as bf16; fp16
    logits, which the kernels do not take, are cast to fp32 outside the
    Function and autograd casts dx back.  Either way dx equals the fp32 dx
    of the same values, cast to the logits' dtype."""
    x, t = _inputs((2, 1, 8, 8), seed=9)
    for dtype, cast in ((torch.bfloat16, False), (torch.float16, True)):
        xl = torch.from_numpy(x).to(dtype).requires_grad_()
        loss = fl.focal_dice_loss_fused(xl, torch.from_numpy(t[:, 0]),
                                        **TUNED)
        assert any("ToCopy" in n for n in _graph_nodes(loss)) == cast
        loss.backward()
        assert loss.dtype == torch.float32 and xl.grad.dtype == dtype
        x32 = xl.detach().float().requires_grad_()
        fl.focal_dice_loss_fused(x32, torch.from_numpy(t[:, 0]),
                                 **TUNED).backward()
        assert torch.equal(xl.grad, x32.grad.to(dtype))


def test_bf16_logits_match_jax_fused_loss():
    """bf16 logits through the port's ``focal_dice_loss_fused`` (the plain
    version on the CPU) and through JAX's (the Pallas kernel in interpret
    mode, one jitted call): the loss within 1e-6 relative, dx (bf16 on both
    sides) within one bf16 rounding step of each value beyond 1e-5 of
    max|dx|."""
    x, t = _inputs((2, 24, 24, 1), seed=17, scale=2.0)
    x.reshape(-1)[:4] = [50.0, -50.0, 30.0, -30.0]  # saturated logits
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    loss = fl.focal_dice_loss_fused(xb, torch.from_numpy(t), **TUNED)
    loss.backward()
    xj = jnp.asarray(xb.detach().float().numpy(), dtype=jnp.bfloat16)
    value, grad = jax.jit(jax.value_and_grad(lambda a: jax_fused(
        a, jnp.asarray(t), interpret=True, **TUNED)))(xj)
    _close(loss.detach(), value)
    assert grad.dtype == jnp.bfloat16 and xb.grad.dtype == torch.bfloat16
    want = np.asarray(grad.astype(jnp.float32))
    got = xb.grad.float().numpy()
    step = 2.0 ** -7 * np.abs(want) + 1e-5 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= step)


@pytest.mark.parametrize("bad", ["numel", "empty", "device"])
def test_wrapper_rejects_what_the_kernels_do_not_take(bad):
    x = torch.zeros(2, 1, 4, 4)
    t = torch.zeros(2, 4, 4)
    if bad == "numel":
        t = torch.zeros(2, 4, 5)
    elif bad == "empty":
        x, t = torch.zeros(0, 1, 4, 4), torch.zeros(0, 4, 4)
    else:
        t = t.to("meta")
    with pytest.raises(ValueError):
        fl.focal_dice_loss_fused(x, t)
