"""Fused FocalDice loss: the CUDA kernels' wrapper and its plain PyTorch
version.

Replaces the TPU kernels of ``gan_aug_pfa_tpu/ops/pallas_kernels/
fused_loss.py``: ``run_fwd`` (four sums in one pass) and ``run_bwd`` (the
analytic gradient in a second pass), joined by ``jax.custom_vjp``.  With
p = sigmoid(x), bce = softplus(x) - x*t, pt = exp(-bce) and
alpha_t = t*alpha + (1-t)*(1-alpha):

  S     = [sum alpha_t (1-pt)^gamma bce,  I = sum p t,  P = sum p,  T = sum t]
  loss  = beta * S0/n + (1-beta) * (1 - (2I + s)/(P + T + s))
  dx    = g * (beta * dfocal/n + (1-beta) * ddice)

(``csrc/focal_dice_loss.cu`` spells out dfocal and ddice).  It is the
function ``losses.focal_dice_loss`` computes.

``focal_dice_loss_fused`` flattens its inputs and casts the logits to
float32 before the ``autograd.Function``, so that under bf16 autocast
autograd casts dx back to the logits' dtype.  It dispatches on the
tensors' device: CUDA tensors always go to the kernels (``FocalDiceLossFn``;
a failed build or launch raises), CPU tensors to the plain version
(``FocalDiceLossReferenceFn``).  The kernels count their launches in
``FocalDiceLossFn.fwd_launches`` and ``.bwd_launches``.

Bound by bytes: the forward reads 8 bytes an element, the backward reads 8
and writes 4; at the train shape (4x1x128x128) that is 0.16 and 0.23 us at
3.35 TB/s, so both are launch-bound there.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

NAME = "focal_dice_loss"


def _check(x: torch.Tensor, t: torch.Tensor) -> None:
    for name, a in (("logits", x), ("targets", t)):
        if a.dtype != torch.float32 or a.dim() != 1 or not a.is_contiguous():
            raise ValueError(f"{name} must be flat contiguous float32, got "
                             f"{a.dtype} {tuple(a.shape)}")
    if x.numel() != t.numel():
        raise ValueError(f"{x.numel()} logits but {t.numel()} targets")
    if x.numel() == 0:
        raise ValueError("empty input")
    if x.device != t.device:
        raise ValueError(f"device mismatch: logits on {x.device}, targets "
                         f"on {t.device}")


def _terms(x: torch.Tensor, t: torch.Tensor, alpha: float):
    p = torch.sigmoid(x)
    bce = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs())) - x * t
    pt = torch.exp(-bce)
    alpha_t = t * alpha + (1.0 - t) * (1.0 - alpha)
    return p, bce, pt, alpha_t


def _finalize(sums: torch.Tensor, n: int, beta: float, smooth: float):
    dice = 1.0 - (2.0 * sums[1] + smooth) / (sums[2] + sums[3] + smooth)
    return beta * (sums[0] / n) + (1.0 - beta) * dice


def focal_dice_sums_reference(x: torch.Tensor, t: torch.Tensor,
                              gamma: float, alpha: float) -> torch.Tensor:
    """The forward's four sums (4,) float32, in plain PyTorch."""
    p, bce, pt, alpha_t = _terms(x, t, alpha)
    return torch.stack([torch.sum(alpha_t * (1.0 - pt) ** gamma * bce),
                        torch.sum(p * t), torch.sum(p), torch.sum(t)])


def focal_dice_grad_reference(x, t, sums, g, beta, gamma, alpha, smooth):
    """The backward's dx in plain PyTorch (fused_loss.py:97-115)."""
    p, bce, pt, alpha_t = _terms(x, t, alpha)
    u = 1.0 - pt
    dfocal = alpha_t * (p - t) * (
        gamma * u ** (gamma - 1.0) * pt * bce + u ** gamma)
    denom = sums[2] + sums[3] + smooth
    ddice = (2.0 * sums[1] + smooth - 2.0 * t * denom) / (
        denom * denom) * p * (1.0 - p)
    return g * (beta * dfocal / x.numel() + (1.0 - beta) * ddice)


class FocalDiceLossReferenceFn(torch.autograd.Function):
    """Plain version: the four sums and the analytic backward in torch
    ops.  Inputs are flat contiguous float32 (``_check``)."""

    @staticmethod
    def forward(ctx, x, t, beta, gamma, alpha, smooth):
        _check(x, t)
        sums = focal_dice_sums_reference(x, t, gamma, alpha)
        ctx.save_for_backward(x, t, sums)
        ctx.hyper = (beta, gamma, alpha, smooth)
        return _finalize(sums, x.numel(), beta, smooth)

    @staticmethod
    def backward(ctx, g):
        x, t, sums = ctx.saved_tensors
        dx = focal_dice_grad_reference(x, t, sums, g, *ctx.hyper)
        return dx, None, None, None, None, None


@functools.lru_cache(maxsize=None)
def _kernels():
    """The C entry points (scratch size, forward, backward), built and
    bound on first use."""
    lib = build.load(NAME)
    scratch = lib.focal_dice_fwd_scratch_floats
    scratch.argtypes = [ctypes.c_longlong]
    scratch.restype = ctypes.c_int
    fwd = lib.focal_dice_fwd_f32
    fwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_float, ctypes.c_float, ctypes.c_float,
                    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.focal_dice_bwd_f32
    bwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                    ctypes.c_float, ctypes.c_float, ctypes.c_float,
                    ctypes.c_void_p, ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return scratch, fwd, bwd


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch_forward(x: torch.Tensor, t: torch.Tensor, beta: float,
                   gamma: float, alpha: float, smooth: float):
    """Forward kernels on flat float32 CUDA tensors: returns the 0-dim
    float32 loss and the (4,) float32 sums [sum focal, I, P, T], both on
    the device, without a host sync."""
    scratch, fwd, _ = _kernels()
    n = x.numel()
    loss = torch.empty((), dtype=torch.float32, device=x.device)
    buf = torch.empty(4 + scratch(n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fwd(x.data_ptr(), t.data_ptr(), n, beta, gamma, alpha, smooth,
                  loss.data_ptr(), buf.data_ptr(), buf[4:].data_ptr(),
                  _stream(x.device))
    if err != 0:
        raise RuntimeError(f"{NAME} forward launch failed: CUDA error {err}")
    return loss, buf[:4]


def launch_backward(x, t, sums, g, beta, gamma, alpha, smooth):
    """Backward kernel: dx (n,) float32 from the forward's ``sums`` and the
    upstream gradient ``g`` (one float32 on the device)."""
    _, _, bwd = _kernels()
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = bwd(x.data_ptr(), t.data_ptr(), sums.data_ptr(),
                  g.data_ptr(), x.numel(), beta, gamma, alpha, smooth,
                  dx.data_ptr(), _stream(x.device))
    if err != 0:
        raise RuntimeError(f"{NAME} backward launch failed: CUDA error {err}")
    return dx


class FocalDiceLossFn(torch.autograd.Function):
    """The kernels under autograd.  Inputs are flat contiguous float32 CUDA
    tensors."""

    fwd_launches = 0
    bwd_launches = 0

    @staticmethod
    def forward(ctx, x, t, beta, gamma, alpha, smooth):
        _check(x, t)
        if x.device.type != "cuda":
            raise ValueError(f"the kernels take CUDA tensors, got {x.device}")
        loss, sums = launch_forward(x, t, beta, gamma, alpha, smooth)
        FocalDiceLossFn.fwd_launches += 1
        ctx.save_for_backward(x, t, sums)
        ctx.hyper = (beta, gamma, alpha, smooth)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, t, sums = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        dx = launch_backward(x, t, sums, g, *ctx.hyper)
        FocalDiceLossFn.bwd_launches += 1
        return dx, None, None, None, None, None


def focal_dice_loss_fused(logits: torch.Tensor, targets: torch.Tensor,
                          beta: float = 0.5, focal_gamma: float = 2.0,
                          focal_alpha: float = 0.75,
                          dice_smooth: float = 1.0) -> torch.Tensor:
    """beta * Focal + (1-beta) * Dice over all elements, as a 0-dim float32
    tensor.  Logits and targets of any shape with the same element count,
    flattened in their own order: a (B, 1, H, W) logit map and (B, H, W)
    labels line up element for element."""
    x = logits.to(torch.float32).reshape(-1).contiguous()
    t = targets.to(torch.float32).reshape(-1).contiguous()
    hyper = (float(beta), float(focal_gamma), float(focal_alpha),
             float(dice_smooth))
    if x.device.type == "cpu":
        return FocalDiceLossReferenceFn.apply(x, t, *hyper)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return FocalDiceLossFn.apply(x, t, *hyper)
