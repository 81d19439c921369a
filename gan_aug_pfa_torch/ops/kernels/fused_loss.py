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

``focal_dice_loss_fused`` flattens its inputs and hands float32 or bfloat16
logits to the ``autograd.Function`` as they are (other dtypes are cast to
float32 first), with float32 targets; dx comes back in the logits' dtype,
so under bf16 autocast no cast runs around the loss.  It dispatches on the
tensors' device: CUDA tensors always go to the kernels (``FocalDiceLossFn``;
a failed build, a refused plan or a failed launch raises), CPU tensors to
the plain version (``FocalDiceLossReferenceFn``, which widens bfloat16
logits to float32 inside).  ``FocalDiceLossFn.fwd_calls`` /
``.fwd_launches`` and ``.bwd_calls`` / ``.bwd_launches`` count the kernels'
calls and launches: one launch a call each way.

``plan_launch`` makes both kernels' launch (grid, and where the 16-byte
aligned groups start) from the element count and the two pointers'
alignment.  The forward's blocks meet through a ticket in a workspace that
the forwards of one (device, stream) share (``torch.zeros`` at first use;
the kernel leaves the ticket at 0); a call allocates only its 5-float
output.

Bound by bytes: the forward reads 8 bytes an element (6 with bf16 logits),
the backward reads 8 and writes 4 (6 and 2); at the train shape
(4x1x128x128) that is under 0.25 us at 3.35 TB/s, so both are launch-bound
there.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
from typing import Dict, Tuple

import torch

from . import build

NAME = "focal_dice_loss"
_LAUNCHES_PER_CALL = 1
# The grid's limits, as csrc/focal_dice_loss.cu checks them: kMaxThreads
# threads a block, kBlocksPerSM resident blocks on each of the H100's 132
# SMs at most, kVec elements a thread from each 16-byte-aligned group.  The
# plan gives a block at least MIN_THREADS (at the train shape 64 blocks of
# 128 beat 128 of 64 and 32 of 256: tools/focal_dice_compare.py --sweep).
SMS = 132
THREADS = 256
MIN_THREADS = 128
BLOCKS_PER_SM = 4
MAX_BLOCKS = SMS * BLOCKS_PER_SM
VEC = 8
# The forward's workspace: the ticket, 3 floats of padding, a row of 4
# partial sums for each block.
WORKSPACE_FLOATS = 4 + 4 * MAX_BLOCKS
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check(x: torch.Tensor, t: torch.Tensor) -> None:
    if (x.dtype not in KERNEL_DTYPES or t.dtype != torch.float32
            or x.dim() != 1 or t.dim() != 1 or not x.is_contiguous()
            or not t.is_contiguous()):
        raise ValueError(f"logits must be flat contiguous float32 or "
                         f"bfloat16, targets flat contiguous float32; got "
                         f"{x.dtype} {tuple(x.shape)} and {t.dtype} "
                         f"{tuple(t.shape)}")
    n = x.numel()
    if n != t.numel():
        raise ValueError(f"{n} logits but {t.numel()} targets")
    if n == 0:
        raise ValueError("empty input")
    if x.device != t.device:
        raise ValueError(f"device mismatch: logits on {x.device}, targets "
                         f"on {t.device}")


# -- the plain version -----------------------------------------------------


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
    """The forward's four sums (4,) float32, in plain PyTorch (bfloat16
    logits widened to float32 first)."""
    p, bce, pt, alpha_t = _terms(x.float(), t, alpha)
    return torch.stack([torch.sum(alpha_t * (1.0 - pt) ** gamma * bce),
                        torch.sum(p * t), torch.sum(p), torch.sum(t)])


def focal_dice_grad_reference(x, t, sums, g, beta, gamma, alpha, smooth):
    """The backward's dx in plain PyTorch (fused_loss.py:97-115), computed
    in float32 and returned in the logits' dtype."""
    p, bce, pt, alpha_t = _terms(x.float(), t, alpha)
    u = 1.0 - pt
    dfocal = alpha_t * (p - t) * (
        gamma * u ** (gamma - 1.0) * pt * bce + u ** gamma)
    denom = sums[2] + sums[3] + smooth
    ddice = (2.0 * sums[1] + smooth - 2.0 * t * denom) / (
        denom * denom) * p * (1.0 - p)
    dx = g * (beta * dfocal / x.numel() + (1.0 - beta) * ddice)
    return dx.to(x.dtype)


class FocalDiceLossReferenceFn(torch.autograd.Function):
    """Plain version: the four sums and the analytic backward in torch
    ops.  Inputs as ``_check`` takes them."""

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


# -- the launch plan -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LossPlan:
    """One launch of either kernel: ``blocks`` blocks of ``threads``
    threads in a grid-stride loop; elements [0, head) one at a time, then
    ``groups`` groups of VEC elements read (and dx written) 16 bytes at a
    time, then the rest one at a time."""

    threads: int
    blocks: int
    head: int
    groups: int

    def c_args(self) -> Tuple[int, int, int, int]:
        """(threads, blocks, head, groups), the C entry points' plan
        arguments."""
        return (self.threads, self.blocks, self.head, self.groups)


@functools.lru_cache(maxsize=1024)
def plan_launch(n: int, x_offset: int, t_offset: int,
                x_bytes: int) -> LossPlan:
    """The plan for n elements whose logits (``x_bytes`` each: 4 float32,
    2 bfloat16) start ``x_offset`` bytes and whose float32 targets start
    ``t_offset`` bytes past a 16-byte boundary.

    ``head`` is the fewest leading elements after which both are 16-byte
    aligned (n where no count is).  A thread takes a group (or a scalar
    element where there is none) in blocks of MIN_THREADS to THREADS, up
    to BLOCKS_PER_SM blocks of THREADS an SM: 64 blocks of 128 threads at
    the train shape (65,536 elements), 528 blocks of 256 from about 2^20
    elements on, each thread then walking several groups."""
    if n < 1:
        raise ValueError(f"no plan for {n} elements")
    if (x_bytes not in (2, 4) or not 0 <= x_offset < 16
            or not 0 <= t_offset < 16 or x_offset % x_bytes
            or t_offset % 4):
        raise ValueError(f"no plan for {x_bytes}-byte logits at offset "
                         f"{x_offset} and targets at offset {t_offset}")
    head = next((h for h in range(VEC)
                 if (x_offset + h * x_bytes) % 16 == 0
                 and (t_offset + 4 * h) % 16 == 0), n)
    head = min(head, n)
    groups = (n - head) // VEC
    work = groups or n
    threads = max(MIN_THREADS, min(THREADS, 32 * -(-work // (32 * SMS))))
    blocks = max(1, min(MAX_BLOCKS, -(-work // threads)))
    return LossPlan(threads, blocks, head, groups)


def plan_for(x: torch.Tensor, t: torch.Tensor) -> LossPlan:
    """``plan_launch`` for the data pointers of checked flat tensors."""
    return plan_launch(x.numel(), x.data_ptr() % 16, t.data_ptr() % 16,
                       x.element_size())


# -- the kernels -----------------------------------------------------------


def bind(lib: ctypes.CDLL):
    """The forward and backward C entry points of a loaded library built
    from csrc/focal_dice_loss.cu, with their argument types."""
    plan = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
    hyper = [ctypes.c_float] * 4
    fwd = lib.focal_dice_fwd
    fwd.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_longlong] + plan + hyper
                    + [ctypes.c_void_p] * 3)
    bwd = lib.focal_dice_bwd
    bwd.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                    + [ctypes.c_longlong] + plan + hyper
                    + [ctypes.c_void_p] * 2)
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


@functools.lru_cache(maxsize=None)
def _kernels():
    """This tree's (forward, backward) entry points, built and bound on
    first use."""
    lib = build.load(NAME)
    lib.focal_dice_workspace_floats.restype = ctypes.c_int
    floats = lib.focal_dice_workspace_floats()
    if floats != WORKSPACE_FLOATS:
        raise RuntimeError(f"{NAME}: the library's workspace is {floats} "
                           f"floats, the wrapper's {WORKSPACE_FLOATS}")
    return bind(lib)


_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}


def workspace(device: torch.device, stream: int) -> torch.Tensor:
    """The forward's workspace for ``stream`` on ``device``, zeroed at
    first use on the stream itself."""
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None:
        ws = _workspaces[key] = torch.zeros(WORKSPACE_FLOATS,
                                            dtype=torch.float32,
                                            device=device)
    return ws


def _on(device: torch.device):
    """``device`` made current only where it is not already."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def launch_forward(x: torch.Tensor, t: torch.Tensor, beta: float,
                   gamma: float, alpha: float, smooth: float):
    """The forward kernel, one launch, on flat checked CUDA tensors:
    returns the 0-dim float32 loss and the (4,) float32 sums [S0, I, P,
    T], views of one 5-float output on the device, without a host sync.

    Inside a CUDA-graph capture the call takes its own zeroed workspace
    with its output (the graph zeroes it before each replay; the outputs
    keep it alive), so no two graphs share a ticket."""
    fwd, _ = _kernels()
    device = x.device
    with _on(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if torch.cuda.is_current_stream_capturing():
            buf = torch.zeros(8 + WORKSPACE_FLOATS, dtype=torch.float32,
                              device=device)
            out, ws = buf[:5], buf[8:]
        else:
            out = torch.empty(5, dtype=torch.float32, device=device)
            ws = workspace(device, stream)
        err = fwd(x.data_ptr(), int(x.dtype == torch.bfloat16), t.data_ptr(),
                  x.numel(), *plan_for(x, t).c_args(), beta, gamma, alpha,
                  smooth, out.data_ptr(), ws.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{NAME} forward launch failed: CUDA error {err}")
    return out[0], out[1:]


def launch_backward(x, t, sums, g, beta, gamma, alpha, smooth):
    """The backward kernel, one launch: dx (n,) in the logits' dtype from
    the forward's ``sums`` and the upstream gradient ``g`` (one float32 on
    the device)."""
    _, bwd = _kernels()
    dx = torch.empty_like(x)
    device = x.device
    with _on(device):
        err = bwd(x.data_ptr(), int(x.dtype == torch.bfloat16), t.data_ptr(),
                  sums.data_ptr(), g.data_ptr(), x.numel(),
                  *plan_for(x, t).c_args(), beta, gamma, alpha, smooth,
                  dx.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{NAME} backward launch failed: CUDA error {err}")
    return dx


class FocalDiceLossFn(torch.autograd.Function):
    """The kernels under autograd.  Inputs as ``_check`` takes them, on a
    CUDA card."""

    fwd_calls = fwd_launches = 0
    bwd_calls = bwd_launches = 0

    @staticmethod
    def forward(ctx, x, t, beta, gamma, alpha, smooth):
        _check(x, t)
        if x.device.type != "cuda":
            raise ValueError(f"the kernels take CUDA tensors, got {x.device}")
        loss, sums = launch_forward(x, t, beta, gamma, alpha, smooth)
        FocalDiceLossFn.fwd_calls += 1
        FocalDiceLossFn.fwd_launches += _LAUNCHES_PER_CALL
        ctx.save_for_backward(x, t, sums)
        ctx.hyper = (beta, gamma, alpha, smooth)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, t, sums = ctx.saved_tensors
        if g.dtype != torch.float32 or not g.is_contiguous():
            g = g.to(torch.float32).contiguous()
        dx = launch_backward(x, t, sums, g, *ctx.hyper)
        FocalDiceLossFn.bwd_calls += 1
        FocalDiceLossFn.bwd_launches += _LAUNCHES_PER_CALL
        return dx, None, None, None, None, None


def focal_dice_loss_fused(logits: torch.Tensor, targets: torch.Tensor,
                          beta: float = 0.5, focal_gamma: float = 2.0,
                          focal_alpha: float = 0.75,
                          dice_smooth: float = 1.0) -> torch.Tensor:
    """beta * Focal + (1-beta) * Dice over all elements, as a 0-dim float32
    tensor.  Logits and targets of any shape with the same element count,
    flattened in their own order: a (B, 1, H, W) logit map and (B, H, W)
    labels line up element for element.  Float32 and bfloat16 logits reach
    the Function as they are."""
    x = logits.reshape(-1)
    if x.dtype not in KERNEL_DTYPES:
        x = x.to(torch.float32)
    t = targets.reshape(-1)
    if t.dtype != torch.float32:
        t = t.to(torch.float32)
    x, t = x.contiguous(), t.contiguous()
    hyper = (float(beta), float(focal_gamma), float(focal_alpha),
             float(dice_smooth))
    if x.device.type == "cpu":
        return FocalDiceLossReferenceFn.apply(x, t, *hyper)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return FocalDiceLossFn.apply(x, t, *hyper)
