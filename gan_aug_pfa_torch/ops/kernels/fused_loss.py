"""Fused FocalDice loss: the CUDA kernels' wrapper and its plain PyTorch
version.

Replaces the TPU kernels of ``gan_aug_pfa_tpu/ops/pallas_kernels/
fused_loss.py``: ``run_fwd`` (four sums in one pass) and ``run_bwd`` (the
analytic gradient in a second pass), joined by ``jax.custom_vjp``.  With
p = sigmoid(x), bce = softplus(x) - x*t, pt = exp(-bce) and
alpha_t = t*alpha + (1-t)*(1-alpha):

  S     = [sum alpha_t (1-pt)^gamma bce,  I = sum p t,  P = sum p,  T = sum t]
  loss  = beta * S0/N + (1-beta) * (1 - (2I + s)/(P + T + s))
  dx    = g * (beta * dfocal/N + (1-beta) * ddice)

(``csrc/focal_dice_loss.cu`` spells out dfocal and ddice), with N = n, the
element count.  It is the function ``losses.focal_dice_loss`` computes.

Under a data mesh (``parallel/mesh.py``) each rank holds a shard of the
global batch, and the loss is the global batch's: the Dice term is not a
mean of the shards' Dice terms.  ``focal_dice_loss_fused(..., group=,
n_total=)`` then launches the forward on the shard, sums its four sums
over the ranks on the device (one all-reduce, no host sync), forms the
loss from the global sums with N = ``n_total`` (the global element count,
``_finalize``), and hands the global sums and ``n_total`` to the
backward, whose dx is then the global loss's gradient on the shard.  Both
C entry points take ``n_total`` beside ``n`` and refuse n_total < n; with
n_total = n they give the bits they gave without it.

``focal_dice_loss_fused`` flattens its inputs and hands float32 or bfloat16
logits to the ``autograd.Function`` as they are (other dtypes are cast to
float32 first), with float32 targets; dx comes back in the logits' dtype,
so under bf16 autocast no cast runs around the loss.  It dispatches on the
tensors' device: CUDA tensors always go to the kernels (``FocalDiceLossFn``;
a failed build, a refused plan or a failed launch raises), CPU tensors to
the plain version (``FocalDiceLossReferenceFn``, which widens bfloat16
logits to float32 inside; float64 logits stay float64 there, with float64
targets, the precision of the parity tests).
``FocalDiceLossFn.fwd_calls`` / ``.fwd_launches`` and ``.bwd_calls`` /
``.bwd_launches`` count the kernels' calls and launches: one launch a call
each way.

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

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from . import build
from .workspace import Workspaces, on

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
    plain64 = x.dtype == t.dtype == torch.float64 and x.device.type == "cpu"
    kernel = x.dtype in KERNEL_DTYPES and t.dtype == torch.float32
    if (not (kernel or plain64) or x.dim() != 1 or t.dim() != 1
            or not x.is_contiguous() or not t.is_contiguous()):
        raise ValueError(f"logits must be flat contiguous float32 or "
                         f"bfloat16, targets flat contiguous float32 (both "
                         f"float64 on the CPU); got "
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


def _wide(x: torch.Tensor) -> torch.Tensor:
    """The logits at the plain version's precision: float64 as they are,
    others in float32."""
    return x if x.dtype == torch.float64 else x.float()


def _terms(x: torch.Tensor, t: torch.Tensor, alpha: float):
    p = torch.sigmoid(x)
    bce = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs())) - x * t
    pt = torch.exp(-bce)
    alpha_t = t * alpha + (1.0 - t) * (1.0 - alpha)
    return p, bce, pt, alpha_t


def _finalize(sums: torch.Tensor, n: int, beta: float, smooth: float):
    """The loss from the four sums, with ``n`` the focal mean's divisor."""
    dice = 1.0 - (2.0 * sums[1] + smooth) / (sums[2] + sums[3] + smooth)
    return beta * (sums[0] / n) + (1.0 - beta) * dice


def focal_dice_sums_reference(x: torch.Tensor, t: torch.Tensor,
                              gamma: float, alpha: float) -> torch.Tensor:
    """The forward's four sums (4,) float32, in plain PyTorch (bfloat16
    logits widened to float32 first; float64 at float64)."""
    p, bce, pt, alpha_t = _terms(_wide(x), t, alpha)
    return torch.stack([torch.sum(alpha_t * (1.0 - pt) ** gamma * bce),
                        torch.sum(p * t), torch.sum(p), torch.sum(t)])


def focal_dice_grad_reference(x, t, sums, g, beta, gamma, alpha, smooth,
                              n_total=None):
    """The backward's dx in plain PyTorch (fused_loss.py:97-115), computed
    in float32 (float64 for float64 logits) and returned in the logits'
    dtype; ``sums`` are the loss's
    (the global batch's under a mesh) and ``n_total`` the focal mean's
    divisor (``x.numel()`` when None)."""
    p, bce, pt, alpha_t = _terms(_wide(x), t, alpha)
    u = 1.0 - pt
    dfocal = alpha_t * (p - t) * (
        gamma * u ** (gamma - 1.0) * pt * bce + u ** gamma)
    denom = sums[2] + sums[3] + smooth
    ddice = (2.0 * sums[1] + smooth - 2.0 * t * denom) / (
        denom * denom) * p * (1.0 - p)
    n = x.numel() if n_total is None else n_total
    dx = g * (beta * dfocal / n + (1.0 - beta) * ddice)
    return dx.to(x.dtype)


def _global_sums(sums: torch.Tensor, group) -> torch.Tensor:
    """The four sums over the ranks of ``group`` (on the device, in
    place)."""
    import torch.distributed as dist

    dist.all_reduce(sums, group=group)
    return sums


class FocalDiceLossReferenceFn(torch.autograd.Function):
    """Plain version: the four sums and the analytic backward in torch
    ops.  Inputs as ``_check`` takes them; with ``mesh`` = (group,
    n_total), the shard's sums are summed over the ranks and the loss is
    the global batch's (module docstring)."""

    @staticmethod
    def forward(ctx, x, t, beta, gamma, alpha, smooth, mesh=None):
        _check(x, t)
        sums = focal_dice_sums_reference(x, t, gamma, alpha)
        n_total = x.numel()
        if mesh is not None:
            group, n_total = mesh
            sums = _global_sums(sums, group)
        ctx.save_for_backward(x, t, sums)
        ctx.hyper = (beta, gamma, alpha, smooth, n_total)
        return _finalize(sums, n_total, beta, smooth)

    @staticmethod
    def backward(ctx, g):
        x, t, sums = ctx.saved_tensors
        dx = focal_dice_grad_reference(x, t, sums, g, *ctx.hyper)
        return dx, None, None, None, None, None, None


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
    counts = [ctypes.c_longlong] * 2  # n, n_total
    fwd = lib.focal_dice_fwd
    fwd.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                    + counts + plan + hyper + [ctypes.c_void_p] * 3)
    bwd = lib.focal_dice_bwd
    bwd.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                    + counts + plan + hyper + [ctypes.c_void_p] * 2)
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


_workspaces = Workspaces(torch.float32)


def workspace(device: torch.device, stream: int) -> torch.Tensor:
    """The forward's workspace for ``stream`` on ``device``, zeroed at
    first use on the stream itself."""
    return _workspaces.persistent(device, stream, WORKSPACE_FLOATS)


def launch_forward(x: torch.Tensor, t: torch.Tensor, beta: float,
                   gamma: float, alpha: float, smooth: float,
                   n_total=None):
    """The forward kernel, one launch, on flat checked CUDA tensors:
    returns the 0-dim float32 loss (its focal mean divided by ``n_total``,
    ``x.numel()`` when None) and the (4,) float32 sums [S0, I, P, T] of
    these elements, views of one 5-float output on the device, without a
    host sync.

    Inside a CUDA-graph capture the call takes its own zeroed workspace
    with its output (the graph zeroes it before each replay; the outputs
    keep it alive), so no two graphs share a ticket."""
    fwd, _ = _kernels()
    device = x.device
    with on(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        out, ws = _workspaces.call_buffers(device, stream, (5,),
                                           torch.float32, WORKSPACE_FLOATS)
        n = x.numel()
        err = fwd(x.data_ptr(), int(x.dtype == torch.bfloat16), t.data_ptr(),
                  n, n if n_total is None else n_total,
                  *plan_for(x, t).c_args(), beta, gamma, alpha, smooth,
                  out.data_ptr(), ws.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{NAME} forward launch failed: CUDA error {err}")
    return out[0], out[1:]


def launch_backward(x, t, sums, g, beta, gamma, alpha, smooth,
                    n_total=None):
    """The backward kernel, one launch: dx (n,) in the logits' dtype from
    the loss's ``sums`` (the forward's, or the global batch's under a
    mesh), the focal mean's divisor ``n_total`` (``x.numel()`` when None)
    and the upstream gradient ``g`` (one float32 on the device)."""
    _, bwd = _kernels()
    dx = torch.empty_like(x)
    device = x.device
    n = x.numel()
    with on(device):
        err = bwd(x.data_ptr(), int(x.dtype == torch.bfloat16), t.data_ptr(),
                  sums.data_ptr(), g.data_ptr(), n,
                  n if n_total is None else n_total,
                  *plan_for(x, t).c_args(), beta, gamma, alpha, smooth,
                  dx.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{NAME} backward launch failed: CUDA error {err}")
    return dx


class FocalDiceLossFn(torch.autograd.Function):
    """The kernels under autograd.  Inputs as ``_check`` takes them, on a
    CUDA card; ``mesh`` as for ``FocalDiceLossReferenceFn``."""

    fwd_calls = fwd_launches = 0
    bwd_calls = bwd_launches = 0

    @staticmethod
    def forward(ctx, x, t, beta, gamma, alpha, smooth, mesh=None):
        _check(x, t)
        if x.device.type != "cuda":
            raise ValueError(f"the kernels take CUDA tensors, got {x.device}")
        group, n_total = mesh if mesh is not None else (None, x.numel())
        loss, sums = launch_forward(x, t, beta, gamma, alpha, smooth,
                                    n_total)
        FocalDiceLossFn.fwd_calls += 1
        FocalDiceLossFn.fwd_launches += _LAUNCHES_PER_CALL
        if mesh is not None:
            sums = _global_sums(sums, group)
            loss = _finalize(sums, n_total, beta, smooth)
        ctx.save_for_backward(x, t, sums)
        ctx.hyper = (beta, gamma, alpha, smooth, n_total)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, t, sums = ctx.saved_tensors
        if g.dtype != torch.float32 or not g.is_contiguous():
            g = g.to(torch.float32).contiguous()
        dx = launch_backward(x, t, sums, g, *ctx.hyper)
        FocalDiceLossFn.bwd_calls += 1
        FocalDiceLossFn.bwd_launches += _LAUNCHES_PER_CALL
        return dx, None, None, None, None, None, None


def focal_dice_loss_fused(logits: torch.Tensor, targets: torch.Tensor,
                          beta: float = 0.5, focal_gamma: float = 2.0,
                          focal_alpha: float = 0.75,
                          dice_smooth: float = 1.0, group=None,
                          n_total=None) -> torch.Tensor:
    """beta * Focal + (1-beta) * Dice over all elements, as a 0-dim float32
    tensor.  Logits and targets of any shape with the same element count,
    flattened in their own order: a (B, 1, H, W) logit map and (B, H, W)
    labels line up element for element.  Float32 and bfloat16 logits reach
    the Function as they are.

    With ``n_total`` (the global batch's element count) the inputs are this
    rank's shard of a batch split over the ranks of ``group`` (None: the
    default group), and the loss and its gradient are the global
    batch's."""
    x = logits.reshape(-1)
    plain64 = x.dtype == torch.float64 and x.device.type == "cpu"
    if x.dtype not in KERNEL_DTYPES and not plain64:
        x = x.to(torch.float32)
    t = targets.reshape(-1)
    t_dtype = torch.float64 if plain64 else torch.float32
    if t.dtype != t_dtype:
        t = t.to(t_dtype)
    x, t = x.contiguous(), t.contiguous()
    hyper = (float(beta), float(focal_gamma), float(focal_alpha),
             float(dice_smooth))
    mesh = None if n_total is None else (group, int(n_total))
    if x.device.type == "cpu":
        return FocalDiceLossReferenceFn.apply(x, t, *hyper, mesh)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return FocalDiceLossFn.apply(x, t, *hyper, mesh)
