"""Per-sample confusion counts: the CUDA kernel's wrapper, its launch plan
and its plain PyTorch version.

Replaces the TPU kernel ``gan_aug_pfa_tpu/ops/pallas_kernels/metrics.py:
confusion_counts_batch``: (B, H, W) float32 probabilities and binary
targets -> (B, 4) float32 [tp, fp, fn, tn] at ``p > threshold`` (strict)
and ``t > 0.5``.  The kernel (``csrc/confusion_counts.cu``) writes the
(B, 4) rows itself, in one launch: its blocks add their int32 counts to a
slot of a workspace per (device, stream) (``workspace.Workspaces``), and
the last block of each sample derives fp, fn and tn and resets the slot.
A call allocates only its output and launches nothing else.

Bound by bytes: it reads 8*B*H*W bytes, 262 KB at the evaluation shape
(B=2, 128x128), about 78 ns at 3.35 TB/s, so a launch costs more than the
work there (see the source's note).

``plan_launch`` makes the launch (threads, blocks a sample, and where the
16-byte groups start) from the shape and the two pointers' alignment.
``confusion_counts_batch`` dispatches on the tensors' device: CUDA tensors
always go to the kernel (a failed build, a refused plan or a failed launch
raises), CPU tensors to ``confusion_counts_batch_reference``.
``confusion_counts_batch.calls`` and ``.launches`` count the calls and the
kernel launches: one a call.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from . import build
from .workspace import Workspaces, on

NAME = "confusion_counts"
# H*W must stay below 2^24 so that float32 holds the counts exactly.
MAX_PIXELS = 1 << 24
MAX_BATCH = 65535  # the grid's second dimension
# The grid's limits, as csrc/confusion_counts.cu checks them: THREADS
# threads a block at most, BLOCKS_PER_SM resident blocks on each of the
# H100's 132 SMs, a sample's blocks at most MAX_BLOCKS; a thread loads
# UNROLL groups of VEC floats (16 bytes each from p and from t) before it
# counts them.  A sample's workspace slot is SLOT_INTS int32.
SMS = 132
THREADS = 256
MIN_THREADS = 32
BLOCKS_PER_SM = 4
MAX_BLOCKS = SMS * BLOCKS_PER_SM
VEC = 4
UNROLL = 2
SLOT_INTS = 4


def _check(probs: torch.Tensor, targets: torch.Tensor) -> None:
    for name, t in (("probs", probs), ("targets", targets)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be (B, H, W), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if probs.shape != targets.shape:
        raise ValueError(f"shape mismatch: probs {tuple(probs.shape)}, "
                         f"targets {tuple(targets.shape)}")
    if probs.device != targets.device:
        raise ValueError(f"device mismatch: probs on {probs.device}, "
                         f"targets on {targets.device}")
    b, h, w = probs.shape
    if h * w >= MAX_PIXELS:
        raise ValueError(f"H*W = {h * w} must be < 2^24 for exact counts")
    if b > MAX_BATCH:
        raise ValueError(f"batch {b} exceeds {MAX_BATCH}")


def _derive(counts: torch.Tensor, hw: int) -> torch.Tensor:
    """(B, 3) int32 [tp, sum p, sum t] -> (B, 4) float32 [tp, fp, fn, tn]."""
    tp, sum_p, sum_t = counts.unbind(1)
    return torch.stack(
        [tp, sum_p - tp, sum_t - tp, hw - sum_p - sum_t + tp], dim=1
    ).to(torch.float32)


def confusion_counts_batch_reference(probs: torch.Tensor,
                                     targets: torch.Tensor,
                                     threshold: float = 0.5) -> torch.Tensor:
    """Plain PyTorch version: the same counts, the same way."""
    _check(probs, targets)
    p = probs > threshold
    t = targets > 0.5
    counts = torch.stack(
        [(p & t).sum(dim=(1, 2)), p.sum(dim=(1, 2)), t.sum(dim=(1, 2))],
        dim=1,
    ).to(torch.int32)
    return _derive(counts, probs.shape[1] * probs.shape[2])


# -- the launch plan -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CountsPlan:
    """One launch: a grid of (``blocks``, B) blocks of ``threads``
    threads; each sample's blocks take its elements [0, head) one at a
    time, then ``groups`` groups of VEC elements 16 bytes at a time, then
    the rest one at a time.  They meet in one 64-bit word a sample, each
    count ``field_bits`` wide under the ticket, or (``field_bits`` 0) in
    three int32 counts and a ticket.  The workspace needs
    ``workspace_ints`` int32."""

    threads: int
    blocks: int
    head: int
    groups: int
    field_bits: int
    workspace_ints: int

    def c_args(self) -> Tuple[int, int, int, int, int]:
        """(threads, blocks, head, groups, field_bits), the C entry
        point's plan arguments."""
        return (self.threads, self.blocks, self.head, self.groups,
                self.field_bits)


@functools.lru_cache(maxsize=1024)
def plan_launch(b: int, hw: int, p_offset: int, t_offset: int) -> CountsPlan:
    """The plan for B samples of ``hw`` float32 elements whose
    probabilities start ``p_offset`` and whose targets start ``t_offset``
    bytes past a 16-byte boundary.

    ``head`` is the fewest leading elements after which both are 16-byte
    aligned; ``hw`` (no groups) where no count is, or where B > 1 and hw
    is not a multiple of VEC (the samples do not share one alignment).  A
    thread takes UNROLL groups (one element where there are none) in
    blocks of MIN_THREADS to THREADS threads, as many blocks a sample as
    fill the SMs, up to BLOCKS_PER_SM blocks of THREADS an SM: 64 blocks
    of 32 a sample at 2x128x128, 8 of 256 at 16x128x128 (128 blocks
    each), 33 of 256 at 16x1024x1024, every thread then walking about 16
    iterations.  The counts and the ticket share one 64-bit word where
    they fit (``field_bits`` = bits of hw): at 128x128, not at
    1024x1024."""
    if b < 1 or hw < 1 or b > MAX_BATCH:
        raise ValueError(f"no plan for {b} samples of {hw} elements")
    if (not 0 <= p_offset < 16 or not 0 <= t_offset < 16 or p_offset % 4
            or t_offset % 4):
        raise ValueError(f"no plan for probabilities at offset {p_offset} "
                         f"and targets at offset {t_offset}")
    head = next((h for h in range(VEC) if (p_offset + 4 * h) % 16 == 0
                 and (t_offset + 4 * h) % 16 == 0), hw)
    if b > 1 and hw % VEC:
        head = hw
    head = min(head, hw)
    groups = (hw - head) // VEC
    items = groups or hw
    per_thread = UNROLL if groups else 1
    # Enough threads for the whole batch on the SMs, but no more than one
    # sample has work for.
    threads = max(MIN_THREADS, min(THREADS, 32 * -(
        -b * items // (per_thread * 32 * SMS)), 32 * -(
        -items // (per_thread * 32))))
    blocks = max(1, min(-(-MAX_BLOCKS // b),
                        -(-items // (threads * per_thread))))
    field_bits = hw.bit_length()
    if 3 * field_bits + blocks.bit_length() > 64:
        field_bits = 0
    return CountsPlan(threads, blocks, head, groups, field_bits,
                      SLOT_INTS * b)


def plan_for(probs: torch.Tensor, targets: torch.Tensor) -> CountsPlan:
    """``plan_launch`` for checked (B, H, W) tensors' data pointers."""
    b, h, w = probs.shape
    return plan_launch(b, h * w, probs.data_ptr() % 16,
                       targets.data_ptr() % 16)


# -- the kernel ------------------------------------------------------------


def bind(lib: ctypes.CDLL):
    """The C entry point of a loaded library built from
    csrc/confusion_counts.cu, with its argument types."""
    fn = lib.confusion_counts
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel():
    """This tree's entry point, built and bound on first use."""
    lib = build.load(NAME)
    lib.confusion_counts_slot_ints.restype = ctypes.c_int
    slot = lib.confusion_counts_slot_ints()
    if slot != SLOT_INTS:
        raise RuntimeError(f"{NAME}: the library's slot is {slot} ints, "
                           f"the wrapper's {SLOT_INTS}")
    return bind(lib)


_workspaces = Workspaces(torch.int32)


def launch(probs: torch.Tensor, targets: torch.Tensor,
           threshold: float) -> torch.Tensor:
    """The kernel, one launch, on checked non-empty CUDA tensors: the
    (B, 4) float32 counts on the device, without a host sync."""
    fn = _kernel()
    device = probs.device
    b, h, w = probs.shape
    plan = plan_for(probs, targets)
    with on(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        out, ws = _workspaces.call_buffers(device, stream, (b, 4),
                                           torch.float32, plan.workspace_ints)
        err = fn(probs.data_ptr(), targets.data_ptr(), threshold, b, h * w,
                 *plan.c_args(), out.data_ptr(), ws.data_ptr(), ws.numel(),
                 stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    return out


def confusion_counts_batch(probs: torch.Tensor, targets: torch.Tensor,
                           threshold: float = 0.5) -> torch.Tensor:
    """(B, H, W) float32 probs and binary targets -> (B, 4) float32
    [tp, fp, fn, tn]."""
    _check(probs, targets)
    device = probs.device
    if device.type == "cpu":
        return confusion_counts_batch_reference(probs, targets, threshold)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    confusion_counts_batch.calls += 1
    if probs.numel() == 0:  # no pixels (or no samples): nothing to count
        return torch.zeros((probs.shape[0], 4), dtype=torch.float32,
                           device=device)
    out = launch(probs, targets, float(threshold))
    confusion_counts_batch.launches += 1
    return out


confusion_counts_batch.calls = 0
confusion_counts_batch.launches = 0
