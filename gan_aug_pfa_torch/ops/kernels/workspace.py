"""Scratch memory that a kernel's launches on one (device, stream) share,
and the buffers of one call.

The fused FocalDice forward and the confusion counts are one launch each:
their blocks meet through integer tickets in a workspace that must be zero
when a launch starts, and each launch leaves it at zero when it ends.  So
the workspace is zeroed once, by ``torch.zeros`` on the stream itself at
first use, and kept for that (device, stream); it grows (a new zeroed
buffer) when a launch needs more.  Inside a CUDA-graph capture a call
takes its own zeroed buffer instead, its output in the same allocation:
the graph then holds one memset node and the kernel, zeroes the buffer
before each replay, no two graphs share a ticket, and eager calls on the
capturing stream never meet a ticket a graph left.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Sequence, Tuple

import torch


def on(device: torch.device):
    """``device`` made current only where it is not already."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


class Workspaces:
    """One kernel's zeroed workspaces of ``dtype`` (4-byte elements), one
    per (device index, stream handle)."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self._bufs: Dict[Tuple[int, int], torch.Tensor] = {}

    def __iter__(self) -> Iterator[Tuple[int, int]]:
        return iter(self._bufs)

    def persistent(self, device: torch.device, stream: int,
                   numel: int) -> torch.Tensor:
        """The workspace of ``stream`` on ``device``, at least ``numel``
        elements, zeroed on that stream when it is made or grown."""
        key = (device.index, stream)
        ws = self._bufs.get(key)
        if ws is None or ws.numel() < numel:
            ws = self._bufs[key] = torch.zeros(numel, dtype=self.dtype,
                                               device=device)
        return ws

    def call_buffers(self, device: torch.device, stream: int,
                     out_shape: Sequence[int], out_dtype: torch.dtype,
                     numel: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(output, workspace) of one call on ``stream``, the current
        stream of ``device``: an empty output and the persistent workspace,
        or, while the stream is capturing a CUDA graph, views of one zeroed
        buffer (the output first, padded to 32 bytes)."""
        if torch.cuda.is_current_stream_capturing():
            n = math.prod(out_shape)
            pad = -(-n // 8) * 8
            buf = torch.zeros(pad + numel, dtype=self.dtype, device=device)
            return buf[:n].view(out_dtype).view(out_shape), buf[pad:]
        return (torch.empty(out_shape, dtype=out_dtype, device=device),
                self.persistent(device, stream, numel))
