"""Step timing, traces and finite checks (the JAX package's
``utils/profiling.py``, for torch):

  * ``StepTimer``: per-step wall-clock statistics (mean, p50, p95,
    items/s), with the first steps (warm-up: cuDNN's algorithm search,
    first kernel loads) kept apart;
  * ``trace(log_dir)``: a ``torch.profiler`` trace of the host and the
    card, written into ``log_dir`` as a Chrome trace;
  * ``annotate(name)``: a named host range on that trace;
  * ``enable_nan_checks(trainer)`` and ``nan_guard``: the finite check of
    each step's loss and gradients, the counterpart of the JAX package's
    ``jax_debug_nans`` sanitizer.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Dict, List, Optional

import torch


class StepTimer:
    """Collects per-step wall times; reports throughput statistics.

        timer = StepTimer(items_per_step=batch_size)
        with timer.step():
            loss = train_step(...)
            torch.cuda.synchronize()
        print(timer.summary())

    The caller syncs inside the step, so that a time includes the card's
    work."""

    def __init__(self, items_per_step: int = 1, skip_first: int = 1):
        self.items_per_step = items_per_step
        # The first steps warm up (the JAX package's compile); they are
        # kept out of the statistics and reported as compile_s.
        self.skip_first = skip_first
        self.times: List[float] = []
        self.warmup_times: List[float] = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        if len(self.warmup_times) < self.skip_first:
            self.warmup_times.append(dt)
        else:
            self.times.append(dt)

    def _percentile(self, q: float) -> float:
        if not self.times:
            return math.nan
        s = sorted(self.times)
        k = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
        return s[k]

    def summary(self) -> Dict[str, float]:
        n = len(self.times)
        total = sum(self.times)
        mean = total / n if n else math.nan
        return {
            "steps": n,
            "mean_s": mean,
            "p50_s": self._percentile(0.50),
            "p95_s": self._percentile(0.95),
            "total_s": total,
            "items_per_s": (
                self.items_per_step / mean if n and mean > 0 else math.nan
            ),
            "compile_s": sum(self.warmup_times),
        }

    def format_summary(self, prefix: str = "") -> str:
        s = self.summary()
        return (
            f"{prefix}{s['steps']} steps: mean {s['mean_s'] * 1e3:.2f} ms, "
            f"p50 {s['p50_s'] * 1e3:.2f} ms, p95 {s['p95_s'] * 1e3:.2f} ms, "
            f"{s['items_per_s']:.1f} items/s "
            f"(first-step compile {s['compile_s']:.1f} s)"
        )


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` trace of everything inside the context: host ops
    and, with a card, its kernels and copies.  Written on exit as
    ``<log_dir>/trace_<pid>_<unix ms>.pt.trace.json`` (Chrome trace format;
    open it in Perfetto or chrome://tracing).  A no-op when ``log_dir`` is
    falsy, so callers pass the config value straight through."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}"
                     ".pt.trace.json"))


def annotate(name: str):
    """Named host range that shows on the trace's timeline."""
    return torch.profiler.record_function(name)


def enable_nan_checks(trainer) -> None:
    """Check every train step of ``trainer`` for non-finite values: the
    loss and, before each optimizer step, every parameter's gradient, so
    that a NaN never reaches the weights.  A failing step raises
    ``FloatingPointError`` naming the epoch, the step and the first
    non-finite tensors.  Costs one device sync an optimizer step:
    debugging only."""
    trainer.nan_checks = True


def step_guard(loss: torch.Tensor, model: torch.nn.Module,
               where: str) -> None:
    """``nan_guard`` of a step's loss and of ``model``'s parameter
    gradients, named ``"loss"`` and ``"grad <parameter>"``: call it after
    the backward and before the optimizer step."""
    grads = {f"grad {name}": p.grad for name, p in model.named_parameters()
             if p.grad is not None}
    nan_guard({"loss": loss, **grads}, where)


def _named_leaves(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}.{i}" if prefix else str(i))
    else:
        yield prefix, tree


def nan_guard(tensors, where: str = "") -> None:
    """Raise ``FloatingPointError`` naming the first (up to 5) non-finite
    floating-point tensors of ``tensors`` (a tensor, or dicts and lists of
    them; dict keys name the leaves).  One device-to-host copy for all;
    other leaves are ignored."""
    named = [(name, t) for name, t in _named_leaves(tensors)
             if isinstance(t, torch.Tensor)
             and (t.is_floating_point() or t.is_complex())]
    if not named:
        return
    finite = torch.stack([torch.isfinite(t).all() for _, t in named])
    bad = [name for (name, _), ok in zip(named, finite.tolist()) if not ok]
    if bad:
        raise FloatingPointError(
            f"non-finite values {('in ' + where) if where else ''}: "
            f"{bad[:5]}"
        )
