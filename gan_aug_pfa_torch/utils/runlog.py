"""Machine-readable run log (the JAX package's ``utils/runlog.py``, an own
copy): ``--log-jsonl FILE`` appends one flushed JSON object per event
(``run_start``, ``epoch``, ``best_snapshot``, ``checkpoint``, ``sample``,
``preemption``, ``early_stop``, ``run_end``).  ``--resume`` appends to the
same file.  ``scripts/summarize_runlog.py`` renders it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

import torch


def _coerce(v: Any):
    """JSON fallback for tensors, numpy scalars and arrays, and any other
    leaf (as its ``str``)."""
    if isinstance(v, torch.Tensor):
        return v.item() if v.dim() == 0 else v.tolist()
    if hasattr(v, "item") and getattr(v, "ndim", None) in (None, 0):
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    return str(v)


class JsonlRunLog:
    """Append-only JSONL event stream: each event is one line ``{"ts":
    <unix seconds>, "event": <name>, ...fields}``, flushed, so a crash
    loses at most the line in flight and ``tail -f`` follows the run."""

    def __init__(self, path: str, append: bool = False):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a" if append else "w")

    def log(self, event: str, **fields: Any) -> None:
        rec = {"ts": round(time.time(), 3), "event": event, **fields}
        self._f.write(json.dumps(rec, default=_coerce) + "\n")
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "JsonlRunLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_run_log(path: Optional[str], append: bool = False
                 ) -> Optional[JsonlRunLog]:
    """A ``JsonlRunLog`` when ``path`` is set, else None (no log)."""
    return JsonlRunLog(path, append=append) if path else None
