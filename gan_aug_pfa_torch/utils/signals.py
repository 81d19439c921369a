"""Preemption-safe training (the JAX package's ``utils/signals.py``, an own
copy): the first SIGTERM or SIGINT only latches a flag; the epoch loop
sees it at the next epoch boundary, writes the resume state and returns,
so that ``--resume`` continues from that epoch.  A second signal falls
through to the previous handler (ctrl-C twice still kills).  Under a data
mesh the ranks agree (``GracefulShutdown.agreed``): a signal that reached
one rank stops them all after the same epoch.
"""

from __future__ import annotations

import signal


class GracefulShutdown:
    """Context manager: latch SIGTERM/SIGINT into ``requested``.

    CPython delivers signals to the main thread only; entered from any
    other thread the guard installs nothing and never triggers."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._previous = {}
        self.requested = False
        self.signum = None

    def _handle(self, signum, frame):
        if self.requested:
            # Second signal: the original disposition.
            prev = self._previous.get(signum)
            if callable(prev):
                prev(signum, frame)
                return
            if prev == signal.SIG_DFL:
                signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)
                return
            return  # SIG_IGN
        self.requested = True
        self.signum = signum
        print(
            f"\nReceived signal {signal.Signals(signum).name}: finishing "
            "the current epoch, saving resume state, then exiting. "
            "Signal again to stop immediately."
        )

    def agreed(self, mesh=None) -> bool:
        """``requested`` here, or under a data mesh (``parallel/mesh.py``)
        on any rank: every rank stops after the same epoch."""
        if mesh is None:
            return self.requested
        return mesh.agree(self.requested)

    def __enter__(self):
        try:
            for s in self._signals:
                self._previous[s] = signal.signal(s, self._handle)
        except ValueError:  # not the main thread: stay inert
            self._previous = {}
        return self

    def __exit__(self, *exc):
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous = {}
        return False
