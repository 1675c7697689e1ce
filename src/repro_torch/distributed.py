"""Host-side fault-tolerance helpers of the training loop: copies of the
JAX package's ``StragglerMonitor`` and ``PreemptionGuard``. The port has
no mesh yet (ROADMAP A.11)."""
from __future__ import annotations

import dataclasses
import signal
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class StragglerMonitor:
    """Rolling step-time tracker; flags outlier steps (straggling hosts show
    up as slow collective completion on every peer, so each host can detect
    locally)."""

    window: int = 50
    threshold: float = 2.0
    _times: List[float] = dataclasses.field(default_factory=list)

    def record(self, seconds: float) -> bool:
        """Record one step; returns True if this step was a straggler event."""
        self._times.append(seconds)
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) < 8:
            return False
        med = float(np.median(self._times))
        return seconds > self.threshold * med

    @property
    def median(self) -> float:
        return float(np.median(self._times)) if self._times else 0.0


class PreemptionGuard:
    """SIGTERM (or the given signals) -> set ``requested``; the training
    loop checkpoints and exits cleanly at the next step boundary.
    ``restore`` puts the previous handlers back."""

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,)):
        self.requested = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except (ValueError, OSError):
                pass  # not the main thread, or unsupported

    def _handler(self, signum, frame):
        self.requested = True

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)
