"""Host-side fault-tolerance helpers of the training loop (a copy of the
JAX package's ``StragglerMonitor``; the port has no mesh yet)."""
from __future__ import annotations

import dataclasses
from typing import List

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
