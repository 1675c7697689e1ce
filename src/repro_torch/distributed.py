"""Host-side helpers of the training loop: copies of the JAX package's
``StragglerMonitor`` and ``PreemptionGuard``, and the one-device part of
its mesh tooling: ``elastic_remesh`` (the reference's arithmetic over the
device the run uses) and ``timed_step``. A ``Mesh`` here only records
devices and axis names: nothing is sharded on one device."""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device


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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices laid out on named axes: ``devices`` is a numpy object array
    of ``torch.device``s, one axis per name. ``shape`` maps each axis name
    to its size, as ``jax.sharding.Mesh.shape`` does."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim} mesh axes, "
                             f"{len(self.axis_names)} names "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def device_array(devices: Sequence, shape: Sequence[int]) -> np.ndarray:
    """The first ``prod(shape)`` of ``devices`` as an object array of
    ``shape``."""
    n = int(np.prod(shape))
    out = np.empty(n, dtype=object)
    out[:] = [torch.device(d) for d in devices[:n]]
    return out.reshape(tuple(shape))


def elastic_remesh(preferred_shape: Sequence[int],
                   axis_names: Sequence[str], *,
                   devices: Optional[List] = None) -> Mesh:
    """The largest mesh of the preferred shape that ``devices`` support
    (default: the one device the run uses): the leading (data-like) axis
    shrinks to what the devices leave after the model axes, the
    reference's arithmetic. One device gives 1 x 1 for ``(4, 1)``; a
    model dimension above 1 raises the reference's ``AssertionError``
    (raised, not asserted, so that ``-O`` keeps it)."""
    devices = devices if devices is not None else [resolve_device(None)]
    n = len(devices)
    shape = list(preferred_shape)
    model = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    if n % model:
        raise AssertionError(f"{n} devices cannot host model dim {model}")
    shape[0] = n // model
    return Mesh(device_array(devices, shape), tuple(axis_names))


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def timed_step(fn: Callable, *args, **kw):
    """``(fn(*args, **kw), seconds)`` on the host's clock, read after the
    devices of the output's tensors have finished their queued work."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    for dev in {t.device for t in _tensors(out)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0
