"""The distributed runtime: ranks and their mesh (``world``), the current
mesh and the logical axis rules (``meshctx``), placements, the elastic
re-mesh and the cut of a tree over 'model' (``sharding``), the
collectives of the expert- and tensor-parallel paths (``collectives``), and the host-side helpers of the training loop:
copies of the JAX package's ``StragglerMonitor`` and ``PreemptionGuard``,
and ``timed_step``."""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, List, Sequence

import numpy as np
import torch

from repro_torch.distributed.meshctx import (Placement, data_axes,
                                             get_current_mesh,
                                             logical_to_spec, mesh_context,
                                             set_current_mesh)
from repro_torch.distributed.sharding import (batch_spec, deferred,
                                              deferred_block,
                                              elastic_remesh, model_dims,
                                              param_shardings, rank_dims,
                                              replicated, seq_sharded_cache,
                                              shard_tree,
                                              split_global_norm,
                                              unshard_tree)
from repro_torch.distributed.world import (DEFAULT_TIMEOUT, Mesh,
                                           backend_for, card_id,
                                           device_array, in_world,
                                           init_world, init_world_from_env,
                                           mesh_over_world, shutdown_world,
                                           world_backend, world_devices)


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
