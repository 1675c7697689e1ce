"""Mesh construction over ranks: the JAX package's ``make_mesh``,
``make_production_mesh`` and ``single_device_mesh``.

Under ``torch.distributed`` (``distributed.init_world``) a mesh with no
devices given spans the world's ranks and has a process group for each
axis; without it, the one device of the run. Mesh convention, as in the
reference:
  single-pod: (16, 16)    axes ('data', 'model')
  multi-pod:  (2, 16, 16) axes ('pod', 'data', 'model')
'model' carries the expert split; 'data' and 'pod' carry the batch rows.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

from repro_torch import resolve_device
from repro_torch.distributed import (Mesh, device_array, in_world,
                                     mesh_over_world, world_devices)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's 256- or 512-rank mesh over the world; fewer ranks
    raise ``ValueError``, as ``jax.make_mesh`` does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = len(world_devices()) if in_world() else 1
    if n < math.prod(shape):
        raise ValueError(f"Number of devices {n} must be >= the product of "
                         f"mesh_shape {shape}")
    return make_mesh(shape, axes)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[list] = None) -> Mesh:
    """Arbitrary mesh over the first ``prod(shape)`` of ``devices``;
    raises the reference's ``AssertionError`` when there are fewer devices
    than the shape needs. Without ``devices``: the world's ranks under
    ``torch.distributed`` (a mesh then spans all of them, with its
    groups), else the one device the run uses."""
    world = devices is None and in_world()
    if devices is None:
        devices = world_devices() if world else [resolve_device(None)]
    if len(devices) < math.prod(shape):
        raise AssertionError((len(devices), tuple(shape)))
    if world:
        return mesh_over_world(shape, axes)
    return Mesh(device_array(devices, shape), tuple(axes))


def single_device_mesh(device=None) -> Mesh:
    """A 1 x 1 ("data", "model") mesh of ``device`` (default: the card),
    without groups."""
    return Mesh(device_array([resolve_device(device)], (1, 1)),
                ("data", "model"))
