"""Mesh construction for one device: the JAX package's ``make_mesh`` and
``single_device_mesh`` over ``torch.device``s. Its ``make_production_mesh``
(a 256- or 512-chip pod) has no counterpart on one card.

A ``distributed.Mesh`` records devices and axis names only; the training
launcher builds one for ``--mesh-shape`` and runs on its single device.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

from repro_torch import resolve_device
from repro_torch.distributed import Mesh, device_array


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[list] = None) -> Mesh:
    """Arbitrary mesh over the first ``prod(shape)`` of ``devices``
    (default: the one device the run uses); raises the reference's
    ``AssertionError`` when there are fewer devices than the shape needs."""
    devices = devices if devices is not None else [resolve_device(None)]
    if len(devices) < math.prod(shape):
        raise AssertionError((len(devices), tuple(shape)))
    return Mesh(device_array(devices, shape), tuple(axes))


def single_device_mesh(device=None) -> Mesh:
    """A 1 x 1 ("data", "model") mesh of ``device`` (default: the card)."""
    return Mesh(device_array([resolve_device(device)], (1, 1)),
                ("data", "model"))
