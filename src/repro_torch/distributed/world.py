"""Ranks and their mesh: the process group of the run, and a ``Mesh`` that
lays the ranks out on named axes with one process group per axis.

``init_world`` starts ``torch.distributed`` (every group it and the mesh
make has the given timeout, 60 s by default, so that a rank that fails
fails its peers' next collective instead of hanging them) and records each
rank's device; ``init_world_from_env`` starts it from the environment
``torchrun`` sets, with NCCL where every rank has a card of its own (the
ranks swap their cards' UUIDs first) and gloo else. A mesh over the world's ranks (``mesh_over_world``,
``elastic_remesh`` and ``launch.mesh.make_mesh`` with no devices given)
has a process group for each axis and, where a mesh has both 'pod' and
'data', one for the two together; rank ``r`` sits at
``unravel_index(r, shape)``, so the last axis ('model') is the innermost.
A mesh of devices given by the caller, or of the one device of a run
without ``torch.distributed``, has no groups: it records devices and axis
names only. A fake world (``init_world("fake", ...)``) is one process
standing for one rank of many: its groups are made as for gloo and NCCL,
and its collectives move nothing.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.meshctx import DATA_AXES

DEFAULT_TIMEOUT = datetime.timedelta(seconds=60)

Axes = Union[str, Sequence[str]]

# this process's rank: its devices and the timeout of its groups, set by
# ``init_world`` beside torch.distributed's own process-wide state
_WORLD: Dict[str, object] = {}


def _key(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices laid out on named axes: ``devices`` is a numpy object array
    of ``torch.device``s, one axis per name. ``shape`` maps each axis name
    to its size, as ``jax.sharding.Mesh.shape`` does. ``groups`` maps a
    tuple of axis names to this rank's process group along them, and
    ``coords`` is this rank's index on each axis; both are empty without
    ``torch.distributed``."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    groups: Dict[Tuple[str, ...], object] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)
    coords: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim} mesh axes, "
                             f"{len(self.axis_names)} names "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def size(self, axes: Axes) -> int:
        """The number of ranks along ``axes`` (1 for no axes)."""
        return math.prod(self.shape[a] for a in _key(axes))

    def index(self, axes: Axes) -> int:
        """This rank's index along ``axes`` taken together (row-major), 0
        on a mesh without groups."""
        if not self.coords:
            return 0
        names = _key(axes)
        return int(np.ravel_multi_index(
            [self.coords[self.axis_names.index(a)] for a in names],
            [self.shape[a] for a in names])) if names else 0

    def group(self, axes: Axes):
        """This rank's process group along ``axes``: None where the axes
        hold one rank; a mesh without groups that spans more raises."""
        names = _key(axes)
        missing = [a for a in names if a not in self.axis_names]
        if missing:
            raise KeyError(f"mesh axes {self.axis_names} have no {missing}")
        if self.size(names) == 1:
            return None
        if names not in self.groups:
            raise RuntimeError(
                f"mesh {self.shape} has no process group for {names}: "
                "build it over the world's ranks after init_world")
        return self.groups[names]


def device_array(devices: Sequence, shape: Sequence[int]) -> np.ndarray:
    """The first ``prod(shape)`` of ``devices`` as an object array of
    ``shape``."""
    n = int(np.prod(shape))
    out = np.empty(n, dtype=object)
    out[:] = [torch.device(d) for d in devices[:n]]
    return out.reshape(tuple(shape))


def in_world() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_world(backend: str, *, device, rank: int = -1,
               world_size: int = -1, init_method: Optional[str] = None,
               store=None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Start ``torch.distributed`` with ``backend`` for this rank on
    ``device`` (``rank`` and ``world_size`` default to the environment's
    ``RANK`` and ``WORLD_SIZE``, as ``torchrun`` sets them; the rendezvous
    is ``init_method``, or ``store``, or ``env://``), and record every
    rank's device. The backend is the caller's choice: NCCL for a card per
    rank, gloo for ranks on the CPU or sharing a card
    (``init_world_from_env`` chooses).

    ``"fake"`` is a world of one process: this rank alone, whose
    collectives return at once and move nothing (``FakeStore`` by
    default, every rank's device this one's). The dry run traces one rank
    of a production mesh in it, on ``meta`` tensors; ``backend_for``
    never picks it."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    if backend == "fake":
        # registers the backend and its store with torch.distributed
        from torch.testing._internal.distributed.fake_pg import FakeStore
        store = store if store is not None else FakeStore()
    if store is None and init_method is None:
        init_method = "env://"
    dist.init_process_group(backend, init_method=init_method, store=store,
                            rank=rank, world_size=world_size,
                            timeout=timeout)
    if backend == "fake":
        names = [str(device)] * dist.get_world_size()
    else:
        names: List[Optional[str]] = [None] * dist.get_world_size()
        dist.all_gather_object(names, str(device))
    _WORLD.update(devices=[torch.device(n) for n in names], timeout=timeout,
                  backend=backend)


def card_id(device: torch.device) -> Optional[str]:
    """The UUID of ``device``'s card (None for the CPU): two ranks share a
    card where their ids are equal, whatever each one's
    ``CUDA_VISIBLE_DEVICES`` numbers it."""
    if device.type != "cuda":
        return None
    return str(torch.cuda.get_device_properties(device).uuid)


def backend_for(cards: Sequence[Optional[str]]) -> str:
    """NCCL where every rank runs on a card of its own (``card_id`` of
    each rank's device), else gloo: ranks on the CPU, or ranks sharing a
    card, which NCCL refuses."""
    own = all(c is not None for c in cards) and len(set(cards)) == len(cards)
    return "nccl" if own else "gloo"


def init_world_from_env(device, *,
                        timeout: datetime.timedelta = DEFAULT_TIMEOUT
                        ) -> str:
    """Start ``torch.distributed`` from the environment ``torchrun`` sets
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) for this
    rank on ``device``: the ranks first swap their cards' ids through the
    rendezvous store (``torch.distributed.rendezvous``, which joins the
    store of ``torchrun``'s agent where there is one), and every rank
    starts the backend that ``backend_for`` picks from the same list.
    Returns the backend."""
    store, rank, world = next(dist.rendezvous("env://", timeout=timeout))
    cards = dist.PrefixStore("cards", store)
    cards.set(str(rank), card_id(torch.device(device)) or "cpu")
    ids = [cards.get(str(r)).decode() for r in range(world)]
    backend = backend_for([None if c == "cpu" else c for c in ids])
    init_world(backend, device=device, rank=rank, world_size=world,
               store=dist.PrefixStore("world", store), timeout=timeout)
    return backend


def world_backend() -> Optional[str]:
    """The backend ``init_world`` started, None outside a world."""
    return _WORLD.get("backend") if in_world() else None


def shutdown_world() -> None:
    """Tear down what ``init_world`` started."""
    if in_world():
        dist.destroy_process_group()
    _WORLD.clear()


def world_devices() -> List[torch.device]:
    """Each rank's device, in rank order."""
    if "devices" not in _WORLD:
        raise RuntimeError("torch.distributed was not started by "
                           "init_world: the ranks' devices are unknown")
    return list(_WORLD["devices"])


def _subgroups(ranks: np.ndarray, axes: Sequence[int]):
    """This rank's group among the groups that vary ``axes`` of the rank
    grid ``ranks`` and hold the other axes fixed."""
    lead = [i for i in range(ranks.ndim) if i not in axes]
    lists = ranks.transpose(lead + list(axes)).reshape(
        -1, math.prod(ranks.shape[i] for i in axes)).tolist()
    group, _ = dist.new_subgroups_by_enumeration(
        lists, timeout=_WORLD.get("timeout", DEFAULT_TIMEOUT))
    return group


def mesh_over_world(shape: Sequence[int], axis_names: Sequence[str]
                    ) -> Mesh:
    """A mesh of ``shape`` over every rank of the world, with its groups.
    Every rank must call it, in the same order as its other groups."""
    shape, names = tuple(int(s) for s in shape), tuple(axis_names)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of {shape} over a world of {world} "
                         "ranks: a mesh spans every rank")
    ranks = np.arange(world).reshape(shape)
    groups = {(a,): _subgroups(ranks, [i]) for i, a in enumerate(names)}
    data = [names.index(a) for a in DATA_AXES if a in names]
    if len(data) > 1:
        groups[tuple(names[i] for i in data)] = _subgroups(ranks, data)
    coords = tuple(int(c) for c in np.unravel_index(dist.get_rank(), shape))
    return Mesh(device_array(world_devices(), shape), names, groups, coords)
