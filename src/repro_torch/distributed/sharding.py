"""Placements of parameters and batches on a mesh, the elastic re-mesh,
and the launcher's cut of a tree into its rank's part: the placement
functions of the JAX package's ``distributed/sharding.py``.

A placement is the counterpart of a ``PartitionSpec`` (``meshctx``). XLA
takes a ``NamedSharding`` as an instruction; here a placement is a
statement of where each dimension lives, and the launcher acts on the
part it runs: the batch rows over the data axes, and over 'model' the
dimension ``model_dims`` gives each leaf (experts, heads, kv-heads, MLP,
vocabulary or rank, as ``param_shardings`` places them). The rank
program (``models/tp.py``, ``models/moe.py``) carries out
the reference's Megatron-style split that XLA's partitioner derives.
``rank_dims`` is ``model_dims`` less the leaves that the rank program
does not run split yet (``deferred``): those are held whole on every
rank of the axis, the same function computed on each. ``fsdp=True`` is
placement arithmetic only.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed.meshctx import (Placement, data_axes,
                                             logical_to_spec)
from repro_torch.distributed.world import (Mesh, device_array, in_world,
                                           mesh_over_world, world_devices)
from repro_torch.models import common as cm

PyTree = Any


def _is_axes_leaf(x) -> bool:
    """A logical-axes tuple: a plain tuple of axis names and None.
    NamedTuples (the optimizer states) are containers."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(e is None or isinstance(e, str) for e in x))


def _is_shape_leaf(x) -> bool:
    return hasattr(x, "shape") or (isinstance(x, tuple) and all(
        isinstance(i, int) for i in x))


def _fits(mesh: Mesh, dims: Sequence[int], spec: Placement) -> List:
    """``spec`` padded to ``dims`` with the entries whose axes do not
    divide their dimension held whole."""
    out = []
    for d, entry in zip(dims, tuple(spec) + (None,) * (len(dims) - len(spec))):
        out.append(entry if entry is None or d % mesh.size(entry) == 0
                   else None)
    return out


def param_shardings(mesh: Mesh, axes: PyTree, shapes: PyTree = None, *,
                    fsdp: bool = False) -> PyTree:
    """The placement of every leaf of a logical-axes tree (leaves: tuples
    of names). With ``shapes`` (a matching tree of shape tuples, tensors
    or ``ParamSpec``s), a dimension that does not divide its mesh axes is
    held whole (vocab 73448 on a 16-way 'model' axis). ``fsdp=True`` also
    places the last still-whole dimension of every leaf of 2 or more
    dimensions that the data axes divide over the data axes (ZeRO-3)."""
    d_axes = data_axes(mesh)
    d_size = mesh.size(d_axes)

    def spec_of(a, shape=None):
        p = logical_to_spec(mesh, a)
        if shape is None:
            return p
        dims = tuple(getattr(shape, "shape", shape))
        fixed = _fits(mesh, dims, p)
        if fsdp and d_axes and len(dims) >= 2:
            for i in range(len(dims) - 1, -1, -1):
                if (fixed[i] is None and dims[i] % d_size == 0
                        and dims[i] >= d_size):
                    fixed[i] = d_axes
                    break
        return tuple(fixed)

    if shapes is None:
        return cm.tree_map(spec_of, axes, is_leaf=_is_axes_leaf)
    shape_leaves = cm.tree_leaves(shapes, is_leaf=_is_shape_leaf)
    axes_leaves = cm.tree_leaves(axes, is_leaf=_is_axes_leaf)
    if len(shape_leaves) != len(axes_leaves):
        raise ValueError(f"{len(shape_leaves)} shapes for "
                         f"{len(axes_leaves)} axes leaves")
    it = iter(shape_leaves)
    return cm.tree_map(lambda a: spec_of(a, next(it)), axes,
                       is_leaf=_is_axes_leaf)


def batch_spec(mesh: Mesh, *, extra_dims: int = 1) -> Placement:
    """(B, S, ...) batch arrays: the rows over every data axis."""
    d = data_axes(mesh)
    return (d or None,) + (None,) * extra_dims



def replicated(mesh: Mesh) -> Placement:
    return ()


def seq_sharded_cache(mesh: Mesh, *, time_axis: int, ndim: int
                      ) -> Placement:
    """KV-cache placement for batch-1 long-context decode: the sequence
    over 'data'."""
    spec: List[Optional[tuple]] = [None] * ndim
    if "data" in mesh.axis_names:
        spec[time_axis] = ("data",)
    return tuple(spec)


def elastic_remesh(preferred_shape: Sequence[int],
                   axis_names: Sequence[str], *,
                   devices: Optional[List] = None) -> Mesh:
    """The largest mesh of the preferred shape that the devices support:
    the leading (data-like) axis takes what the devices leave after the
    model axes, the reference's arithmetic; a model dimension that does
    not divide the devices raises the reference's ``AssertionError``
    (raised, not asserted, so that ``-O`` keeps it). Without ``devices``
    the mesh spans the world's ranks under ``torch.distributed``, with its
    groups, and else the one device the run uses (the card)."""
    world = devices is None and in_world()
    if devices is None:
        devices = world_devices() if world else [resolve_device(None)]
    n = len(devices)
    shape = list(preferred_shape)
    model = math.prod(shape[1:]) if len(shape) > 1 else 1
    if n % model:
        raise AssertionError(f"{n} devices cannot host model dim {model}")
    shape[0] = n // model
    if world:
        return mesh_over_world(shape, axis_names)
    return Mesh(device_array(devices, shape), tuple(axis_names))


# ------------------------------------------------- a tree cut over 'model'

def is_placement(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, tuple) for e in x)


def dim_leaves(dims: PyTree) -> list:
    """The leaves of a tree of ``Optional[int]``, None included."""
    if isinstance(dims, dict):
        return [x for k in sorted(dims) for x in dim_leaves(dims[k])]
    if isinstance(dims, (list, tuple)):
        return [x for v in dims for x in dim_leaves(v)]
    return [dims]


def model_dims(mesh: Mesh, axes: PyTree, shapes: PyTree) -> PyTree:
    """For each leaf, the dimension ``param_shardings`` (``fsdp=False``)
    places on ('model',), after the divisibility fallback; None for a
    leaf held whole."""
    specs = iter(cm.tree_leaves(param_shardings(mesh, axes, shapes),
                                is_leaf=is_placement))

    def dim(a):
        spec = next(specs)
        hit = [i for i, e in enumerate(spec) if e == ("model",)]
        return hit[0] if hit else None
    return cm.tree_map(dim, axes, is_leaf=_is_axes_leaf)


_RECURRENT = ("rwkv", "mamba", "zamba_unit")


def deferred_block(cfg, seg) -> Optional[str]:
    """Why the rank program runs segment ``seg``'s token mixing whole
    (its attention or recurrence, and the decode cache or state that
    carries it), or None where it runs it split: the recurrent blocks
    (rwkv, mamba, a zamba unit), whose head layout runs through a
    carried state, and MLA's attention, through a latent cache.
    ``deferred`` and ``launch/specs.py:cache_specs`` read it."""
    if seg.kind in _RECURRENT:
        return f"{seg.kind} block"
    if cfg.mla is not None and seg.kind in ("attn", "attn_dense"):
        return "MLA attention"
    return None


def deferred(cfg, path: str) -> Optional[str]:
    """Why the rank program holds the leaf at ``path`` (a ``tree_items``
    path of the model's spec) whole though ``model_dims`` splits it, or
    None where it runs it split: a block's token mixing that
    ``deferred_block`` names (every leaf of a recurrent block, MLA's
    ``attn``, GAR leaves among them) and a zamba unit's shared
    attention."""
    toks = path.split("/")
    if toks[0] == "shared_attn":
        return "zamba shared attention"
    if toks[0] == "segments":
        seg = cfg.segments[int(toks[1])]
        why = deferred_block(cfg, seg)
        if why and (seg.kind in _RECURRENT or toks[2] == "attn"):
            return why
    return None


def rank_dims(cfg, mesh: Mesh, axes: PyTree, shapes: PyTree) -> PyTree:
    """``model_dims`` with None where the rank program holds the leaf
    whole (``deferred``): the split this rank's step executes."""
    dims = model_dims(mesh, axes, shapes)
    paths = [p for p, _ in cm.tree_items(axes, is_leaf=_is_axes_leaf)]
    it = iter(zip(paths, dim_leaves(dims)))

    def keep(_):
        path, d = next(it)
        return None if d is None or deferred(cfg, path) else d
    return cm.tree_map(keep, axes, is_leaf=_is_axes_leaf)


def _paired(tree: PyTree, dims: PyTree) -> list:
    """The leaves of ``tree`` beside those of ``dims``, which must be of
    the same tree (``model_dims`` of its own spec)."""
    leaves, ds = cm.tree_leaves(tree), dim_leaves(dims)
    if len(ds) != len(leaves):
        raise ValueError(f"{len(ds)} dims for a tree of {len(leaves)} "
                         "leaves: the dims were worked out from another "
                         "tree's spec")
    return list(zip(leaves, ds))


def _zip_dims(tree: PyTree, dims: PyTree, fn) -> PyTree:
    it = iter(_paired(tree, dims))
    return cm.tree_map(lambda t: fn(*next(it)), tree)


def shard_tree(tree: PyTree, dims: PyTree, mesh: Mesh) -> PyTree:
    """This rank's part of each leaf along its ``dims`` entry over
    'model' (a copy); leaves with None are kept as they are."""
    n, i = mesh.size("model"), mesh.index("model")

    def cut(t, d):
        if d is None or n == 1:
            return t
        size = t.shape[d] // n
        return t.detach().narrow(d, i * size, size).clone()
    return _zip_dims(tree, dims, cut)


def split_global_norm(grads: PyTree, dims: PyTree, mesh: Mesh
                      ) -> Optional[torch.Tensor]:
    """The global norm of gradients split over 'model' along ``dims``
    (None where the mesh has no 'model' axis or it holds one rank): the split leaves' squares summed
    over the axis, the whole leaves' counted once."""
    group = (mesh.group("model") if "model" in mesh.axis_names else None)
    if group is None:
        return None
    whole, split = [], []
    for g, d in _paired(grads, dims):
        (whole if d is None else split).append(
            torch.sum(torch.square(g.float())))
    part = torch.sum(torch.stack(split)) if split else torch.zeros(
        (), device=cm.tree_leaves(grads)[0].device)
    dist.all_reduce(part, group=group)
    return torch.sqrt(torch.sum(torch.stack(whole)) + part)


def unshard_tree(tree: PyTree, dims: PyTree, mesh: Mesh) -> PyTree:
    """Each leaf whole again: the 'model' ranks' parts concatenated along
    its ``dims`` entry (a collective: every rank of the axis calls it)."""
    group = mesh.group("model")

    def whole(t, d):
        if d is None or group is None:
            return t
        return C.all_gather_along(t.detach(), d, group)
    return _zip_dims(tree, dims, whole)
