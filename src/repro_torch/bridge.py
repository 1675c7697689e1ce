"""Conversion between the JAX package's parameter trees and the port's.

Parameter trees are nested dicts and lists in both packages, with the same
keys and the same layouts, so a conversion is a leaf-by-leaf copy:
numpy arrays (or anything ``np.asarray`` accepts) become torch tensors and
back. The one change of type is GAR's ``perm_inv``: int32 in the JAX
package, int64 index tensors here. A numpy -> torch -> numpy round trip is
exact. ``ProfileTable`` and ``GroupInfo`` are carried field by field into
the port's own dataclasses; AdamW states (``step``, ``mu``, ``nu``) and
calibration moment stores (``{tap_key: [moment, count]}``) go both ways,
exactly, and so do contiguous decode states (``decode_state_to_torch``,
``decode_state_to_numpy``). Nothing here imports JAX: the caller hands over the trees, and
the bridge reads them by duck typing.
"""
from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from repro_torch.core.flexrank import GroupInfo
from repro_torch.core.profiles import ProfileTable
from repro_torch.optim.adamw import AdamWState

PyTree = Any

_INDEX_KEYS = ("perm_inv",)


def _walk(tree: PyTree, fn, key: str = "") -> PyTree:
    if isinstance(tree, dict):
        return {k: _walk(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_walk(v, fn, key) for v in tree]
        return type(tree)(out) if isinstance(tree, tuple) else out
    if tree is None:
        return None
    return fn(tree, key)


def params_to_torch(tree: PyTree, device=None) -> PyTree:
    """Numpy (or JAX) parameter tree -> torch tensors on ``device`` (CPU by
    default); ``perm_inv`` leaves become int64."""
    def conv(leaf, key):
        a = np.asarray(leaf)
        if key in _INDEX_KEYS:
            a = a.astype(np.int64)
        return torch.from_numpy(np.array(a, copy=True)).to(device or "cpu")
    return _walk(tree, conv)


def params_to_numpy(tree: PyTree) -> PyTree:
    """Torch parameter tree -> numpy arrays; ``perm_inv`` back to int32, as
    the JAX package keeps it."""
    def conv(leaf, key):
        a = leaf.detach().cpu().numpy()
        return a.astype(np.int32) if key in _INDEX_KEYS else a
    return _walk(tree, conv)


def profile_table(table) -> ProfileTable:
    """The JAX package's ``ProfileTable`` -> the port's."""
    return ProfileTable(layer_names=tuple(table.layer_names),
                        table=np.asarray(table.table, np.int32).copy(),
                        budgets=tuple(float(b) for b in table.budgets),
                        max_ranks=tuple(int(r) for r in table.max_ranks))


def group_infos(infos) -> List[GroupInfo]:
    """The JAX package's ``GroupInfo`` list -> the port's."""
    return [GroupInfo(path=i.path, scan_dims=tuple(i.scan_dims),
                      lead_dims=tuple(i.lead_dims), m=int(i.m), n=int(i.n),
                      full_rank=int(i.full_rank), col=int(i.col))
            for i in infos]


def adamw_state_to_torch(state, device=None) -> AdamWState:
    """The JAX package's ``AdamWState`` (any object with ``step``, ``mu``
    and ``nu``) -> the port's, with ``step`` a Python int."""
    return AdamWState(step=int(np.asarray(state.step)),
                      mu=params_to_torch(state.mu, device),
                      nu=params_to_torch(state.nu, device))


def adamw_state_to_numpy(state: AdamWState):
    """The port's ``AdamWState`` -> ``(step, mu, nu)`` with ``step`` an
    int32 scalar array and numpy trees, the fields of the JAX package's
    ``AdamWState`` in order."""
    return (np.asarray(state.step, np.int32), params_to_numpy(state.mu),
            params_to_numpy(state.nu))


def moments_to_torch(store, device=None) -> dict:
    """``{tap_key: [moment, count]}`` with numpy moments -> torch moments
    on ``device``, counts as floats."""
    return {k: [torch.from_numpy(np.array(m, np.float32, copy=True)).to(
        device or "cpu"), float(c)] for k, (m, c) in store.items()}


def moments_to_numpy(store) -> dict:
    """The port's moment store -> numpy float32 moments, float counts, the
    JAX package's layout."""
    return {k: [m.detach().cpu().numpy(), float(c)]
            for k, (m, c) in store.items()}


def _state_leaf_to_torch(leaf, device):
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":       # the reference's default K/V type
        return torch.from_numpy(a.astype(np.float32)).to(
            device or "cpu", torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device or "cpu")


def decode_state_to_torch(tree, device=None) -> dict:
    """The JAX package's contiguous decode state (``init_decode_state``,
    numpy or JAX leaves) -> the port's: ``pos`` and every attention cache's
    ``idx`` (an int32 array of one value per stacked block) become host
    ints, ``None`` segments stay None, the other leaves (cross K/V among
    them) become tensors on ``device`` (bfloat16 stays bfloat16)."""
    def conv(node, key=""):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        if node is None:
            return None
        if key in ("pos", "idx"):
            a = np.asarray(node).reshape(-1)
            if not (a == a[0]).all():
                raise ValueError(f"{key} differs across blocks: {a}")
            return int(a[0])
        return _state_leaf_to_torch(node, device)
    return conv(tree)


def decode_state_to_numpy(state) -> dict:
    """The port's decode state -> the reference's layout in numpy: ``pos``
    an int32 scalar array, each ``idx`` an int32 array of one value per
    stacked block (shaped like the lead dims of its ``k``, or of MLA's
    ``c_kv``: (L,), or (U, self_per_unit) for a vision unit's self
    blocks), ``None`` segments (an encoder's) kept, tensors (cross K/V
    among them) as numpy arrays (bfloat16 ones as float32, which numpy
    lacks)."""
    def conv(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == "rows":
                    continue    # a rank's host value: no reference leaf
                if k == "pos":
                    out[k] = np.asarray(v, np.int32)
                elif k == "idx":
                    # one value per stacked block: the lead dims of its
                    # (.., B, T, Hkv, D) K or (.., B, T, r) latent
                    c = node["k"] if "k" in node else node["c_kv"]
                    lead = c.shape[:c.dim() - (4 if "k" in node else 3)]
                    out[k] = np.full(tuple(lead), v, np.int32)
                else:
                    out[k] = conv(v)
            return out
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        if node is None:
            return None
        return node.detach().float().cpu().numpy() \
            if node.dtype == torch.bfloat16 else node.detach().cpu().numpy()
    return conv(state)
