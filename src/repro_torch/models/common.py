"""Parameter specs and shared primitives for the model forward.

A module is (spec_fn(cfg) -> ParamSpec tree, apply_fn(params, ...) -> out),
with parameters held as nested dicts and lists of tensors. ``factorize_spec``
rewrites eligible dense leaves ``{'w': (.., d_in, d_out)}`` into
``{'u': (.., d_out, r), 'v': (.., d_in, r)}``, and ``linear`` consumes the
dense, factorized (optionally rank-masked) and GAR forms. The factorized
form goes through ``kernels.ops.lowrank_forward`` and the GAR form through
``kernels.ops.gar_forward``: the CUDA kernels on the card, their plain
versions on the CPU. Activation taps record the second moment of every
linear's input during the calibration pass (DataSVD).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import tp

PyTree = Any

EMBED, MLP, HEADS, KV_HEADS, QKV, VOCAB, LAYERS, EXPERTS, RANK, CONV, STATE = (
    "embed", "mlp", "heads", "kv_heads", "qkv", "vocab", "layers", "experts",
    "rank", "conv", "state",
)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative parameter: shape + logical axes + initializer id."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones
    dtype: Any = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree: PyTree, is_leaf=None) -> PyTree:
    """Map ``fn`` over the leaves of nested dicts/lists/tuples. Rebuilt
    dicts have sorted keys, as ``jax.tree.map`` rebuilds them, so a walk
    over a mapped tree (``stack_spec``, ``group_infos``) visits the layer
    groups in the JAX package's order."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, is_leaf) for v in tree]
        return type(tree)(out) if isinstance(tree, tuple) else out
    if tree is None:
        return None
    return fn(tree)


def tree_items(tree: PyTree, is_leaf=None, prefix: str = ""):
    """(path, leaf) pairs in ``tree_map``'s order; a path joins dict keys
    and list indices with ``/`` (``"segments/0/attn/q"``)."""
    if is_leaf is not None and is_leaf(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], is_leaf,
                                  f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, is_leaf,
                                  f"{prefix}/{i}" if prefix else str(i))
    elif tree is not None:
        yield prefix, tree


def tree_leaves(tree: PyTree, is_leaf=None) -> list:
    return [leaf for _, leaf in tree_items(tree, is_leaf)]


def instantiate(specs: PyTree, generator: torch.Generator, *,
                device=None, dtype=None) -> PyTree:
    """Materialize tensors from specs; normal leaves draw from
    ``generator`` scaled by ``1/sqrt(fan_in)``, in leaf order. On the
    ``meta`` device every leaf is ``torch.empty`` and the generator is
    not touched: a draw there would cost the host the whole model's
    random numbers for tensors that hold none."""
    meta = device is not None and torch.device(device).type == "meta"

    def make(s: ParamSpec):
        dt = dtype or s.dtype
        if meta:
            return torch.empty(s.shape, dtype=dt, device="meta")
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=device)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
        x = torch.randn(s.shape, generator=generator, dtype=dt,
                        device=generator.device)
        return (scale * x).to(device or generator.device)
    return tree_map(make, specs, is_leaf=is_spec)


def axes_tree(specs: PyTree) -> PyTree:
    """The logical-axes tree mirroring a spec tree's parameters."""
    return tree_map(lambda s: s.axes, specs, is_leaf=is_spec)


def param_count(specs: PyTree) -> int:
    return sum(int(np.prod(s.shape)) for s in tree_leaves(specs, is_spec))


def stack_spec(spec: PyTree, num_layers: int) -> PyTree:
    """Add a leading ``layers`` axis to every leaf."""
    return tree_map(
        lambda s: ParamSpec((num_layers,) + s.shape, (LAYERS,) + s.axes,
                            s.init, s.dtype), spec, is_leaf=is_spec)


def factorize_leaf(spec: ParamSpec,
                   max_rank: Optional[int] = None) -> Dict[str, ParamSpec]:
    """Dense (.., d_in, d_out) -> {'v': (.., d_in, r), 'u': (.., d_out, r)}:
    z = x @ v; y = z @ u^T."""
    *lead, d_in, d_out = spec.shape
    r = min(d_in, d_out) if max_rank is None else min(max_rank, d_in, d_out)
    lead_axes = spec.axes[:-2]
    in_axis, out_axis = spec.axes[-2], spec.axes[-1]
    return {
        "v": ParamSpec(tuple(lead) + (d_in, r), lead_axes + (in_axis, RANK),
                       spec.init, spec.dtype),
        "u": ParamSpec(tuple(lead) + (d_out, r), lead_axes + (out_axis, RANK),
                       spec.init, spec.dtype),
    }


def factorize_spec(specs: PyTree, *,
                   predicate: Callable[[str, ParamSpec], bool],
                   max_rank_fn: Callable[[str, ParamSpec], Optional[int]]
                   = lambda p, s: None,
                   prefix: str = "") -> PyTree:
    """Rewrite eligible ``{'w': spec}`` sub-dicts into factorized form;
    paths are '/'-joined key chains ending at the dict that holds 'w'."""
    if isinstance(specs, dict):
        if set(specs.keys()) == {"w"} and is_spec(specs["w"]):
            if predicate(prefix, specs["w"]):
                return factorize_leaf(specs["w"],
                                      max_rank_fn(prefix, specs["w"]))
            return specs
        return {k: factorize_spec(v, predicate=predicate,
                                  max_rank_fn=max_rank_fn,
                                  prefix=f"{prefix}/{k}" if prefix else k)
                for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        out = [factorize_spec(v, predicate=predicate, max_rank_fn=max_rank_fn,
                              prefix=f"{prefix}/{i}" if prefix else str(i))
               for i, v in enumerate(specs)]
        return type(specs)(out) if isinstance(specs, tuple) else out
    return specs


def tree_get(tree: PyTree, path: str):
    cur = tree
    for tok in path.split("/"):
        cur = cur[int(tok)] if isinstance(cur, (list, tuple)) else cur[tok]
    return cur


def tree_set(tree: PyTree, path: str, value) -> None:
    toks = path.split("/")
    cur = tree
    for tok in toks[:-1]:
        cur = cur[int(tok)] if isinstance(cur, (list, tuple)) else cur[tok]
    last = toks[-1]
    if isinstance(cur, list):
        cur[int(last)] = value
    else:
        cur[last] = value


def rget(ranks, *path):
    """Nested lookup into a ranks tree; None when absent (a dense leaf)."""
    cur = ranks
    for k in path:
        if not isinstance(cur, dict) or k not in cur:
            return None
        cur = cur[k]
    return None if isinstance(cur, dict) else cur


# ---------------------------------------------------------------------------
# activation taps (DataSVD moment collection, core/flexrank.py)
# ---------------------------------------------------------------------------
# While a tap store is active (the calibration pass only), ``linear``
# accumulates the unnormalized second moment of its input under a key that
# mirrors the parameter path ("segments/0/@3/attn/q", "@l" the layer index
# inside a segment). The moment stays on the input's device, in float32.
# Otherwise the cost is one ``is None`` check.

_TAPS = threading.local()


def _tap_state():
    if not hasattr(_TAPS, "store"):
        _TAPS.store = None
        _TAPS.prefix = []
    return _TAPS


@contextlib.contextmanager
def tap_recording(store: dict):
    st = _tap_state()
    prev = st.store
    st.store = store
    try:
        yield store
    finally:
        st.store = prev


@contextlib.contextmanager
def tap_scope(name: str, *, absolute: bool = False):
    st = _tap_state()
    saved = st.prefix
    st.prefix = [name] if absolute else saved + [name]
    try:
        yield
    finally:
        st.prefix = saved


def record_tap(name: Optional[str], x: torch.Tensor) -> None:
    """Fold ``x`` (..., n) into the store's ``[moment (n, n), count]``
    entry under the current scope; the moment is ``flat^T flat`` in float32
    on ``x``'s device, the count a float."""
    st = _tap_state()
    if st.store is None or name is None:
        return
    key = "/".join(st.prefix + [name])
    flat = x.detach().reshape(-1, x.shape[-1]).float()
    ent = st.store.get(key)
    if ent is None:
        st.store[key] = [flat.T @ flat, float(flat.shape[0])]
    else:
        ent[0] += flat.T @ flat
        ent[1] += float(flat.shape[0])



# ---------------------------------------------------------------------------
# math primitives
# ---------------------------------------------------------------------------

def linear(p: Dict[str, torch.Tensor], x: torch.Tensor, *,
           rank: Optional[int] = None,
           tap: Optional[str] = None,
           whole: Optional[Tuple[int, ...]] = None,
           entered: bool = False) -> torch.Tensor:
    """y = x @ W with W dense, factorized (optionally rank-masked), or GAR.

    dense:      p = {'w': (d_in, d_out)}
    factorized: p = {'v': (d_in, r), 'u': (d_out, r)}; columns >= ``rank``
                (a Python int) are masked out, the nested-mask training path
    gar:        p = {'v_tilde': (d_in, r), 'u_hat': (d_out - r, r),
                 'perm_inv': (d_out,) int64}; the deploy path

    ``tap`` names the input's moment while a tap store is active.

    ``whole``: the product's whole (d_in, d_out) (and whole rank, where
    both factors may be cut by it), given where the leaf may be a 'model'
    rank's part of it: under a mesh with a 'model' axis the product then
    runs as ``models/tp.py`` lays it out, and the result may be this
    rank's output columns; ``entered``: ``x`` went through ``tp.enter``.
    """
    record_tap(tap, x)
    if whole is not None:
        return tp.linear(p, x, whole, rank, _linear, entered)
    return _linear(p, x, rank)


def _linear(p: Dict[str, torch.Tensor], x: torch.Tensor,
            rank: Optional[int]) -> torch.Tensor:
    if "w" in p:
        return x @ p["w"].to(x.dtype)
    if "u_hat" in p:
        return ops.gar_forward(x, p["v_tilde"], p["u_hat"], p["perm_inv"])
    return ops.lowrank_forward(x, p["v"], p["u"], rank)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


@functools.lru_cache(maxsize=None)
def _rope_freq(half: int, base: float, device: torch.device) -> torch.Tensor:
    """``base ** -(i / half)`` for ``i < half``, float32 on ``device``; made
    once per key, since building ``base`` as a device tensor is a pageable
    host-to-device copy that waits for the stream."""
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(base, dtype=torch.float32, device=device),
                     exps)


def rope(x: torch.Tensor, positions: torch.Tensor, *, base: float = 10000.0,
         dims: Optional[int] = None) -> torch.Tensor:
    """Rotary embedding, half-split layout. x: (B, S, H, D); positions:
    (B, S) or (S,)."""
    d = x.shape[-1] if dims is None else dims
    half = d // 2
    freq = _rope_freq(half, float(base), x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    angle = positions[..., None].float() * freq
    sin = torch.sin(angle)[:, :, None, :]
    cos = torch.cos(angle)[:, :, None, :]
    x_rot, x_pass = x[..., :d], x[..., d:]
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up
