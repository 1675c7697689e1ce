"""Wrappers of the paged attention kernels (``csrc/paged_attention.cu``).

Replace the JAX package's Pallas ``paged_attention`` (decode, one query
token a batch slot) and ``paged_prefill_attention`` (a flat token batch)
(``src/repro/kernels/paged_attention.py``). The key axis is cut into
splits of about ``SPLIT_KEYS`` keys aligned to key 0 (``split_layout``);
units of (token or tile of tokens, kv-head, split) write partial softmax
states to scratch allocated here, and a merge kernel combines each row's
splits in ascending order, so two calls give the same bits. Each call is
two launches: the units (single tokens, and for flat tokens also tiles of
consecutive same-slot tokens that share each K/V read), then the merge.
Nothing here synchronises with the host: the grid comes from the shapes.
Decode is bound by the bytes of K/V, a gemma3 prefill chunk by float32
operations. The plain versions are ``ref.paged_attention_ref`` and
``ref.paged_prefill_attention_ref``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

# launches of the CUDA kernels since the last reset (see
# gar_matmul.launches), two a call: ``launches`` the flat-token call's,
# ``decode_launches`` the decode call's
launches = 0
decode_launches = 0

# the window a caller without one passes: no key is older than this
NO_WINDOW = 1 << 30

# keys a split aims at; a split is a whole number of cache blocks
SPLIT_KEYS = 256
# query rows (tokens x query heads of a kv-head) of a tile, and the most
# query heads a kv-head the kernels take (``csrc/paged_attention.cu``
# RMAX, GMAX)
TILE_ROWS = 32
MAX_GROUP = 8


def split_layout(mb: int, bs: int, split_keys: int = SPLIT_KEYS
                 ) -> Tuple[int, int]:
    """(keys a split, number of splits) of a block table of ``mb`` blocks
    of ``bs`` keys. Split ``s`` holds key positions ``[s * keys, (s + 1) *
    keys)``: ``max(1, split_keys // bs)`` whole blocks, aligned to key 0."""
    if mb < 1 or bs < 1 or split_keys < 1:
        raise ValueError(f"split_layout: mb {mb}, bs {bs}, split_keys "
                         f"{split_keys}")
    blocks = max(1, split_keys // bs)
    return blocks * bs, -(-mb // blocks)


def tile_tokens(hq: int, hkv: int) -> int:
    """Tokens of a tile window: ``TILE_ROWS`` query rows of one kv-head."""
    return max(1, TILE_ROWS // (hq // hkv))


def scratch_bytes(rows: int, hq: int, d: int, mb: int, bs: int) -> int:
    """Bytes of the partials a call over ``rows`` query tokens allocates:
    (m, l) and a D-long accumulator per (token, query head, split)."""
    _, ns = split_layout(mb, bs)
    return 4 * rows * hq * ns * (d + 2)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with its C signatures declared, once."""
    lib = build.library("paged_attention")
    lib.paged_attention_f32.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
        _F, _I, _P]
    lib.paged_attention_f32.restype = _I
    lib.paged_prefill_attention_f32.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
        _I, _F, _F, _I, _P]
    lib.paged_prefill_attention_f32.restype = _I
    return lib


def _check(what, q, k_pool, v_pool, block_tables, rows, index_tensors,
           window):
    """The checks both wrappers share; ``rows`` is the leading size of q
    and of every tensor of ``index_tensors``. Returns the window to pass."""
    tensors = (q, k_pool, v_pool, block_tables, *index_tensors)
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{what} launches on CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what} operands lie on different devices")
    if not (q.dtype == k_pool.dtype == v_pool.dtype == torch.float32):
        raise TypeError(f"{what} takes float32 q and pools, got {q.dtype}, "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    if not all(t.dtype == torch.int32 for t in (block_tables,
                                                 *index_tensors)):
        raise TypeError(f"{what}: block tables and per-row indices must be "
                        "int32")
    if (q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape
            or q.shape[2] != k_pool.shape[3] or q.shape[1] % k_pool.shape[2]
            or block_tables.dim() != 2
            or any(t.shape != (rows,) for t in index_tensors)):
        raise ValueError(
            f"{what} shapes: q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, tables "
            f"{tuple(block_tables.shape)}, per-row "
            f"{[tuple(t.shape) for t in index_tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} takes contiguous tensors")
    g = q.shape[1] // k_pool.shape[2]
    if g > MAX_GROUP or q.shape[2] > 256:
        raise ValueError(f"{what} takes at most {MAX_GROUP} query heads a "
                         f"kv-head and D <= 256, got {g} and {q.shape[2]}")
    window = NO_WINDOW if window is None else int(window)
    if window < 1:
        raise ValueError(f"{what}: window must be >= 1, got {window}")
    return min(window, NO_WINDOW)


def _scratch(q, mb, bs):
    """The split layout and the partials' scratch of a call: (keys a
    split, splits, accumulators (T, Hq, NS, D), (m, l) pairs (T, Hq, NS,
    2))."""
    split, ns = split_layout(mb, bs)
    t, hq, d = q.shape
    return (split, ns, torch.empty((t, hq, ns, d), dtype=torch.float32,
                                   device=q.device),
            torch.empty((t, hq, ns, 2), dtype=torch.float32, device=q.device))


def paged_attention(q, k_pool, v_pool, block_tables, context_lens, *,
                    softcap: float = 0.0, window: Optional[int] = None):
    """Decode attention, one query token a slot. q (B, Hq, D), pools (NB,
    BS, Hkv, D) float32; block_tables (B, MB) and context_lens (B,) int32;
    all on one CUDA device. Keys ``[ctx - window, ctx)`` of each slot are
    valid (``window`` None: ``[0, ctx)``). Returns (B, Hq, D)."""
    global decode_launches
    b = q.shape[0]
    window = _check("paged_attention", q, k_pool, v_pool, block_tables, b,
                    (context_lens,), window)
    if block_tables.shape[0] != b:
        raise ValueError(f"paged_attention: {block_tables.shape[0]} table "
                         f"rows for {b} slots")
    out = torch.empty_like(q)
    if b == 0:
        return out
    _, hq, d = q.shape
    _, bs, hkv, _ = k_pool.shape
    mb = block_tables.shape[1]
    split, ns, part_acc, part_ml = _scratch(q, mb, bs)
    rc = _lib().paged_attention_f32(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), b, hq, hkv, d, bs, mb,
        split, ns, 1.0 / math.sqrt(d), float(softcap or 0.0), window,
        build.stream_ptr(q.device))
    build.check(rc, "paged_attention")
    decode_launches += 2
    return out


def paged_prefill_attention(q, k_pool, v_pool, block_tables, slot_ids,
                            context_lens, *, softcap: float = 0.0,
                            window: Optional[int] = None):
    """q (T, Hq, D), pools (NB, BS, Hkv, D) float32; block_tables (R, MB),
    slot_ids and context_lens (T,) int32; all on one CUDA device. Keys
    ``[ctx - window, ctx)`` of each token are valid (``window`` None:
    ``[0, ctx)``). Returns (T, Hq, D)."""
    global launches
    t = q.shape[0]
    window = _check("paged_prefill_attention", q, k_pool, v_pool,
                    block_tables, t, (slot_ids, context_lens), window)
    out = torch.empty_like(q)
    if t == 0:
        return out
    _, hq, d = q.shape
    _, bs, hkv, _ = k_pool.shape
    mb = block_tables.shape[1]
    split, ns, part_acc, part_ml = _scratch(q, mb, bs)
    rc = _lib().paged_prefill_attention_f32(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), slot_ids.data_ptr(),
        context_lens.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), t, hq, hkv, d, bs, mb, split, ns,
        tile_tokens(hq, hkv), 1.0 / math.sqrt(d), float(softcap or 0.0),
        window, build.stream_ptr(q.device))
    build.check(rc, "paged_prefill_attention")
    launches += 2
    return out
