"""Wrappers of the paged attention kernels (``csrc/paged_attention.cu``).

Replace the JAX package's Pallas ``paged_attention`` (decode, one query
token a batch slot) and ``paged_prefill_attention`` (a flat token batch)
(``src/repro/kernels/paged_attention.py``). One thread block per (row,
kv-head) loops over the row's table with a streaming float32 softmax over
the keys in ``[ctx - window, ctx)``; bound on the card by the bytes of the
keys and values each row reads. The plain versions are
``ref.paged_attention_ref`` and ``ref.paged_prefill_attention_ref``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build

# launches of each CUDA kernel since the last reset (see gar_matmul.launches):
# ``launches`` the flat-token kernel's, ``decode_launches`` the decode one's
launches = 0
decode_launches = 0

# the window a caller without one passes: no key is older than this
NO_WINDOW = 1 << 30

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with its C signatures declared, once."""
    lib = build.library("paged_attention")
    lib.paged_attention_f32.argtypes = [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P]
    lib.paged_attention_f32.restype = _I
    lib.paged_prefill_attention_f32.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P]
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
    window = NO_WINDOW if window is None else int(window)
    if window < 1:
        raise ValueError(f"{what}: window must be >= 1, got {window}")
    return min(window, NO_WINDOW)


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
    rc = _lib().paged_attention_f32(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(), b,
        hq, hkv, d, bs, block_tables.shape[1], 1.0 / math.sqrt(d),
        float(softcap or 0.0), window, build.stream_ptr(q.device))
    build.check(rc, "paged_attention")
    decode_launches += 1
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
    rc = _lib().paged_prefill_attention_f32(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), slot_ids.data_ptr(),
        context_lens.data_ptr(), out.data_ptr(), t, hq, hkv, d, bs,
        block_tables.shape[1], 1.0 / math.sqrt(d), float(softcap or 0.0),
        window, build.stream_ptr(q.device))
    build.check(rc, "paged_prefill_attention")
    launches += 1
    return out
