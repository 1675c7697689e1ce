"""Wrapper of the flat-token paged attention kernel
(``csrc/paged_attention.cu``).

Replaces the JAX package's Pallas ``paged_prefill_attention``
(``src/repro/kernels/paged_attention.py``). One thread block per (token,
kv-head) loops over the token's table row with a streaming float32 softmax;
bound on the card by the bytes of the keys and values each token reads. The
plain version is ``ref.paged_prefill_attention_ref``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

# launches of the CUDA kernel since the last reset (see gar_matmul.launches)
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with its C signatures declared, once."""
    lib = build.library("paged_attention")
    lib.paged_prefill_attention_f32.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P]
    lib.paged_prefill_attention_f32.restype = _I
    return lib


def paged_prefill_attention(q, k_pool, v_pool, block_tables, slot_ids,
                            context_lens, *, softcap: float = 0.0):
    """q (T, Hq, D), pools (NB, BS, Hkv, D) float32; block_tables (R, MB),
    slot_ids and context_lens (T,) int32; all on one CUDA device. Returns
    (T, Hq, D)."""
    global launches
    tensors = (q, k_pool, v_pool, block_tables, slot_ids, context_lens)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged_prefill_attention launches on CUDA tensors "
                         "only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("paged_prefill_attention operands lie on different "
                         "devices")
    if not (q.dtype == k_pool.dtype == v_pool.dtype == torch.float32):
        raise TypeError("paged_prefill_attention takes float32 q and pools, "
                        f"got {q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if not (block_tables.dtype == slot_ids.dtype == context_lens.dtype
            == torch.int32):
        raise TypeError("block_tables, slot_ids and context_lens must be "
                        "int32")
    t, hq, d = q.shape
    nb, bs, hkv, d2 = k_pool.shape
    if (v_pool.shape != k_pool.shape or d2 != d or hq % hkv
            or slot_ids.shape != (t,) or context_lens.shape != (t,)
            or block_tables.dim() != 2):
        raise ValueError(
            f"paged_prefill_attention shapes: q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, tables "
            f"{tuple(block_tables.shape)}, slot_ids {tuple(slot_ids.shape)}, "
            f"context_lens {tuple(context_lens.shape)}")
    if not all(tt.is_contiguous() for tt in tensors):
        raise ValueError("paged_prefill_attention takes contiguous tensors")
    out = torch.empty_like(q)
    if t == 0:
        return out
    rc = _lib().paged_prefill_attention_f32(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), slot_ids.data_ptr(),
        context_lens.data_ptr(), out.data_ptr(), t, hq, hkv, d, bs,
        block_tables.shape[1], 1.0 / math.sqrt(d), float(softcap or 0.0),
        build.stream_ptr(q.device))
    build.check(rc, "paged_prefill_attention")
    launches += 1
    return out
