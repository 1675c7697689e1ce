"""Wrapper of the fused warp + draw kernels (``csrc/sampling.cu``).

Replaces the JAX package's Pallas ``topk_mask_sample``
(``src/repro/kernels/sampling.py``). CUDA C++ rather than Triton: the
kernels are per-row reductions and scans with a fixed summation order,
which warp shuffles express directly, and they build in seconds with the
other kernels from one toolchain. Each row is cut into splits of whole
``bv``-blocks (``split_layout``, from S and V alone) that run on separate
blocks; a call is three launches (split maxima, block sums, the two-level
draw) over scratch allocated here, and never synchronises with the host.
Bound on the card by one read of the logits. The plain version is
``ref.topk_mask_sample_ref``; the top-k threshold is computed by the caller
(``ops``) with one sort, as in the reference.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build

# launches of the CUDA kernels since the last reset (see
# gar_matmul.launches), three a call; ``probs_launches`` counts those of
# the calls that also write the warped probs (a speculative draft's q)
launches = 0
probs_launches = 0

# the block of the reference's two-level CDF (``ref.sample_cdf_ref``)
BLOCK = 1024
# blocks a launch aims at, and the most bv-blocks a split holds
# (``csrc/sampling.cu`` MAXB)
TARGET_BLOCKS = 512
MAX_SPLIT_BLOCKS = 64
# the most bv-blocks a row has: the draw keeps their prefixes in shared
# memory
MAX_ROW_BLOCKS = 8192


def split_layout(s: int, v: int) -> Tuple[int, int, int, int]:
    """(bv, nb, blocks a split, splits) of an (S, V) call: the row is cut
    into ``nb`` blocks of ``bv = min(BLOCK, V)`` entries (the reference's
    draw), and split ``i`` holds blocks ``[i * per, (i + 1) * per)``, about
    ``TARGET_BLOCKS`` blocks a launch over the S rows."""
    if s < 1 or v < 1:
        raise ValueError(f"split_layout: S {s}, V {v}")
    bv = min(BLOCK, v)
    nb = -(-v // bv)
    per = min(MAX_SPLIT_BLOCKS, max(1, -(-nb * s // TARGET_BLOCKS)))
    return bv, nb, per, -(-nb // per)


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with its C signatures declared, once."""
    lib = build.library("sampling")
    lib.topk_mask_sample_f32.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                          _I, _I, _P, _P, _P, _P]
    lib.topk_mask_sample_f32.restype = _I
    return lib


def topk_mask_sample(logits, temperature, threshold, u, *,
                     return_probs: bool = False):
    """logits (S, V), temperature/threshold/u (S,), float32 on one CUDA
    device. Returns tokens (S,) int32, plus probs (S, V) float32 when
    ``return_probs``."""
    global launches, probs_launches
    tensors = (logits, temperature, threshold, u)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("topk_mask_sample launches on CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("topk_mask_sample operands lie on different devices")
    if not all(t.dtype == torch.float32 for t in tensors):
        raise TypeError("topk_mask_sample takes float32 operands")
    if logits.dim() != 2:
        raise ValueError(f"logits must be (S, V), got {tuple(logits.shape)}")
    s, v = logits.shape
    if any(t.shape != (s,) for t in tensors[1:]):
        raise ValueError("temperature, threshold and u must be (S,)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("topk_mask_sample takes contiguous tensors")
    if v < 1 or -(-v // BLOCK) > MAX_ROW_BLOCKS or s > 65535:
        raise ValueError(f"topk_mask_sample takes 1 <= V <= "
                         f"{MAX_ROW_BLOCKS * BLOCK} and S <= 65535, got "
                         f"{(s, v)}")
    tokens = torch.empty(s, dtype=torch.int32, device=logits.device)
    probs = (torch.empty((s, v), dtype=torch.float32, device=logits.device)
             if return_probs else None)
    if s:
        bv, nb, per, splits = split_layout(s, v)
        # a (max, argmax, warped max) partial of 4 floats per (row, split),
        # then one sum per (row, bv-block)
        scratch = torch.empty(s * (4 * splits + nb), dtype=torch.float32,
                              device=logits.device)
        rc = _lib().topk_mask_sample_f32(
            logits.data_ptr(), temperature.data_ptr(), threshold.data_ptr(),
            u.data_ptr(), s, v, bv, nb, per, splits, tokens.data_ptr(),
            probs.data_ptr() if probs is not None else None,
            scratch.data_ptr(), build.stream_ptr(logits.device))
        build.check(rc, "topk_mask_sample")
        launches += 3
        if return_probs:
            probs_launches += 3
    return (tokens, probs) if return_probs else tokens
