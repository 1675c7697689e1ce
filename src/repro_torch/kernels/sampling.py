"""Wrapper of the fused warp + draw kernel (``csrc/sampling.cu``).

Replaces the JAX package's Pallas ``topk_mask_sample``
(``src/repro/kernels/sampling.py``). CUDA C++ rather than Triton: the
kernel is a per-row two-pass reduction with a running count and a
block-wide scan, which a few dozen lines of warp shuffles express directly,
and it then builds in seconds with the other kernels from one toolchain.
One thread block per row; bound on the card by the two reads of the logits
row. The plain version is ``ref.topk_mask_sample_ref``; the top-k threshold
is computed by the caller (``ops``) with one sort, as in the reference.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

# launches of the CUDA kernel since the last reset (see gar_matmul.launches)
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with its C signatures declared, once."""
    lib = build.library("sampling")
    lib.topk_mask_sample_f32.argtypes = [_P, _P, _P, _P, _I, _I, _P, _P, _P]
    lib.topk_mask_sample_f32.restype = _I
    return lib


def topk_mask_sample(logits, temperature, threshold, u, *,
                     return_probs: bool = False):
    """logits (S, V), temperature/threshold/u (S,), float32 on one CUDA
    device. Returns tokens (S,) int32, plus probs (S, V) float32 when
    ``return_probs``."""
    global launches
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
    tokens = torch.empty(s, dtype=torch.int32, device=logits.device)
    probs = (torch.empty((s, v), dtype=torch.float32, device=logits.device)
             if return_probs else None)
    if s:
        rc = _lib().topk_mask_sample_f32(
            logits.data_ptr(), temperature.data_ptr(), threshold.data_ptr(),
            u.data_ptr(), s, v, tokens.data_ptr(),
            probs.data_ptr() if probs is not None else None,
            build.stream_ptr(logits.device))
        build.check(rc, "topk_mask_sample")
        launches += 1
    return (tokens, probs) if return_probs else tokens
