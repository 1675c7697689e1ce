"""Wrapper of the RWKV6 WKV recurrence kernel (``csrc/wkv6.cu``).

Replaces the JAX package's Pallas ``wkv6``
(``src/repro/kernels/rwkv6_wkv.py``): one launch runs the recurrence of
every (batch, head) from a zero state, one block of 128 threads each, the
(N, N) state in registers as an 8-row by 4-column tile a thread. It reads
the (B, S, H, N) layout in place, where the reference's wrapper flattened
to (B H, S, N) and padded S to a chunk multiple. Bound on the card: bytes,
held back by the latency of a step; see the source note. The plain
versions are ``models.rwkv.wkv_chunked`` (what ``ops.wkv6_forward`` runs
on the CPU) and the sequential ``ref.wkv6_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

# launches of the CUDA kernel since the last reset (see gar_matmul.launches)
launches = 0

HEAD_SIZE = 64             # N, fixed in the kernel (its lane tiles)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with its C signature declared, once."""
    lib = build.library("wkv6")
    lib.wkv6_f32.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
    lib.wkv6_f32.restype = _I
    return lib


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor) -> torch.Tensor:
    """r/k/v/w (B, S, H, N) and u (H, N) float32, contiguous on one CUDA
    device, N = 64. Returns y (B, S, H, N)."""
    global launches
    tensors = (r, k, v, w, u)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("wkv6 launches on CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("wkv6 operands lie on different devices")
    if not all(t.dtype == torch.float32 for t in tensors):
        raise TypeError(f"wkv6 takes float32, got "
                        f"{[t.dtype for t in tensors]}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"wkv6 takes r/k/v/w of one (B, S, H, N) shape, "
                         f"got {[tuple(t.shape) for t in tensors[:4]]}")
    b, s, h, n = r.shape
    if n != HEAD_SIZE or u.shape != (h, n):
        raise ValueError(f"wkv6 takes N = {HEAD_SIZE} and u (H, N); got r "
                         f"{tuple(r.shape)}, u {tuple(u.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("wkv6 takes contiguous tensors")
    y = torch.empty_like(r)
    if y.numel() == 0:
        return y
    rc = _lib().wkv6_f32(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                         w.data_ptr(), u.data_ptr(), y.data_ptr(), b, s, h,
                         build.stream_ptr(r.device))
    build.check(rc, "wkv6")
    launches += 1
    return y
