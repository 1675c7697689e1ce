"""Wrapper of the Mamba2 SSD scan kernel (``csrc/ssd.cu``).

Replaces the JAX package's Pallas ``ssd``
(``src/repro/kernels/mamba2_ssd.py``): one launch runs the scan of every
(batch, head) from a zero state, one block each, with the (N, P) state in
registers. It reads the (B, S, H, P) inputs and the grouped (B, S, G, N)
``b``/``c`` in place, where the reference's wrapper flattened to (B H, S,
.), repeated ``b``/``c`` over the heads and padded S to a chunk multiple.
Bound on the card: operations; see the source note. The plain versions
are ``models.ssm.ssd_chunked`` (what ``ops.ssd_forward`` runs on the CPU)
and the sequential ``ref.ssd_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

# launches of the CUDA kernel since the last reset (see gar_matmul.launches)
launches = 0

HEAD_SIZE = 64             # P, fixed in the kernel (one thread a channel)
STATE_SIZE = 64            # N, fixed in the kernel

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with its C signature declared, once."""
    lib = build.library("ssd")
    lib.ssd_f32.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.ssd_f32.restype = _I
    return lib


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, P), dt (B, S, H), a (H,), b/c (B, S, G, N) float32,
    contiguous on one CUDA device, P = N = 64, G dividing H. Returns y
    (B, S, H, P), without the skip term."""
    global launches
    tensors = (x, dt, a, b, c)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("ssd launches on CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("ssd operands lie on different devices")
    if not all(t.dtype == torch.float32 for t in tensors):
        raise TypeError(f"ssd takes float32, got {[t.dtype for t in tensors]}")
    if x.dim() != 4 or b.dim() != 4:
        raise ValueError("ssd takes x (B, S, H, P) and b/c (B, S, G, N)")
    bb, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if (dt.shape != (bb, s, h) or a.shape != (h,) or c.shape != b.shape
            or b.shape[:2] != (bb, s) or g == 0 or h % g):
        raise ValueError(f"ssd shapes: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}")
    if p != HEAD_SIZE or n != STATE_SIZE:
        raise ValueError(f"ssd takes P = {HEAD_SIZE} and N = {STATE_SIZE}, "
                         f"got P = {p}, N = {n}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd takes contiguous tensors")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    rc = _lib().ssd_f32(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                        b.data_ptr(), c.data_ptr(), y.data_ptr(), bb, s, h,
                        g, build.stream_ptr(x.device))
    build.check(rc, "ssd")
    launches += 1
    return y
