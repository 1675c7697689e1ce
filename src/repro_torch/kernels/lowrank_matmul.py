"""Wrapper of the rank-masked low-rank linear kernel
(``csrc/lowrank_matmul.cu``).

Replaces the JAX package's Pallas ``lowrank_matmul``
(``src/repro/kernels/lowrank_matmul.py``): one launch computes ``y = ((x @
v) * [col < rank]) @ u^T``. A cluster of 8 thread blocks per tile of 32
tokens splits both products across 8 SMs and shares ``z`` through
distributed shared memory, so ``z`` never goes to device memory; the masked
columns are skipped. Bound on the card: float32 operations at the training
shapes; see the source note. The plain version is
``ref.lowrank_matmul_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

# launches of the CUDA kernel since the last reset (see gar_matmul.launches)
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with its C signatures declared, once."""
    lib = build.library("lowrank_matmul")
    lib.lowrank_matmul_f32.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                       _I, _P]
    lib.lowrank_matmul_f32.restype = _I
    lib.lowrank_matmul_smem_bytes.argtypes = [_I]
    lib.lowrank_matmul_smem_bytes.restype = _I
    return lib


def kept_rank(r: int, rank: Optional[int]) -> int:
    """The z columns that survive the mask ``col < rank``: ``rank`` clipped
    to [0, r]; ``None`` keeps all r."""
    return r if rank is None else max(0, min(int(rank), r))


def lowrank_matmul(x: torch.Tensor, v: torch.Tensor, u: torch.Tensor,
                   rank: Optional[int] = None) -> torch.Tensor:
    """x (T, n), v (n, r), u (m, r) float32, contiguous on one CUDA device;
    ``rank`` a Python int (``None`` = r). Returns y (T, m). One launch, or
    one per rank pass where the kept rank exceeds a block's shared
    memory."""
    global launches
    tensors = (x, v, u)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("lowrank_matmul launches on CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("lowrank_matmul operands lie on different devices")
    if not (x.dtype == v.dtype == u.dtype == torch.float32):
        raise TypeError(f"lowrank_matmul takes float32, got {x.dtype}, "
                        f"{v.dtype}, {u.dtype}")
    if x.dim() != 2 or v.dim() != 2 or u.dim() != 2:
        raise ValueError("lowrank_matmul takes 2-d x, v and u")
    t, n = x.shape
    r = v.shape[1]
    m = u.shape[0]
    if v.shape[0] != n or u.shape[1] != r:
        raise ValueError(f"lowrank_matmul shapes: x {tuple(x.shape)}, v "
                         f"{tuple(v.shape)}, u {tuple(u.shape)}")
    if not all(tt.is_contiguous() for tt in tensors):
        raise ValueError("lowrank_matmul takes contiguous tensors")
    kr = kept_rank(r, rank)
    y = torch.empty((t, m), dtype=x.dtype, device=x.device)
    if t == 0 or m == 0:
        return y
    launches += launch(_lib(), x, v, u, y, kr)
    return y


def rank_passes(lib, kr: int):
    """The column ranges ``[j0, j1)`` of the kept rank that one launch each
    computes: as few, and as even, as the shared memory of a block allows
    (one range up to some 1700 columns)."""
    return build.rank_passes(lib.lowrank_matmul_smem_bytes, kr)


def launch(lib, x, v, u, y, kr: int) -> int:
    """Launch ``lib``'s kernel over the rank passes of ``kr`` into ``y``
    (the first pass writes, the others add). Returns the launches."""
    t, n = x.shape
    r, m = v.shape[1], u.shape[0]
    passes = rank_passes(lib, kr)
    for i, (j0, j1) in enumerate(passes):
        rc = lib.lowrank_matmul_f32(
            x.data_ptr(), v.data_ptr() + 4 * j0, u.data_ptr() + 4 * j0,
            y.data_ptr(), t, n, r, m, j1 - j0, int(i > 0),
            build.stream_ptr(x.device))
        build.check(rc, "lowrank_matmul")
    return len(passes)
