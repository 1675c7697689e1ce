"""Wrapper of the rank-masked low-rank linear kernel
(``csrc/lowrank_matmul.cu``).

Replaces the JAX package's Pallas ``lowrank_matmul``
(``src/repro/kernels/lowrank_matmul.py``): ``y = ((x @ v) * [col < rank])
@ u^T`` in two launches, ``z = x @ v[:, :kr]`` into a scratch buffer (it
stays in L2), then ``y = z @ u[:, :kr]^T``; the masked columns are skipped.
Both products run on the tensor cores in 3xTF32, tiled over every SM
(``tiling``). Bound on the card: operations at the training shapes; see
the source note. The plain version is ``ref.lowrank_matmul_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, tiles

# CUDA launches since the last reset (see gar_matmul.launches): two a call
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib(defines: Tuple[str, ...] = ()):
    """The built library (with the ``-D`` macros of a variant, see
    ``tools/core_variants.py``) with its C signature declared, once."""
    lib = build.library("lowrank_matmul", defines)
    lib.lowrank_matmul_f32.argtypes = [_P] * 5 + [_I] * 12 + [_P]
    lib.lowrank_matmul_f32.restype = _I
    lib.lowrank_cluster_slots.argtypes = [_I, _I]
    lib.lowrank_cluster_slots.restype = _I
    return lib


def kept_rank(r: int, rank: Optional[int]) -> int:
    """The z columns that survive the mask ``col < rank``: ``rank`` clipped
    to [0, r]; ``None`` keeps all r."""
    return r if rank is None else max(0, min(int(rank), r))


@functools.lru_cache(maxsize=None)
def card_slots() -> tiles.Slots:
    """The current card's cluster occupancy for the kernel of every token
    tile, as ``tiles.CLUSTER_SLOTS`` gives an H100 SXM's
    (``lowrank_cluster_slots``), queried once: the splits of both low-rank
    kernels follow it on the card."""
    lib = _lib()
    slots = tuple(tuple(lib.lowrank_cluster_slots(bn, s)
                        for s in range(1, tiles.MAX_SPLIT + 1))
                  for bn in tiles.TOKEN_TILES)
    if min(min(row) for row in slots) < 0:
        raise RuntimeError(f"lowrank_cluster_slots failed: {slots}")
    return slots


@functools.lru_cache(maxsize=4096)
def tiling(t: int, n: int, kr: int, m: int,
           slots: tiles.Slots = tiles.CLUSTER_SLOTS) -> tiles.Tiling:
    """The tiling of a call on x (t, n), kr kept columns, m outputs, on a
    card of cluster occupancy ``slots`` (cached: a model's shapes repeat
    every layer and step)."""
    bn = tiles.token_tile(t, [(kr, n), (m, kr)], slots)
    ldz = -(-kr // 4) * 4
    return tiles.Tiling(tiles.stage(kr, n, t, bn, slots=slots),
                        tiles.stage(m, kr, t, bn, slots=slots), ldz, t * ldz)


def lowrank_matmul(x: torch.Tensor, v: torch.Tensor, u: torch.Tensor,
                   rank: Optional[int] = None) -> torch.Tensor:
    """x (T, n), v (n, r), u (m, r) float32, contiguous on one CUDA device;
    ``rank`` a Python int (``None`` = r). Returns y (T, m)."""
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
    plan = tiling(t, n, kr, m, card_slots())
    scratch = plan.scratch(x.device)
    s1, s2 = plan.stage1, plan.stage2
    rc = _lib().lowrank_matmul_f32(
        x.data_ptr(), v.data_ptr(), u.data_ptr(), y.data_ptr(),
        scratch.data_ptr(), t, n, r, m, kr, s1.bn, s1.rows, s1.split,
        s1.k_chunk, s2.rows, s2.split, s2.k_chunk,
        build.stream_ptr(x.device))
    build.check(rc, "lowrank_matmul")
    launches += 2
    return y
