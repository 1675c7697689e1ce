"""Wrapper of the Mamba2 SSD scan kernels (``csrc/ssd.cu``).

Replaces the JAX package's Pallas ``ssd``
(``src/repro/kernels/mamba2_ssd.py``) with its chunked form on the tensor
cores (3xTF32): chunks of ``CHUNK`` steps, the (N, P) state carried from
chunk to chunk. A call is ``LAUNCHES_A_CALL`` launches: the scores
``C B^T`` of each (batch, group, chunk) into a scratch that every head of
the group reads, then the scan, ``HEADS_A_BLOCK`` heads of one group a
block, launched to overlap the first (``layout`` gives grid and scratch
from the shapes alone; no host synchronisation). It reads the
(B, S, H, P) inputs and the grouped (B, S, G, N) ``b``/``c`` in place,
where the reference's wrapper flattened to (B H, S, .), repeated
``b``/``c`` over the heads and padded S to a chunk multiple. Bound on the
card: bytes; see the source note. The plain versions are
``models.ssm.ssd_chunked`` (what ``ops.ssd_forward`` runs on the CPU) and
the sequential ``ref.ssd_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

# launches of the CUDA kernels since the last reset (see
# gar_matmul.launches), LAUNCHES_A_CALL a call
launches = 0
LAUNCHES_A_CALL = 2

HEAD_SIZE = 64             # P, fixed in the kernel
STATE_SIZE = 64            # N, fixed in the kernel
CHUNK = 128                # Q: steps a chunk, the kernel's own choice
ROW_TILES = CHUNK // 16    # 16-row tiles of a chunk
# (row tile r, 8-step block kk <= 2r + 1) tiles of the scores' triangle
SCORE_TILES = ROW_TILES * (ROW_TILES + 1)

_P = ctypes.c_void_p
_I = ctypes.c_int


HEADS_A_BLOCK = 2          # heads of one group a block of the scan


class Layout(NamedTuple):
    chunks: int            # ceil(S / CHUNK)
    score_blocks: int      # launch 1: (batch, group, chunk, row-tile pair)
    scan_blocks: int       # launch 2: (batch, group, pair of heads)
    scratch_floats: int    # the scores: 32 lanes x 4 floats a tile


def layout(b: int, s: int, h: int, g: int) -> Layout:
    """Grids and scratch of a call at x (b, s, h, P), b/c (b, s, g, N):
    the kernel computes the same from the shapes alone."""
    chunks = -(-s // CHUNK)
    units = b * g * chunks
    return Layout(chunks, units * ROW_TILES // 2,
                  b * g * -(-(h // g) // HEADS_A_BLOCK),
                  units * SCORE_TILES * 128)


@functools.lru_cache(maxsize=None)
def _lib(defines: tuple = ()):
    """The built library (of ``-D`` macros ``defines``, for
    ``tools/ssd_phases.py``) with its C signature declared, once."""
    lib = build.library("ssd", defines)
    lib.ssd_f32.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
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
    _run(_lib(), x, dt, a, b, c, y)
    launches += LAUNCHES_A_CALL
    return y


def _run(lib, x, dt, a, b, c, y) -> None:
    """Launch the two kernels of ``lib`` on checked operands."""
    bb, s, h, _ = x.shape
    g = b.shape[2]
    scratch = torch.empty(layout(bb, s, h, g).scratch_floats,
                          dtype=torch.float32, device=x.device)
    rc = lib.ssd_f32(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                     b.data_ptr(), c.data_ptr(), y.data_ptr(),
                     scratch.data_ptr(), bb, s, h, g,
                     build.stream_ptr(x.device))
    build.check(rc, "ssd")
