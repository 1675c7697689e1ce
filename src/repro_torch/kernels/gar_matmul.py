"""Wrapper of the fused GAR linear kernel (``csrc/gar_matmul.cu``).

Replaces the JAX package's Pallas ``gar_matmul``
(``src/repro/kernels/gar_matmul.py``) plus the output permutation of its
``ops.gar_forward``: ``y = P^{-1}[x@v_tilde ; (x@v_tilde)@u_hat^T]`` in two
launches. The first writes ``z = x @ v_tilde`` to a scratch buffer (it
stays in L2), the second computes the tail from it and writes every output
column in place, the identity ones copied from ``z``. Both products run on
the tensor cores in 3xTF32, tiled over every SM (``tiling``). Bound on the
card: the bytes of ``v_tilde`` and ``u_hat`` at decode, the operations at
a prefill chunk; see the source note. The plain version is
``ref.gar_matmul_ref`` followed by the same permutation (``ops``).

``gar_tail`` is the stage-2 entry: ``tail = z @ u_hat^T`` from a z it is
given, the second launch alone (a tensor-parallel rank's stage 2,
``models/tp.py``); its plain version is ``ref.gar_tail_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build, tiles
from repro_torch.kernels.lowrank_matmul import card_slots

# CUDA launches since the last reset (plain ints, read by chip_smoke.py to
# prove the serving path went through the kernel): two a ``gar_matmul``
# call, one a ``gar_tail`` call
launches = 0
tail_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib(defines: Tuple[str, ...] = ()):
    """The built library (with the ``-D`` macros of a variant, see
    ``tools/core_variants.py``) with its C signature declared, once."""
    lib = build.library("gar_matmul", defines)
    lib.gar_matmul_f32.argtypes = [_P] * 6 + [_I] * 11 + [_P]
    lib.gar_matmul_f32.restype = _I
    lib.gar_tail_f32.argtypes = [_P] * 3 + [_I] * 7 + [_P]
    lib.gar_tail_f32.restype = _I
    return lib


@functools.lru_cache(maxsize=4096)
def tiling(t: int, n: int, r: int, m: int,
           slots: tiles.Slots = tiles.CLUSTER_SLOTS) -> tiles.Tiling:
    """The tiling of a call on x (t, n), v_tilde (n, r), m outputs, on a
    card of cluster occupancy ``slots`` (cached: a model's shapes repeat
    every layer and step)."""
    mt = m - r
    bn = tiles.token_tile(t, [(r, n), (mt, r)], slots)
    ldz = -(-r // 4) * 4
    return tiles.Tiling(
        tiles.stage(r, n, t, bn, slots=slots),
        tiles.stage(mt, r, t, bn, tiles.copy_blocks(t, m), slots),
        ldz, t * ldz + mt)


@functools.lru_cache(maxsize=4096)
def tail_tiling(t: int, r: int, mt: int,
                slots: tiles.Slots = tiles.CLUSTER_SLOTS) -> tiles.Stage:
    """The one launch of a ``gar_tail`` call on z (t, r) and u_hat (mt,
    r)."""
    bn = tiles.token_tile(t, [(mt, r)], slots)
    return tiles.stage(mt, r, t, bn, slots=slots)


def gar_matmul(x: torch.Tensor, v_tilde: torch.Tensor, u_hat: torch.Tensor,
               perm_inv: torch.Tensor) -> torch.Tensor:
    """x (T, n), v_tilde (n, r), u_hat (m - r, r) float32 and perm_inv (m,)
    int64, all contiguous on one CUDA device. Returns y (T, m)."""
    global launches
    tensors = (x, v_tilde, u_hat, perm_inv)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("gar_matmul launches on CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("gar_matmul operands lie on different devices")
    if not (x.dtype == v_tilde.dtype == u_hat.dtype == torch.float32):
        raise TypeError(f"gar_matmul takes float32, got {x.dtype}, "
                        f"{v_tilde.dtype}, {u_hat.dtype}")
    if perm_inv.dtype != torch.int64:
        raise TypeError(f"perm_inv must be int64, got {perm_inv.dtype}")
    if x.dim() != 2 or v_tilde.dim() != 2 or u_hat.dim() != 2:
        raise ValueError("gar_matmul takes 2-d x, v_tilde and u_hat")
    t, n = x.shape
    r = v_tilde.shape[1]
    mt = u_hat.shape[0]
    if v_tilde.shape[0] != n or (mt and u_hat.shape[1] != r) \
            or perm_inv.shape != (r + mt,):
        raise ValueError(f"gar_matmul shapes: x {tuple(x.shape)}, v_tilde "
                         f"{tuple(v_tilde.shape)}, u_hat {tuple(u_hat.shape)}, "
                         f"perm_inv {tuple(perm_inv.shape)}")
    if not all(tt.is_contiguous() for tt in tensors):
        raise ValueError("gar_matmul takes contiguous tensors")
    y = torch.empty((t, r + mt), dtype=x.dtype, device=x.device)
    if t == 0:
        return y
    plan = tiling(t, n, r, r + mt, card_slots())
    scratch = plan.scratch(x.device)
    s1, s2 = plan.stage1, plan.stage2
    rc = _lib().gar_matmul_f32(
        x.data_ptr(), v_tilde.data_ptr(), u_hat.data_ptr(),
        perm_inv.data_ptr(), y.data_ptr(), scratch.data_ptr(), t, n, r, mt,
        s1.bn, s1.rows, s1.split, s1.k_chunk, s2.rows, s2.split, s2.k_chunk,
        build.stream_ptr(x.device))
    build.check(rc, "gar_matmul")
    launches += 2
    return y


def gar_tail(z: torch.Tensor, u_hat: torch.Tensor) -> torch.Tensor:
    """The stage-2 entry: z (T, r) and u_hat (m - r, r) float32, contiguous
    on one CUDA device. Returns tail = z @ u_hat^T (T, m - r)."""
    global tail_launches
    if not (z.is_cuda and u_hat.is_cuda):
        raise ValueError("gar_tail launches on CUDA tensors only")
    if z.device != u_hat.device:
        raise ValueError("gar_tail operands lie on different devices")
    if not (z.dtype == u_hat.dtype == torch.float32):
        raise TypeError(f"gar_tail takes float32, got {z.dtype}, "
                        f"{u_hat.dtype}")
    if z.dim() != 2 or u_hat.dim() != 2 or u_hat.shape[1] != z.shape[1]:
        raise ValueError(f"gar_tail shapes: z {tuple(z.shape)}, u_hat "
                         f"{tuple(u_hat.shape)}")
    if not (z.is_contiguous() and u_hat.is_contiguous()):
        raise ValueError("gar_tail takes contiguous tensors")
    t, r = z.shape
    mt = u_hat.shape[0]
    tail = torch.empty((t, mt), dtype=z.dtype, device=z.device)
    if t == 0 or mt == 0:
        return tail
    st = tail_tiling(t, r, mt, card_slots())
    rc = _lib().gar_tail_f32(z.data_ptr(), u_hat.data_ptr(), tail.data_ptr(),
                             t, r, mt, st.bn, st.rows, st.split, st.k_chunk,
                             build.stream_ptr(z.device))
    build.check(rc, "gar_tail")
    tail_launches += 1
    return tail
