"""Wrapper of the fused GAR linear kernel (``csrc/gar_matmul.cu``).

Replaces the JAX package's Pallas ``gar_matmul``
(``src/repro/kernels/gar_matmul.py``) plus the output permutation of its
``ops.gar_forward``: one launch computes ``y = P^{-1}[x@v_tilde ;
(x@v_tilde)@u_hat^T]``. A cluster of 16 thread blocks per tile of 16
tokens splits both products across 16 SMs and shares ``z`` through distributed
shared memory, so ``z`` never goes to device memory. A rank whose z tile
does not fit a block's shared memory (above some 2480) runs in rank passes,
one launch each (``rank_passes``). Bound on the card: the bytes of
``v_tilde`` and ``u_hat`` (serving T is small); see the source note. The
plain version is ``ref.gar_matmul_ref`` followed by the same permutation
(``ops``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

# launches of the CUDA kernel since the last reset (plain int, read by
# chip_smoke.py to prove the serving path went through the kernel); every
# rank pass is a launch, and ``pass_launches`` counts those after a call's
# first
launches = 0
pass_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with its C signatures declared, once."""
    lib = build.library("gar_matmul")
    lib.gar_matmul_f32.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _P]
    lib.gar_matmul_f32.restype = _I
    lib.gar_matmul_smem_bytes.argtypes = [_I]
    lib.gar_matmul_smem_bytes.restype = _I
    return lib


def gar_matmul(x: torch.Tensor, v_tilde: torch.Tensor, u_hat: torch.Tensor,
               perm_inv: torch.Tensor) -> torch.Tensor:
    """x (T, n), v_tilde (n, r), u_hat (m - r, r) float32 and perm_inv (m,)
    int64, all contiguous on one CUDA device. Returns y (T, m)."""
    global launches, pass_launches
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
    lib = _lib()
    passes = rank_passes(lib, r)
    for i, (j0, j1) in enumerate(passes):
        rc = lib.gar_matmul_f32(x.data_ptr(), v_tilde.data_ptr(),
                                u_hat.data_ptr(), perm_inv.data_ptr(),
                                y.data_ptr(), t, n, r, mt, j0, j1 - j0,
                                int(i > 0), build.stream_ptr(x.device))
        build.check(rc, "gar_matmul")
    launches += len(passes)
    pass_launches += len(passes) - 1
    return y


def rank_passes(lib, r: int):
    """The column ranges ``[j0, j1)`` of z that one launch each computes:
    as few, and as even, as the shared memory of a block allows (one range
    up to some 2480 columns)."""
    return build.rank_passes(lib.gar_matmul_smem_bytes, r)
