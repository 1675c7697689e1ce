"""Gauge-Aligned Reparametrization (paper §3.5).

A rank-r factorization ``W_r = U_r V_r^T`` is gauge-free: for any invertible
``G``, ``(U_r G)(G^{-1} V_r^T)`` is the same matrix. GAR picks
``G = (U_r[rows, :])^{-1}`` for a set of r pivot rows so that ``U_r G`` has an
*identity block* on those rows. The identity is neither stored nor multiplied:

    z         = V_tilde^T x          # r x n  -> r
    y[rows]   = z                    # free
    y[other]  = U_hat @ z            # (m-r) x r

total ``O((m + n - r) r)`` FLOPs vs ``O(mn)`` dense.

The transform runs in float64 on the device of its inputs (the card at
deploy time), with the same partial-pivoting row selection as the JAX
package's host-side numpy version, so both pick the same pivots. It takes
a stack of factor pairs of one rank at once (a group's layers, an MoE
layer's experts): each matrix of the stack gets the arithmetic it would
get alone, and the pivot loop's launches are shared.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class GarFactors(NamedTuple):
    """Deployable GAR form of one layer (or a stack of them, with leading
    batch dims) at a fixed rank r.

    y = P^T [z ; u_hat @ z],  z = v_tilde^T @ x
    """

    u_hat: torch.Tensor    # (..., m - r, r) float32
    v_tilde: torch.Tensor  # (..., n, r) float32
    perm: torch.Tensor     # (..., m) int64, output permutation (pivot rows
    #                        first)

    @property
    def rank(self) -> int:
        return self.v_tilde.shape[1]


def _pivot_rows(u: torch.Tensor) -> torch.Tensor:
    """Greedy partial-pivoting row selection: r rows making U[rows]
    well-conditioned. Gaussian elimination with row pivoting on a float64
    working copy, O(m r^2). u: (m, r), or (N, m, r) for N matrices
    eliminated side by side (rows (N, m)). Runs without a host round trip
    per column: the pivot swap is an indexed copy and a near-zero pivot
    zeroes its elimination step instead of branching on the host. Only the
    columns right of the pivot are updated; the earlier ones are never
    read again, so the pivots are those of the full update."""
    work = u.to(torch.float64).clone()
    if u.dim() == 2:
        work = work[None]
    n, m, r = work.shape
    rows = torch.arange(m, device=u.device).repeat(n, 1)
    mats = torch.arange(n, device=u.device)[:, None]
    for j in range(r):
        pivot = j + torch.argmax(work[:, j:, j].abs(), dim=1)
        pair = torch.stack([torch.full_like(pivot, j), pivot], dim=1)
        swap = pair.flip(1)
        work[mats, pair] = work[mats, swap]
        rows[mats, pair] = rows[mats, swap]
        piv = work[:, j, j, None]
        below = work[:, j + 1:, j] / piv
        below = torch.where(piv.abs() < 1e-12, torch.zeros_like(below), below)
        work[:, j + 1:, j + 1:] -= below[:, :, None] * work[:, j, None, j + 1:]
    return rows if u.dim() == 3 else rows[0]


def gar_transform(u: torch.Tensor, v: torch.Tensor, r: int, *,
                  pivot: bool = True) -> GarFactors:
    """The GAR form of the rank-r truncation of (u, v), computed in float64
    on the device of ``u`` (O(m r^2) pivoting plus an O(r^3) inverse).
    u: (m, R), v: (n, R), or (N, m, R) and (N, n, R) for a stack of N
    pairs (factors (N, ...))."""
    u_r = u[..., :r].to(torch.float64)
    v_r = v[..., :r].to(torch.float64)
    m = u_r.shape[-2]
    rows = _pivot_rows(u_r) if pivot else torch.arange(
        m, device=u.device).expand(u_r.shape[:-1])
    u_p = torch.take_along_dim(u_r, rows[..., None], dim=-2)
    # gauge G = U[rows,:]^{-1}, one matrix at a time (a stack of large
    # ones would take the card's small-matrix batched routines)
    top = u_p[..., :r, :]
    g = torch.stack([torch.linalg.inv(a) for a in top.reshape(-1, r, r)]
                    ).reshape(top.shape)
    u_hat = u_p[..., r:, :] @ g       # rows r.. of U_p G; the top block is I
    # W = U_r V_r^T = (U_r G)(G^{-1} V_r^T);  G^{-1} = U_p[:r]
    v_tilde = v_r @ u_p[..., :r, :].transpose(-1, -2)
    return GarFactors(u_hat=u_hat.to(torch.float32),
                      v_tilde=v_tilde.to(torch.float32), perm=rows)


def gar_apply(gar: GarFactors, x: torch.Tensor) -> torch.Tensor:
    """Plain forward ``y = W_r x`` for x of shape (..., n), O((m+n-r) r),
    as the JAX package computes it outside its kernel; ``kernels.ops.
    gar_forward`` is the kernel's route."""
    z = x @ gar.v_tilde                           # (..., r)
    tail = z @ gar.u_hat.T                        # (..., m - r)
    y_perm = torch.cat([z, tail], dim=-1)
    return y_perm[..., torch.argsort(gar.perm)]


def gar_flops(m: int, n: int, r: int, tokens: int = 1) -> int:
    """Theoretical MACs of the GAR forward (the paper's O((m+n-r) r))."""
    return tokens * (n * r + (m - r) * r)


def lowrank_flops(m: int, n: int, r: int, tokens: int = 1) -> int:
    return tokens * (n * r + m * r)


def dense_flops(m: int, n: int, tokens: int = 1) -> int:
    return tokens * m * n


def reconstruction(gar: GarFactors) -> torch.Tensor:
    """Dense W_r implied by the GAR form (tests and yardsticks)."""
    eye = torch.eye(gar.rank, dtype=gar.v_tilde.dtype,
                    device=gar.v_tilde.device)
    u_tilde = torch.cat([eye, gar.u_hat], dim=0)
    return (u_tilde @ gar.v_tilde.T)[torch.argsort(gar.perm)]
