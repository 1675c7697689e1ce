"""DataSVD: activation-aware low-rank factorization (paper §3.1 + App. C.1).

Given a layer weight ``W in R^{m x n}`` (acting as ``y = W x``) and the
activation second moment ``Sigma = X X^T``, SVD the whitened weight
``W Sigma^{1/2} = P Lambda Q^T`` and set ``U = P Lambda^{1/2}``,
``V = Sigma^{-1/2} Q Lambda^{1/2}`` (Eq. 61): truncating to the first r
columns is optimal in the data-weighted metric, and the columns are
importance-ordered. ``plain_svd_factors`` (Sigma = I) is the SVD baseline
the reference's ``decompose`` falls back to where no moment was recorded.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class Factors(NamedTuple):
    """Importance-ordered factorization W ~= U @ V.T (columns ordered)."""

    u: torch.Tensor  # (m, r)
    v: torch.Tensor  # (n, r)

    @property
    def rank(self) -> int:
        return self.u.shape[-1]

    def reconstruct(self, r: Optional[int] = None) -> torch.Tensor:
        if r is None:
            return self.u @ self.v.T
        return self.u[:, :r] @ self.v[:, :r].T


def datasvd_factors(w: torch.Tensor,
                    whitening: Tuple[torch.Tensor, torch.Tensor], *,
                    max_rank: Optional[int] = None) -> Factors:
    """Whitened SVD factorization of ``w`` (m, n), float32 on the device of
    ``w``. ``whitening``: ``covariance.sqrt_and_inv_sqrt`` of the
    activation moment (n, n) on that device (the experts of one MoE layer
    share one moment, so the caller computes it once for them). The JAX
    package's ``datasvd_factors(w, moment, count, max_rank=,
    damping=)`` is ``datasvd_factors(w, sqrt_and_inv_sqrt(moment, count,
    damping=damping), max_rank=)`` here."""
    w = w.to(torch.float32)
    s, s_inv = whitening
    p, lam, qt = torch.linalg.svd(w @ s, full_matrices=False)
    q = qt.T
    if max_rank is not None:
        p, lam, q = p[:, :max_rank], lam[:max_rank], q[:, :max_rank]
    sqrt_lam = torch.sqrt(lam)
    return Factors(u=p * sqrt_lam[None, :], v=(s_inv @ q) * sqrt_lam[None, :])


def plain_svd_factors(w: torch.Tensor, *,
                      max_rank: Optional[int] = None) -> Factors:
    """Weight-only SVD baseline (no activation weighting), float32 on the
    device of ``w``."""
    w = w.to(torch.float32)
    p, lam, qt = torch.linalg.svd(w, full_matrices=False)
    q = qt.T
    if max_rank is not None:
        p, lam, q = p[:, :max_rank], lam[:max_rank], q[:, :max_rank]
    sqrt_lam = torch.sqrt(lam)
    return Factors(u=p * sqrt_lam[None, :], v=q * sqrt_lam[None, :])


def reconstruction_error(w: torch.Tensor, factors: Factors, r: int,
                         moment: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Frobenius error of the rank-r truncation, data-weighted with
    ``moment``: ``tr(D Sigma D^T)`` with ``D = W - U_r V_r^T`` and the
    moment normalized by its trace, so errors compare across layers of
    different width; plain ``||D||_F^2`` without it."""
    delta = w.to(torch.float32) - factors.reconstruct(r)
    if moment is None:
        return torch.sum(delta * delta)
    sig = moment / torch.clamp(torch.trace(moment), min=1e-30)
    return torch.einsum("ij,jk,ik->", delta, sig, delta)


def truncation_error_curve(w: torch.Tensor, factors: Factors,
                           moment: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Errors of every truncation rank r = 1..R. Without a moment, the
    plain tail energies by the Gram trick (exact for the orthogonal
    columns of an SVD); with one, ``reconstruction_error`` at each rank,
    which holds for any factor pair."""
    if moment is None:
        lam2 = (torch.sum(factors.u * factors.u, dim=0)
                * torch.sum(factors.v * factors.v, dim=0))
        return torch.sum(lam2) - torch.cumsum(lam2, dim=0)
    return torch.stack([reconstruction_error(w, factors, r, moment)
                        for r in range(1, factors.rank + 1)])
