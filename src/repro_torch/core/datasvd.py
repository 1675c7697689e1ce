"""Low-rank factorization of one weight (paper §3.1).

Only the weight-only SVD baseline (``plain_svd_factors``) is ported: it is
what the reference's ``decompose`` falls back to per leaf when no
activation moment was recorded. The activation-aware DataSVD waits for the
calibration slice (ROADMAP).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Factors(NamedTuple):
    """Importance-ordered factorization W ~= U @ V.T (columns ordered)."""

    u: torch.Tensor  # (m, r)
    v: torch.Tensor  # (n, r)

    @property
    def rank(self) -> int:
        return self.u.shape[-1]


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
