"""Whitening from an activation second moment (paper App. C.1).

The moment ``Sigma = X X^T`` itself is accumulated by the activation taps
(``models/common.py:record_tap``) on the activations' device; this module
turns it into the symmetric square root and inverse square root DataSVD
needs.
"""
from __future__ import annotations

from typing import Tuple

import torch


def sqrt_and_inv_sqrt(moment: torch.Tensor, count: float, *,
                      damping: float = 1e-6
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(S, S_inv)`` with ``S = Sigma^{1/2}`` of the damped, count-normalized
    moment, float32 on the moment's device. The damping is scale-aware
    (relative to the mean diagonal energy) and regularizes directions the
    calibration set never excited."""
    n = moment.shape[0]
    cov = moment.float() / max(float(count), 1.0)
    lam = damping * (torch.trace(cov) / n + 1e-30)
    cov = cov + lam * torch.eye(n, dtype=cov.dtype, device=cov.device)
    w, q = torch.linalg.eigh(cov)
    w = torch.clamp(w, min=0.0) + lam
    s = (q * torch.sqrt(w)) @ q.T
    s_inv = (q * (1.0 / torch.sqrt(w))) @ q.T
    return s, s_inv
