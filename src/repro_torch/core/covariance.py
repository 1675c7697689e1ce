"""Activation second moments and their whitening (paper App. C.1).

DataSVD needs ``Sigma_l = X_l X_l^T`` for every factorized layer. Rather
than store the activations, batches are folded into the unnormalized
moment, O(n^2) memory whatever the number of samples (Eq. 60):
``CovarianceState`` and ``accumulate``, and ``collect_layer_moments`` over
a toy ``apply_fn``. The launchers' calibration accumulates the same
moments through the activation taps (``models/common.py:record_tap``).
``sqrt_and_inv_sqrt`` turns a moment into the whitening DataSVD needs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Tuple

import torch


@dataclasses.dataclass
class CovarianceState:
    """Running unnormalized second moment for one layer input."""

    moment: torch.Tensor  # (n, n) float32
    count: torch.Tensor   # () float32: activation vectors folded in

    @staticmethod
    def create(n: int, device=None) -> "CovarianceState":
        return CovarianceState(
            moment=torch.zeros((n, n), dtype=torch.float32, device=device),
            count=torch.zeros((), dtype=torch.float32, device=device))


def accumulate(state: CovarianceState, x: torch.Tensor) -> CovarianceState:
    """Fold a batch of activations ``x`` (..., n) into the running moment,
    in float32 whatever the activations' dtype, on their device."""
    n = x.shape[-1]
    flat = x.reshape(-1, n).to(torch.float32)
    return CovarianceState(moment=state.moment + flat.T @ flat,
                           count=state.count + flat.shape[0])


def collect_layer_moments(apply_fn: Callable, params, batches: Iterable,
                          layer_taps: Dict[str, int]
                          ) -> Dict[str, CovarianceState]:
    """Run calibration batches through ``apply_fn(params, batch) ->
    (outputs, taps)`` and fold each tap (the input of a linear layer, of
    width ``layer_taps[name]``) into its moment, without gradients. The
    states live on the device of the first batch's taps (the CPU when
    there is no batch)."""
    states = None
    with torch.no_grad():
        for batch in batches:
            _, taps = apply_fn(params, batch)
            if states is None:
                states = {k: CovarianceState.create(n, taps[k].device)
                          for k, n in layer_taps.items()}
            states = {k: accumulate(states[k], taps[k]) for k in states}
    if states is None:
        states = {k: CovarianceState.create(n)
                  for k, n in layer_taps.items()}
    return states


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
