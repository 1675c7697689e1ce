"""PTS / ASL / NSL training strategies on the linear model (paper §4,
Fig. 2), in PyTorch.

The paper's controlled setting: a linear model ``M = U V^T`` fitted to a
target ``M*`` with decaying singular values. The three objectives:

  PTS  — train only the full model,              Eq. (10)
  ASL  — average over *all* column subsets,      Eq. (11) (via the Bernoulli
         rank-dropout identity of Lemma B.4, so the 2^k sum is O(k))
  NSL  — average over *prefix* subsets only,     Eq. (12)

and the best-submodel optimality gap ``E(U, V, r)`` of Eq. (9) against the
Eckart–Young truncations ``A_r``. Theorems 4.1-4.3 are assertions on
``train``'s factors. ``train`` runs on the card unless given a device; its
initial factors are the reference's own threefry draws.
"""
from __future__ import annotations

import itertools
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, threefry


class LinearElastic(NamedTuple):
    u: torch.Tensor  # (m, k)
    v: torch.Tensor  # (n, k)


def make_target(rng: np.random.Generator, m: int, n: int, *,
                decay: float = 1.2) -> np.ndarray:
    """Random M* with power-law singular values (paper App. D.1)."""
    k = min(m, n)
    a = rng.standard_normal((m, m))
    b = rng.standard_normal((n, n))
    p, _ = np.linalg.qr(a)
    q, _ = np.linalg.qr(b)
    sig = np.power(np.arange(1, k + 1, dtype=np.float64), -decay)
    sig = sig / sig[0]
    return (p[:, :k] * sig[None, :]) @ q[:, :k].T


def svd_truncations(m_star: np.ndarray) -> np.ndarray:
    """Stack of Eckart–Young optima A_r, r = 1..k — the true Pareto front."""
    p, s, qt = np.linalg.svd(m_star, full_matrices=False)
    k = s.shape[0]
    outs = []
    for r in range(1, k + 1):
        outs.append((p[:, :r] * s[:r][None, :]) @ qt[:r, :])
    return np.stack(outs)


# ------------------------------- objectives --------------------------------

def pts_loss(params: LinearElastic, m_star: torch.Tensor) -> torch.Tensor:
    diff = params.u @ params.v.T - m_star
    return torch.sum(diff * diff)


def asl_loss(params: LinearElastic, m_star: torch.Tensor) -> torch.Tensor:
    """Closed-form expectation over uniform subsets (Lemma B.4).

    E_z ||U Pi_z V^T - M*||^2 = 1/4||UV^T - 2M*||^2 + 1/4 sum_j |u_j|^2|v_j|^2
    (up to the empty-mask shift of Lemma B.3, which doesn't move minimizers).
    """
    u, v = params
    w = u @ v.T
    quad = torch.sum((w - 2.0 * m_star) ** 2)
    col = torch.sum(torch.sum(u * u, dim=0) * torch.sum(v * v, dim=0))
    return 0.25 * (quad + col)


def nsl_loss(params: LinearElastic, m_star: torch.Tensor) -> torch.Tensor:
    """1/k sum_r ||U Pi_[r] V^T - M*||^2 in O(k) products via a cumsum."""
    u, v = params
    # rank-1 increments u_j v_j^T; their prefix sums are U Pi_[r] V^T
    outers = torch.einsum("mj,nj->jmn", u, v)
    prefixes = torch.cumsum(outers, dim=0)  # (k, m, n)
    diffs = prefixes - m_star[None]
    return torch.mean(torch.sum(diffs * diffs, dim=(1, 2)))


def train(loss_fn: Callable, m_star: np.ndarray, *, steps: int = 2000,
          lr: float = 2e-2, seed: int = 0, init_scale: float = 0.3,
          device=None) -> LinearElastic:
    """Full-batch Adam on one of the three objectives, in float32 on
    ``device`` (the card by default). The initial factors are
    ``init_scale * normal`` from ``split(PRNGKey(seed))``, as in the
    reference; the bias corrections ``1 - b ** t`` are float32, the
    reference's ``t`` being a float32 count."""
    device = resolve_device(device)
    m, n = m_star.shape
    k = min(m, n)
    ru, rv = threefry.split2(threefry.prng_key(seed))
    scale = np.float32(init_scale).item()
    u = scale * threefry.normal(ru, (m, k), device=device)
    v = scale * threefry.normal(rv, (n, k), device=device)
    params = [u.requires_grad_(True), v.requires_grad_(True)]
    target = torch.as_tensor(np.asarray(m_star, np.float32), device=device)
    mom = [torch.zeros_like(p) for p in params]
    var = [torch.zeros_like(p) for p in params]
    b1, b2, eps = 0.9, 0.999, 1e-8
    f32 = np.float32
    for t in range(steps):
        for p in params:
            p.grad = None
        loss_fn(LinearElastic(*params), target).backward()
        t1 = f32(t) + f32(1.0)
        c1 = (f32(1.0) - f32(b1) ** t1).item()
        c2 = (f32(1.0) - f32(b2) ** t1).item()
        with torch.no_grad():
            for p, a, b in zip(params, mom, var):
                g = p.grad
                a.copy_(b1 * a + (1 - b1) * g)
                b.copy_(b2 * b + (1 - b2) * g * g)
                mhat = a / c1
                vhat = b / c2
                p.copy_(p - lr * mhat / (torch.sqrt(vhat) + eps))
    return LinearElastic(params[0].detach(), params[1].detach())


# ------------------------------ gap evaluation ------------------------------

def best_submodel_gap(params: LinearElastic, m_star: np.ndarray, r: int, *,
                      exhaustive_limit: int = 16) -> float:
    """E(U, V, r): min over |S|=r column subsets of ||U Pi_S V^T - A_r||_F^2.

    Exhaustive for k <= exhaustive_limit, else greedy forward selection.
    """
    u = np.asarray(params.u.detach().cpu().numpy(), np.float64)
    v = np.asarray(params.v.detach().cpu().numpy(), np.float64)
    k = u.shape[1]
    a_r = svd_truncations(m_star)[r - 1]

    def err(subset) -> float:
        idx = list(subset)
        w = u[:, idx] @ v[:, idx].T
        return float(np.sum((w - a_r) ** 2))

    if k <= exhaustive_limit:
        return min(err(s) for s in itertools.combinations(range(k), r))
    chosen: Tuple[int, ...] = ()
    remaining = set(range(k))
    for _ in range(r):
        best = min(remaining, key=lambda j: err(chosen + (j,)))
        chosen += (best,)
        remaining.discard(best)
    return err(chosen)


def pareto_gaps(params: LinearElastic, m_star: np.ndarray) -> np.ndarray:
    k = min(m_star.shape)
    return np.asarray([best_submodel_gap(params, m_star, r)
                       for r in range(1, k + 1)])
