"""PowerSGD-style low-rank gradient compression (Vogels et al., 2019),
over gradient trees of tensors.

A gradient G (m, n) is sent as two thin factors instead of m * n values:
P = G Q, orthonormalise P, Q' = G^T P, Ghat = P Q'^T; error feedback keeps
G - Ghat for the next step. A stacked leaf (L, m, n) is one matrix (L,
m * n), as in the reference (unlike Muon's slice-by-slice rule).

On one device there is nothing to all-reduce: ``compress_decompress``
takes the mean of one replica, the identity, as the reference does with
``axis_name=None``. Compressing a data-parallel all-reduce needs a mesh of
cards (ROADMAP A.11). The initial Q of each leaf is the reference's own
draw (``threefry.split`` and ``threefry.normal``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch import threefry
from repro_torch.models import common as cm

PyTree = Any


@dataclasses.dataclass(frozen=True)
class PowerSGDConfig:
    rank: int = 8
    min_compress_size: int = 1 << 16   # don't compress small tensors
    ef: bool = True                    # error feedback


class PowerSGDState(NamedTuple):
    q: PyTree          # per-leaf Q matrices (zeros((0,)) placeholders)
    error: PyTree      # error-feedback residuals


def _eligible(p: torch.Tensor, cfg: PowerSGDConfig) -> bool:
    return p.dim() >= 2 and p.numel() >= cfg.min_compress_size


def _as_matrix(g: torch.Tensor) -> torch.Tensor:
    return g.reshape(g.shape[0], -1) if g.dim() != 2 else g


def _unflatten(tree: PyTree, leaves: list) -> PyTree:
    it = iter(leaves)
    return cm.tree_map(lambda _: next(it), tree)


def init(params: PyTree, cfg: PowerSGDConfig, seed: int = 0
         ) -> PowerSGDState:
    leaves = cm.tree_leaves(params)
    keys = threefry.split(threefry.prng_key(seed), len(leaves))
    qs, errs = [], []
    for key, p in zip(keys, leaves):
        if _eligible(p, cfg):
            qs.append(threefry.normal(key, (_as_matrix(p).shape[1],
                                            cfg.rank), device=p.device))
            errs.append(torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device))
        else:
            qs.append(torch.zeros((0,), dtype=torch.float32,
                                  device=p.device))
            errs.append(torch.zeros((0,), dtype=torch.float32,
                                    device=p.device))
    return PowerSGDState(q=_unflatten(params, qs),
                         error=_unflatten(params, errs))


@torch.no_grad()
def compress_decompress(grads: PyTree, state: PowerSGDState,
                        cfg: PowerSGDConfig, *,
                        axis_name: Optional[str] = None
                        ) -> Tuple[PyTree, PowerSGDState, dict]:
    """Rank-r approximation of ``grads`` as one replica's all-reduce
    (``axis_name=None``, the only case on one device). Returns
    (approximate gradients, new state, metrics with the bytes sent raw and
    compressed and their ratio)."""
    if axis_name is not None:
        raise NotImplementedError(
            "PowerSGD across a mesh axis is not ported yet (ROADMAP A.11: "
            "distributed training)")
    out_g, out_q, out_e = [], [], []
    raw_bytes = comp_bytes = 0
    for g, q, e in zip(cm.tree_leaves(grads), cm.tree_leaves(state.q),
                       cm.tree_leaves(state.error)):
        if q.numel() == 0:
            out_g.append(g)
            out_q.append(q)
            out_e.append(e)
            raw_bytes += g.numel() * 4
            comp_bytes += g.numel() * 4
            continue
        gm = _as_matrix(g.float() + e.float() if cfg.ef else g.float())
        p, _ = torch.linalg.qr(gm @ q)
        q_new = gm.T @ p
        ghat = (p @ q_new.T).reshape(g.shape)
        out_g.append(ghat.to(g.dtype))
        out_q.append(q_new)
        out_e.append(gm.reshape(g.shape) - ghat if cfg.ef else e)
        raw_bytes += gm.numel() * 4
        comp_bytes += (p.numel() + q_new.numel()) * 4
    metrics = {"powersgd_raw_bytes": raw_bytes,
               "powersgd_comp_bytes": comp_bytes,
               "powersgd_ratio": comp_bytes / max(raw_bytes, 1)}
    return (_unflatten(grads, out_g),
            PowerSGDState(q=_unflatten(grads, out_q),
                          error=_unflatten(grads, out_e)), metrics)
