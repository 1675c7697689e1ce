"""PowerSGD-style low-rank gradient compression (Vogels et al., 2019),
over gradient trees of tensors.

A gradient G (m, n) is sent as two thin factors instead of m * n values:
P = G Q, orthonormalise P, Q' = G^T P, Ghat = P Q'^T; error feedback keeps
G - Ghat for the next step. A stacked leaf (L, m, n) is one matrix (L,
m * n), as in the reference (unlike Muon's slice-by-slice rule).

With ``axis_name`` the mean runs over that axis of the current mesh
(``distributed.mesh_context``), as the reference's ``pmean`` under
``shard_map`` does, at its three points: the leaves passed through
whole, ``G Q`` and ``G^T P``. Without it the mean is of one replica, the
identity. The initial Q of each leaf is the reference's own draw
(``threefry.split`` and ``threefry.normal``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch import threefry
from repro_torch.distributed import collectives as C
from repro_torch.distributed import get_current_mesh
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


def _pmean(axis_name: Optional[str]):
    """The mean over ``axis_name`` of the current mesh, as a function of a
    tensor."""
    if axis_name is None:
        return lambda x: x
    mesh = get_current_mesh()
    if mesh is None:
        raise NameError(f"unbound axis name: {axis_name} (no current mesh)")
    if axis_name not in mesh.axis_names:
        raise NameError(f"unbound axis name: {axis_name} (mesh axes "
                        f"{mesh.axis_names})")
    group = mesh.group(axis_name)

    def pmean(x):
        x = x.clone()
        C.all_reduce_mean_([x], group)
        return x
    return pmean


@torch.no_grad()
def compress_decompress(grads: PyTree, state: PowerSGDState,
                        cfg: PowerSGDConfig, *,
                        axis_name: Optional[str] = None
                        ) -> Tuple[PyTree, PowerSGDState, dict]:
    """Rank-r approximate mean of ``grads`` over the ranks of
    ``axis_name`` on the current mesh (one replica's, the identity, with
    ``axis_name=None``). Returns (approximate mean gradients, new state,
    metrics with the bytes sent raw and compressed and their ratio). An
    axis name without a current mesh, or that the mesh lacks, raises, as
    ``jax.lax.pmean`` does on an unbound axis."""
    pmean = _pmean(axis_name)
    out_g, out_q, out_e = [], [], []
    raw_bytes = comp_bytes = 0
    for g, q, e in zip(cm.tree_leaves(grads), cm.tree_leaves(state.q),
                       cm.tree_leaves(state.error)):
        if q.numel() == 0:
            out_g.append(pmean(g))
            out_q.append(q)
            out_e.append(e)
            raw_bytes += g.numel() * 4
            comp_bytes += g.numel() * 4
            continue
        gm = _as_matrix(g.float() + e.float() if cfg.ef else g.float())
        p, _ = torch.linalg.qr(pmean(gm @ q))
        q_new = pmean(gm.T @ p)
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
