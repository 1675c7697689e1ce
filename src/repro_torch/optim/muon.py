"""Muon: momentum-orthogonalized updates for hidden matrix layers (paper
§7's suggested direction; Jordan et al., 2024), over parameter trees of
tensors.

Matrix leaves (``ndim >= 2``, the embedding among them) take SGD momentum
whose update is orthogonalized by a quintic Newton-Schulz iteration
(approximately msign(G) = U V^T; coefficients (3.4445, -4.7750, 2.0315),
5 iterations); the other leaves take AdamW. A stacked leaf (L, m, n) is
orthogonalized slice by slice, as the reference's ``vmap`` does.

As in the reference, AdamW runs on every leaf first, so its moments of the
matrix leaves advance too (clipped by the global norm of all gradients:
they are checkpointed), and the matrix leaves are then overwritten with
``p - lr * scale * o``, ``p`` the parameter before the AdamW pass. The
port's AdamW updates in place, so the matrix leaves are copied before it
runs. Everything happens in place under ``torch.no_grad()``, on float32
parameters (the port trains in float32); ``step`` is a Python int. The
momentum of a non-matrix leaf is a ``zeros((0,))`` placeholder, as in
the reference, so that checkpoints interchange.

A matrix leaf cut over 'model' along one of its last two dimensions (the
tensor-parallel split) is orthogonalized whole: its update is gathered
over the axis, goes through Newton-Schulz as one rank's would, and each
rank keeps its part; its momentum stays cut. A leaf cut along a leading
dimension (the experts) is orthogonalized slice by slice as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import dim_leaves
from repro_torch.models import common as cm
from repro_torch.optim import adamw

PyTree = Any

_NS_COEFFS = (3.4445, -4.7750, 2.0315)


@dataclasses.dataclass(frozen=True)
class MuonConfig:
    lr: float = 2e-2                   # muon lr for matrix params
    momentum: float = 0.95
    nesterov: bool = True
    ns_steps: int = 5
    # AdamW for the non-matrix leaves (norms, scalars)
    adamw: adamw.AdamWConfig = adamw.AdamWConfig(lr=1e-3)
    min_matrix_dim: int = 2            # leaves with ndim >= 2 use muon


class MuonState(NamedTuple):
    step: int
    momentum: PyTree        # matrix leaves only (zeros((0,)) elsewhere)
    adamw_state: adamw.AdamWState


def newton_schulz(g: torch.Tensor, steps: int = 5) -> torch.Tensor:
    """Approximate msign(G) = U V^T of each (m, n) matrix of ``g`` (..., m,
    n) by the quintic Newton-Schulz iteration, in g's dtype: every slice
    is normalised by its own Frobenius norm and iterated on its wide
    orientation."""
    a, b, c = _NS_COEFFS
    x = g
    transpose = x.shape[-2] > x.shape[-1]
    if transpose:
        x = x.mT
    x = x / (torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True) + 1e-7)
    for _ in range(steps):
        gram = x @ x.mT
        x = a * x + (b * gram + (c * gram) @ gram) @ x
    return x.mT if transpose else x


def _use_muon(p: torch.Tensor, cfg: MuonConfig) -> bool:
    return p.dim() >= cfg.min_matrix_dim


def init(params: PyTree, cfg: MuonConfig) -> MuonState:
    def mom(p):
        shape = p.shape if _use_muon(p, cfg) else (0,)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    return MuonState(step=0, momentum=cm.tree_map(mom, params),
                     adamw_state=adamw.init(params))


@torch.no_grad()
def apply_updates(params: PyTree, grads: PyTree, state: MuonState,
                  cfg: MuonConfig, *, grad_norm=None, split=None
                  ) -> Tuple[PyTree, MuonState, dict]:
    """One step, in place (see the module note): Muon for the matrix
    leaves (each slice of a stacked one on its own), AdamW for the rest.
    Returns (params, state, AdamW's metrics). ``grad_norm`` goes to
    AdamW's clipping (``adamw.apply_updates``). ``split``: (dims, mesh),
    each leaf's dimension cut over the mesh's 'model' axis (None whole).

    The slices of every matrix leaf of one (m, n) shape go through
    ``newton_schulz`` as one batch: a slice's result is its own either
    way, and one batched call a shape replaces some forty launches a
    leaf (gpt2's factorized tree has 170 matrix leaves)."""
    leaves = cm.tree_leaves(params)
    idx = [i for i, p in enumerate(leaves) if _use_muon(p, cfg)]
    # exact copies of the matrix leaves before the AdamW pass
    before = torch._foreach_mul([leaves[i] for i in idx], 1.0)
    params, adamw_state, metrics = adamw.apply_updates(
        params, grads, state.adamw_state, cfg.adamw, grad_norm=grad_norm)
    gs = cm.tree_leaves(grads)
    moms = cm.tree_leaves(state.momentum)
    g32 = [gs[i].float() for i in idx]
    m = [moms[i] for i in idx]
    torch._foreach_mul_(m, cfg.momentum)
    torch._foreach_add_(m, g32)
    upd = list(torch._foreach_add(g32, torch._foreach_mul(m, cfg.momentum))
               if cfg.nesterov else m)
    # a matrix cut over 'model' along its rows or columns: whole for
    # Newton-Schulz, this rank's part kept after it
    cut: Dict[int, int] = {}
    dims, mesh = split if split is not None else (None, None)
    group = (mesh.group("model") if mesh is not None
             and "model" in mesh.axis_names else None)
    if group is not None:
        ds = dim_leaves(dims)
        for j, i in enumerate(idx):
            d = ds[i]
            if d is not None and d >= leaves[i].dim() - 2:
                cut[j] = d
                upd[j] = C.all_gather_along(upd[j], d, group)
    groups: Dict[Tuple[int, int], list] = {}
    for j, u in enumerate(upd):
        groups.setdefault(tuple(u.shape[-2:]), []).append(j)
    for (rows, cols), js in groups.items():
        o = newton_schulz(torch.cat([upd[j].reshape(-1, rows, cols)
                                     for j in js]), cfg.ns_steps)
        views = [v.reshape(upd[j].shape) for j, v in zip(js, torch.split(
            o, [upd[j].numel() // (rows * cols) for j in js]))]
        views = [C.own_chunk(v, cut[j], group) if j in cut else v
                 for j, v in zip(js, views)]
        # Jordan et al.'s sqrt(max(1, m/n)) keeps the update's RMS about
        # constant; its product with lr in float32, as the reference's
        torch._foreach_mul_(views, (np.float32(cfg.lr) * np.sqrt(np.maximum(
            np.float32(1.0), np.float32(rows / cols)))).item())
        torch._foreach_copy_([leaves[idx[j]] for j in js],
                             torch._foreach_sub([before[j] for j in js],
                                                views))
    return params, MuonState(step=state.step + 1, momentum=state.momentum,
                             adamw_state=adamw_state), metrics
