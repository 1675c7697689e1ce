"""AdamW with warmup and cosine/linear/constant schedules and global-norm
clipping, over parameter trees of tensors.

The update happens IN PLACE under ``torch.no_grad()``: the parameter
tensors, and the state's ``mu`` and ``nu``, are overwritten, where the JAX
package returns new trees. The state's ``step`` is a Python int. The
schedule and the bias corrections are computed on the host in float32, as
the reference computes them in float32 on the device. Decoupled weight
decay applies to leaves with ``ndim >= 2``, counted on the stored leaves:
a stacked norm scale of shape (layers, d) decays, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import common as cm

PyTree = Any
_F32 = np.float32


class AdamWState(NamedTuple):
    step: int
    mu: PyTree
    nu: PyTree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-5                       # paper App. D.3 default
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 715                # paper App. D.3
    total_steps: int = 10_000
    schedule: str = "cosine"               # cosine | linear | constant
    min_lr_ratio: float = 0.1


def schedule_lr(cfg: AdamWConfig, step: int) -> float:
    """Learning rate at ``step``, in float32 arithmetic."""
    step = _F32(step)
    warm = min(step / _F32(max(cfg.warmup_steps, 1)), _F32(1.0))
    if cfg.schedule == "constant":
        decay = _F32(1.0)
    else:
        frac = np.clip((step - _F32(cfg.warmup_steps))
                       / _F32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       _F32(0.0), _F32(1.0))
        lo = _F32(cfg.min_lr_ratio)
        if cfg.schedule == "linear":
            decay = _F32(1.0) - (_F32(1.0) - lo) * frac
        else:
            decay = lo + (_F32(1.0) - lo) * _F32(0.5) * (
                _F32(1.0) + np.cos(_F32(np.pi) * frac))
    return float(_F32(cfg.lr) * warm * decay)


def global_norm(tree: PyTree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in cm.tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree: PyTree, max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> Tuple[PyTree, torch.Tensor]:
    """Scale every leaf by ``min(1, max_norm / norm)``; returns (new tree,
    norm). ``norm`` defaults to the tree's global norm."""
    if norm is None:
        norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return cm.tree_map(lambda g: (g * scale).to(g.dtype), tree), norm


def init(params: PyTree) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=0, mu=cm.tree_map(zeros, params),
                      nu=cm.tree_map(zeros, params))


@torch.no_grad()
def apply_updates(params: PyTree, grads: PyTree, state: AdamWState,
                  cfg: AdamWConfig, *,
                  grad_norm: Optional[torch.Tensor] = None
                  ) -> Tuple[PyTree, AdamWState, dict]:
    """One AdamW step, in place (see the module note). Returns (params,
    state, metrics) with the same parameter and moment tensors, updated;
    metrics hold ``grad_norm`` (a device scalar) and ``lr``. ``grad_norm``
    is the global norm of the gradients where ``grads`` holds only this
    rank's part of some leaves (the launcher's expert split); by default,
    that of ``grads``."""
    if grad_norm is None:
        grad_norm = global_norm(grads)
    if cfg.clip_norm:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, grad_norm)
    else:
        gnorm = grad_norm
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    b1c = float(_F32(1.0) - _F32(cfg.b1) ** _F32(step))
    b2c = float(_F32(1.0) - _F32(cfg.b2) ** _F32(step))
    ps: List[torch.Tensor] = cm.tree_leaves(params)
    gs = [g.float() for g in cm.tree_leaves(grads)]
    mus = cm.tree_leaves(state.mu)
    nus = cm.tree_leaves(state.nu)
    torch._foreach_mul_(mus, cfg.b1)
    torch._foreach_add_(mus, gs, alpha=1 - cfg.b1)
    torch._foreach_mul_(nus, cfg.b2)
    torch._foreach_addcmul_(nus, gs, gs, value=1 - cfg.b2)
    denom = torch._foreach_div(nus, b2c)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    delta = torch._foreach_div(mus, b1c)
    torch._foreach_div_(delta, denom)
    if cfg.weight_decay:
        mats = [i for i, p in enumerate(ps) if p.dim() >= 2]
        torch._foreach_add_([delta[i] for i in mats], [ps[i] for i in mats],
                            alpha=cfg.weight_decay)
    torch._foreach_add_(ps, delta, alpha=-lr)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), metrics
