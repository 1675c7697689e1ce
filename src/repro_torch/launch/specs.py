"""Decode-state shapes of a cell, and the train step of the launcher's
modes: the parts of the JAX package's ``launch/specs.py`` that the port
runs. ``frontend_len`` and ``cache_specs`` feed the cost
model; the state is built on the ``meta`` device, so a full-size config
costs no memory. ``make_train_step`` is the reference's step of the
``dense``, ``flexrank`` and ``flexrank_kd`` modes: the loss and its
gradients under ``remat_blocks()``, then AdamW, through ``step``, the one
step body of the port, which the launcher's ``train_step`` takes too. The reference's input,
parameter, optimizer and cache shardings and its prefill and decode
steps serve only its XLA dry run, which has no counterpart here
(ROADMAP §A); the launcher's placements are ``distributed.sharding``'s.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import distributed as D
from repro_torch import threefry
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import distill
from repro_torch.core import flexrank as FR
from repro_torch.core.profiles import uniform_table
from repro_torch.distributed import collectives as C
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw, muon

COMPUTE_DTYPE = torch.bfloat16
INT32 = 4


def frontend_len(cfg: ModelConfig) -> int:
    if cfg.family == "vlm":
        return cfg.cross_attn_kv_len or 1601
    if cfg.family == "audio":
        return 1024  # precomputed speech frames (stub frontend)
    return 0


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                dtype=COMPUTE_DTYPE) -> Dict:
    """The decode state of ``shape`` (batch ``global_batch``, ``seq_len``
    positions) on ``meta``: shapes and dtypes only. Cross-attention K/V
    buffers are included for vlm/audio (precomputed once a request)."""
    ckv = frontend_len(cfg) if cfg.family in ("vlm", "audio") else 0
    return tfm.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                 dtype=dtype, device="meta",
                                 cross_kv_len=ckv)


def state_nbytes(state) -> int:
    """Bytes of a decode state laid out as the reference lays it out: every
    tensor, plus ``pos`` (an int32 scalar there) and each ``idx`` (an int32
    a stacked block, the lead dims of its ``k`` or MLA ``c_kv``), which the
    port keeps as host ints."""
    if state is None:
        return 0
    if isinstance(state, (list, tuple)):
        return sum(state_nbytes(s) for s in state)
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    total = 0
    for k, v in state.items():
        if k == "pos":
            total += INT32
        elif k == "idx":
            c = state["k"] if "k" in state else state["c_kv"]
            lead = c.shape[:c.dim() - (4 if "k" in state else 3)]
            total += INT32 * int(np.prod(lead, dtype=np.int64))
        else:
            total += state_nbytes(v)
    return total


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def grads_of(params) -> Dict:
    """The gradient tree after ``backward``: a leaf the loss does not reach
    (zamba2's per-unit ``ln_attn``: the shared block has its own norm) has
    a zero gradient, as under ``jax.grad``."""
    return cm.tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                       else p.grad, params)


def clear_grads(params) -> None:
    for p in cm.tree_leaves(params):
        p.grad = None


OptConfig = Union[adamw.AdamWConfig, muon.MuonConfig]


def apply_updates(params, grads, opt_state, opt_cfg: OptConfig, *,
                  grad_norm=None):
    """The optimizer step of ``opt_cfg``'s kind, in place."""
    if isinstance(opt_cfg, muon.MuonConfig):
        return muon.apply_updates(params, grads, opt_state, opt_cfg,
                                  grad_norm=grad_norm)
    return adamw.apply_updates(params, grads, opt_state, opt_cfg,
                               grad_norm=grad_norm)


def step(params, opt_state, forward: Callable[[], Tuple[torch.Tensor, Dict]],
         opt_cfg: OptConfig, *, remat: bool = False, mesh=None,
         shard_dims=None):
    """The body of every training step: ``forward() -> (loss, metrics)``
    and its backward in ``mesh``'s context (under ``remat_blocks`` with
    ``remat``); under a mesh with groups, the gradients averaged over its
    data axes and the clipping norm counting the leaves split over
    'model' along ``shard_dims`` once; then the in-place update of
    ``opt_cfg``'s kind, and the gradients cleared. Returns (params,
    opt_state, loss, metrics): the forward's metrics with the optimizer's
    (``grad_norm``, ``lr``) and ``sync``, the seconds of the gradients'
    all-reduce (0 without one)."""
    with D.mesh_context(mesh), (tfm.remat_blocks() if remat
                                else contextlib.nullcontext()):
        loss, metrics = forward()
        loss.backward()
    grads = grads_of(params)
    norm, sync = None, 0.0
    if mesh is not None:
        group = mesh.group(D.data_axes(mesh))
        if group is not None:
            t0 = time.perf_counter()
            C.all_reduce_mean_(cm.tree_leaves(grads), group)
            if loss.device.type == "cuda":
                torch.cuda.synchronize(loss.device)
            sync = time.perf_counter() - t0
        norm = D.split_global_norm(grads, shard_dims, mesh)
    params, opt_state, om = apply_updates(params, grads, opt_state, opt_cfg,
                                          grad_norm=norm)
    clear_grads(params)
    return params, opt_state, loss, {**metrics, **om, "sync": sync}


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, *,
                    mode: str = "dense", num_budgets: int = 7):
    """Returns ``train_step(params, opt_state, batch, rng,
    teacher_params=None) -> (params, opt_state, metrics)``, the update in
    place (``optim/adamw.py``), metrics ``loss`` (a detached device
    scalar, this rank's loss plus the MoE aux), ``grad_norm`` and ``lr``.
    It runs ``step`` under the current mesh, whose 'model' ranks hold
    their part of the expert leaves.

    mode 'dense': the dense forward, cross-entropy plus aux.
    mode 'flexrank': factorized params under the ranks of budget row
    ``k = randint(rng, (), 0, K)`` of the uniform table over the first
    ``num_budgets`` budgets of ``cfg.flexrank``, cross-entropy plus aux.
    mode 'flexrank_kd': the same, distilled from ``teacher_params`` (the
    frozen dense model) where given.

    The step's loss, ``loss_fn(params, batch, rng, teacher_params=None)``,
    is ``train_step.loss_fn``."""
    infos = (FR.group_infos(cfg)
             if mode in ("flexrank", "flexrank_kd") else None)
    table_rows = None
    if infos:
        table_rows = uniform_table(
            [i.path for i in infos], [i.full_rank for i in infos],
            cfg.flexrank.budgets[:num_budgets]).table
    kd = mode == "flexrank_kd"
    axes = cm.axes_tree(FR.factorized_spec(cfg) if infos
                        else tfm.model_spec(cfg))

    def loss_fn(params, batch, rng: threefry.Key,
                teacher_params: Optional[Dict] = None) -> torch.Tensor:
        tokens = batch["tokens"][:, :-1]
        labels = batch["tokens"][:, 1:]
        frontend = batch.get("frontend")
        ranks = None
        if infos:
            k = FR.budget_draw(rng, table_rows.shape[0])
            ranks = FR.ranks_tree(cfg, infos, table_rows, k)
        logits, aux = tfm.forward(params, cfg, tokens, ranks=ranks,
                                  frontend=frontend)
        if kd and teacher_params is not None:
            with torch.no_grad():
                t_logits, _ = tfm.forward(teacher_params, cfg, tokens,
                                          frontend=frontend)
            loss = distill.consolidation_loss(
                logits, t_logits, labels, kd_weight=cfg.flexrank.kd_weight,
                temperature=cfg.flexrank.kd_temperature)
        else:
            loss = distill.cross_entropy(logits, labels)
        return loss + aux

    def train_step(params, opt_state: adamw.AdamWState, batch,
                   rng: threefry.Key, teacher_params: Optional[Dict] = None):
        mesh = D.get_current_mesh()
        dims = None if mesh is None else D.expert_dims(mesh, axes, params)
        params, opt_state, loss, m = step(
            params, opt_state,
            lambda: (loss_fn(params, batch, rng, teacher_params), {}),
            opt_cfg, remat=True, mesh=mesh, shard_dims=dims)
        return params, opt_state, {"loss": loss.detach(),
                                   "grad_norm": m["grad_norm"],
                                   "lr": m["lr"]}

    train_step.loss_fn = loss_fn
    return train_step
