"""The inputs, parameters, optimizer state and decode state of an (arch x
shape) cell, their placements on a mesh, and the step functions (train,
prefill, decode): the JAX package's ``launch/specs.py``.

Nothing here allocates for a full-size model: inputs and caches are
``meta`` tensors, parameters and optimizer state ``ParamSpec`` trees
(``models.common.instantiate`` on ``meta`` makes them tensors). The dry run
(``launch/dryrun.py``) traces the steps on them; the cost model reads
``cache_specs``; the training launcher runs ``step``, the one step body
of the port.

Placements are the port's (``distributed.sharding``): tuples of mesh
axes a dimension, built with the reference's rules. They state the
layout of the reference's XLA program, and the port's ranks execute it
(``fsdp=False``): the batch rows over the data axes, and over 'model'
each leaf's experts, heads, kv-heads, MLP columns, vocabulary or rank
(``sharding.rank_dims``, run by ``models/tp.py`` and
``models/moe.py``), and the attention stacks' decode caches as
``cache_shardings`` places them (``cache_specs(mesh=)``): their k/v
heads over 'model', or their sequence over 'model' (kv-heads that do
not divide the axis) or over 'data' (a batch of one). Held whole on
every 'model' rank: the leaves ``sharding.deferred`` names (MLA's
attention, the recurrent blocks), their caches but for
the batch rows (MLA's latent cache, the recurrent states, zamba's shared
attention), and ``fsdp=True``'s data-axis cut.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

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
from repro_torch.models import tp
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw, muon

PyTree = Any

COMPUTE_DTYPE = torch.bfloat16
INT32 = 4


def frontend_len(cfg: ModelConfig) -> int:
    if cfg.family == "vlm":
        return cfg.cross_attn_kv_len or 1601
    if cfg.family == "audio":
        return 1024  # precomputed speech frames (stub frontend)
    return 0


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str,
                                                              torch.Tensor]:
    """``meta`` stand-ins for every model input of the cell: tokens (B, S
    + 1) for train, (B, S) for prefill, (B, 1) for decode (its cache
    carries the sequence), int32; the frontend's frames (B, T_f,
    frontend_dim) in ``COMPUTE_DTYPE`` for vlm and audio, except at
    decode, whose cross-attention K/V are in its state."""
    b, s = shape.global_batch, shape.seq_len
    n = {"train": s + 1, "prefill": s}.get(shape.kind, 1)
    out = {"tokens": torch.empty((b, n), dtype=torch.int32, device="meta")}
    fl = frontend_len(cfg)
    if fl and shape.kind != "decode":
        out["frontend"] = torch.empty((b, fl, cfg.frontend_dim),
                                      dtype=COMPUTE_DTYPE, device="meta")
    return out


def input_shardings(mesh: D.Mesh, cfg: ModelConfig, shape: ShapeConfig
                    ) -> Dict[str, D.Placement]:
    """The inputs' rows over the data axes; a batch of one held whole."""
    bspec = D.batch_spec(mesh, extra_dims=1)
    out = {"tokens": bspec if shape.global_batch > 1 else (None, None)}
    if frontend_len(cfg) and shape.kind != "decode":
        out["frontend"] = (bspec[0] if shape.global_batch > 1 else None,
                           None, None)
    return out


# ---------------------------------------------------------------------------
# params / optimizer
# ---------------------------------------------------------------------------

def model_param_specs(cfg: ModelConfig, *, mode: str = "dense",
                      budget_index: Optional[int] = None
                      ) -> Tuple[PyTree, PyTree]:
    """(spec tree, logical axes tree) of the ``dense``, ``flexrank`` /
    ``flexrank_kd`` (factorized), ``flexrank_sliced`` (factors cut to one
    budget's ranks) and ``gar`` (deployed at one budget) modes."""
    if mode == "dense":
        spec = tfm.model_spec(cfg)
    elif mode in ("flexrank", "flexrank_kd"):
        spec = FR.factorized_spec(cfg)
    elif mode == "flexrank_sliced":
        spec = _sliced_spec(cfg, budget_index)
    elif mode == "gar":
        spec = _gar_spec(cfg, budget_index if budget_index is not None
                         else -2)
    else:
        raise ValueError(mode)
    return spec, cm.axes_tree(spec)


def _sliced_spec(cfg: ModelConfig, budget_index: Optional[int]) -> PyTree:
    """The factorized spec with each group's rank that of row
    ``budget_index`` (default: the middle row) of the uniform table,
    rounded up to a multiple of 256 where the full rank is 256 or more."""
    infos = FR.group_infos(cfg)
    tbl = uniform_table([i.path for i in infos], [i.full_rank for i in infos],
                        cfg.flexrank.budgets)
    k = budget_index if budget_index is not None else tbl.table.shape[0] // 2

    def _round(r, full):
        return min(full, int(-(-r // 256) * 256)) if full >= 256 else r
    row = {i.path: _round(int(tbl.table[k][i.col]), i.full_rank)
           for i in infos}
    excl = cfg.flexrank.exclude
    return cm.factorize_spec(
        tfm.model_spec(cfg),
        predicate=lambda path, sp: not any(t in path for t in excl),
        max_rank_fn=lambda path, sp: row.get(path))


def _gar_spec(cfg: ModelConfig, budget_index: int) -> PyTree:
    """The factorized spec deployed as GAR at budget ``budget_index``
    (0.5 where the index is out of range): rank ``r`` with ``r (m + n -
    r) = frac m n``, leaves ``u_hat`` (m - r, r), ``v_tilde`` (n, r) and
    an int32 ``perm_inv`` (m,)."""
    budgets = cfg.flexrank.budgets
    frac = (budgets[budget_index]
            if -len(budgets) <= budget_index < len(budgets) else 0.5)

    def conv(tree):
        if isinstance(tree, dict) and {"u", "v"} <= set(tree) \
                and cm.is_spec(tree.get("u")):
            u, v = tree["u"], tree["v"]
            lead, lead_axes = u.shape[:-2], u.axes[:-2]
            m, n, rf = u.shape[-2], v.shape[-2], u.shape[-1]
            r = int(np.floor(((m + n) - np.sqrt((m + n) ** 2
                                                - 4 * frac * m * n)) / 2))
            r = max(min(r, rf - 1, m - 1, n - 1), 1)
            return {
                "u_hat": cm.ParamSpec(lead + (m - r, r),
                                      lead_axes + (u.axes[-2], cm.RANK)),
                "v_tilde": cm.ParamSpec(lead + (n, r),
                                        lead_axes + (v.axes[-2], cm.RANK)),
                "perm_inv": cm.ParamSpec(lead + (m,), lead_axes + (None,),
                                         "zeros", torch.int32),
            }
        if isinstance(tree, dict):
            return {k: conv(v_) for k, v_ in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [conv(v_) for v_ in tree]
        return tree

    return conv(FR.factorized_spec(cfg))


def optimizer_specs(param_specs: PyTree) -> adamw.AdamWState:
    """The AdamW state's spec tree: an int32 step, float32 moments."""
    def as_f32():
        return cm.tree_map(
            lambda s: cm.ParamSpec(s.shape, s.axes, "zeros", torch.float32),
            param_specs, is_leaf=cm.is_spec)
    return adamw.AdamWState(step=cm.ParamSpec((), (), "zeros", torch.int32),
                            mu=as_f32(), nu=as_f32())


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                dtype=COMPUTE_DTYPE, device="meta", mesh=None) -> Dict:
    """The decode state of ``shape`` (batch ``global_batch``, ``seq_len``
    positions), on ``meta`` by default: shapes and dtypes only.
    Cross-attention K/V buffers are included for vlm/audio (precomputed
    once a request).

    With ``mesh``: this rank's part of it. Each self- and cross-attention
    K/V entry of an attention stack has the shape ``shard_shape`` gives
    under ``cache_shardings``; where that cuts the sequence, its dict
    holds ``rows`` = (the axis, the global position of its first row),
    which ``models/attention.py`` reads. Zamba's shared attention keeps
    its whole sequence (its heads and batch rows are cut), and the other
    entries (MLA's latent cache, the recurrent states: blocks the rank
    runs whole) are cut by their batch rows only."""
    ckv = frontend_len(cfg) if cfg.family in ("vlm", "audio") else 0
    state = tfm.init_decode_state(
        cfg, shape.global_batch, shape.seq_len, dtype=dtype,
        device="meta" if mesh is not None else device, cross_kv_len=ckv)
    if mesh is None:
        return state
    pls = cache_shardings(mesh, cfg, shape, state)
    segments = []
    for seg, c, pl in zip(cfg.segments, state["segments"], pls["segments"]):
        how = ("placed" if D.deferred_block(cfg, seg) is None
               else "no_seq" if seg.kind == "zamba_unit" else "batch")
        segments.append(_rank_part(mesh, c, pl, how, device))
    return {"pos": 0, "segments": segments}


_KV_KEYS = ("k", "v", "cross_k", "cross_v")


def _rank_part(mesh: D.Mesh, node, pl, how: str, device, key=None):
    """Zeros of this rank's part of a decode state ``node`` under its
    placements ``pl``, of which it executes (``how``) every entry of its
    K/V ('placed'), all but their sequence's ('no_seq'), or only the
    batch rows' ('batch')."""
    if node is None:
        return None
    if isinstance(node, dict):
        out = {k: _rank_part(mesh, v, pl[k], how, device, k)
               for k, v in node.items()}
        spec = pl.get("k") if how == "placed" else None
        if spec:
            seq = spec[len(spec) - 3]
            if seq is not None and mesh.size(seq) > 1:
                out["rows"] = (seq[0], mesh.index(seq) * out["k"].shape[-3])
        return out
    if not isinstance(node, torch.Tensor):
        return node
    nd = node.dim()
    spec = list(pl) + [None] * (nd - len(pl))
    if how == "no_seq" and key in ("k", "v"):
        spec[nd - 3] = None
    elif how != "placed" or key not in _KV_KEYS:
        batch = {nd + off for off, ax in _CACHE_RULES.get(key, {}).items()
                 if ax == "batch"}
        spec = [e if i in batch else None for i, e in enumerate(spec)]
    return torch.zeros(shard_shape(mesh, spec, node.shape),
                       dtype=node.dtype, device=device)


# key -> {dimension from the right: mesh axis}, and "seq": the sequence
# dimension that a batch of one places on 'data'
_CACHE_RULES = {
    "k": {-2: "model", -4: "batch", "seq": -3},
    "v": {-2: "model", -4: "batch", "seq": -3},
    "cross_k": {-2: "model", -4: "batch"},
    "cross_v": {-2: "model", -4: "batch"},
    "c_kv": {-3: "batch", "seq": -2},
    "k_rope": {-3: "batch", "seq": -2},
    "conv": {-1: "model", -3: "batch"},
    "ssd": {-3: "model", -4: "batch"},
    "wkv": {-3: "model", -4: "batch"},
    "shift_t": {-2: "batch"},
    "shift_c": {-2: "batch"},
}


def _cache_placement(mesh: D.Mesh, key: Optional[str], shp, batch1: bool
                     ) -> D.Placement:
    nd = len(shp)
    rule = _CACHE_RULES.get(key)
    if rule is None:
        return ()
    d_ax = D.data_axes(mesh)
    spec = [None] * nd
    for off, ax in rule.items():
        if off == "seq" or nd + off < 0:
            continue
        i = nd + off
        if ax == "model" and "model" in mesh.axis_names:
            n = mesh.shape["model"]
            if shp[i] % n == 0:
                spec[i] = ("model",)
            elif key in ("k", "v") and nd >= 3 and shp[nd - 3] % n == 0:
                # kv-heads that do not divide 'model' (8 heads on 16
                # ranks): the cache's sequence goes there instead
                spec[nd - 3] = ("model",)
        elif ax == "batch" and not batch1 and d_ax:
            if shp[i] % mesh.size(d_ax) == 0:
                spec[i] = d_ax
    if batch1 and "seq" in rule and "data" in mesh.axis_names:
        i = nd + rule["seq"]
        if 0 <= i < nd and shp[i] % mesh.shape["data"] == 0:
            spec[i] = ("data",)
    return tuple(spec)


def cache_shardings(mesh: D.Mesh, cfg: ModelConfig, shape: ShapeConfig,
                    caches: PyTree) -> PyTree:
    """The decode state's placements: kv-heads and state heads on
    'model', the batch over the data axes; a batch of one (long-context
    decode) places the *sequence* on 'data' instead, the
    sequence-parallel KV layout. ``pos``, ``idx`` and leaves without a
    rule are replicated (``()``)."""
    batch1 = shape.global_batch == 1

    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, key) for v in node]
        if isinstance(node, torch.Tensor):
            return _cache_placement(mesh, key, tuple(node.shape), batch1)
        return None if node is None else ()
    return walk(caches, None)


def shard_shape(mesh: D.Mesh, placement: D.Placement,
                shape) -> Tuple[int, ...]:
    """A leaf's shape on one device under ``placement``: each placed
    dimension over the size of its axes."""
    dims = tuple(shape)
    spec = tuple(placement) + (None,) * (len(dims) - len(placement))
    return tuple(d if e is None else d // mesh.size(e)
                 for d, e in zip(dims, spec))


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
        if k == "rows":
            continue        # a rank's host value, not the reference's
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
                  grad_norm=None, split=None):
    """The optimizer step of ``opt_cfg``'s kind, in place. ``split``:
    (dims, mesh) of leaves cut over 'model', for Muon's whole-matrix
    orthogonalization."""
    if isinstance(opt_cfg, muon.MuonConfig):
        return muon.apply_updates(params, grads, opt_state, opt_cfg,
                                  grad_norm=grad_norm, split=split)
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
    params, opt_state, om = apply_updates(
        params, grads, opt_state, opt_cfg, grad_norm=norm,
        split=None if shard_dims is None else (shard_dims, mesh))
    clear_grads(params)
    return params, opt_state, loss, {**metrics, **om, "sync": sync}


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, *,
                    mode: str = "dense", num_budgets: int = 7):
    """Returns ``train_step(params, opt_state, batch, rng,
    teacher_params=None) -> (params, opt_state, metrics)``, the update in
    place (``optim/adamw.py``), metrics ``loss`` (a detached device
    scalar, this rank's loss plus the MoE aux), ``grad_norm`` and ``lr``.
    It runs ``step`` under the current mesh, whose 'model' ranks hold
    their part of each leaf (``sharding.rank_dims``).

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
    spec = FR.factorized_spec(cfg) if infos else tfm.model_spec(cfg)
    axes = cm.axes_tree(spec)

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
                temperature=cfg.flexrank.kd_temperature,
                vocab=cfg.vocab_size)
        else:
            loss = distill.cross_entropy(logits, labels,
                                         vocab=cfg.vocab_size)
        return loss + aux

    def train_step(params, opt_state: adamw.AdamWState, batch,
                   rng: threefry.Key, teacher_params: Optional[Dict] = None):
        mesh = D.get_current_mesh()
        # the split of the whole leaves: a rank's part need not divide
        # 'model' again
        dims = None if mesh is None else D.rank_dims(cfg, mesh, axes, spec)
        params, opt_state, loss, m = step(
            params, opt_state,
            lambda: (loss_fn(params, batch, rng, teacher_params), {}),
            opt_cfg, remat=True, mesh=mesh, shard_dims=dims)
        return params, opt_state, {"loss": loss.detach(),
                                   "grad_norm": m["grad_norm"],
                                   "lr": m["lr"]}

    train_step.loss_fn = loss_fn
    return train_step


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch) -> next-token logits (B, V)``, whole
    over the vocabulary (gathered where a 'model' rank holds its
    columns)."""
    def prefill_step(params, batch):
        with torch.no_grad():
            logits, _ = tfm.forward(params, cfg, batch["tokens"],
                                    frontend=batch.get("frontend"))
            return tp.whole_vocab(logits[:, -1], cfg.vocab_size)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_step(params, state, batch) -> (logits (B, V), state)``,
    the state updated in place, the logits whole over the vocabulary."""
    def decode_step(params, state, batch):
        with torch.no_grad():
            logits, state = tfm.decode_step(params, cfg, state,
                                            batch["tokens"],
                                            kv_source=batch.get("frontend"))
            return tp.whole_vocab(logits[:, 0], cfg.vocab_size), state
    return decode_step
