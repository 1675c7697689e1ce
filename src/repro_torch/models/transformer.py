"""Model assembly: the train/prefill forward and the paged serving forward.

A model is a sequence of segments, each a stack of ``count`` identical
blocks with stacked parameters (a leading layers axis). The JAX package
scans a segment with ``lax.scan`` and unrolls it into a tap-scoped Python
loop only for calibration; here a Python loop always walks its layers,
each under ``tap_scope(f"@{l}")``, so the tap keys are the reference's.
Segment kinds: self-attention stacks ('attn'/'attn_dense'; the
attention is MLA where the config has one, and an 'attn' block's FFN is
an MoE where the config has one), 'rwkv', 'mamba', 'zamba_unit' (a
stack of mamba blocks, then the model's one *shared* attention block,
then the unit's FFN), 'encoder' (bidirectional attention blocks, run by
``run_encoder`` over the frontend's frames), 'decoder' (a self-attention
block, then a gated cross-attention block over the encoder's output) and
'vision_unit' (``self_per_unit`` self-attention blocks, then a gated
cross-attention block over the projected image patches). The cross
blocks run only where a source or its cached K/V is given: without one
(the serving engines' text-only requests) they are skipped, as in the
reference.

Ranks trees mirror the parameters (``{'segments': [{'attn': {'q': r,
...}, 'mlp': {...}}, ...], 'shared_attn': {...}}``) with one Python int
per factorized group, shared by the group's layers.

Under ``remat_blocks()`` (the training step's activation checkpointing)
every per-layer body that ``run_segment`` walks, a zamba unit's body and
each Mamba2 layer inside it, runs through
``torch.utils.checkpoint.checkpoint``: only the layer boundaries stay
alive and the backward recomputes the rest. Values and gradients do not
change; the peak memory does.

Public API:
  model_spec(cfg)                                 -> ParamSpec tree
  forward(params, cfg, tokens, ranks=, frontend=) -> (logits, aux)
  run_encoder(params, cfg, frames, ranks=)        -> encoder output
  init_decode_state(cfg, batch, max_len,
                    cross_kv_len=)                -> contiguous decode state
  attach_cross_kv(params, cfg, state, source)     -> state with cross K/V
  decode_step / prefill(params, cfg, state, tok,
                        kv_source=)               -> (logits, state)
  paged_decode_step(params, cfg, caches, tokens)  -> (logits, caches)
  paged_mixed_step(params, cfg, caches, tokens)   -> (logits, caches)
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig, Segment
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import tp
from repro_torch.models.common import ParamSpec

GLOBAL_WINDOW = 1 << 30

# activation checkpointing of every layer body, set by ``remat_blocks``
_REMAT = {"on": False}


@contextlib.contextmanager
def remat_blocks():
    """Activation checkpointing for the train step, as the reference's
    ``remat_blocks`` wraps every scanned body in ``jax.checkpoint``."""
    prev = _REMAT["on"]
    _REMAT["on"] = True
    try:
        yield
    finally:
        _REMAT["on"] = prev


def _body(fn: Callable, *args):
    """``fn(*args)``, through ``checkpoint`` under ``remat_blocks`` when
    autograd records. The forward draws nothing random, so no RNG state is
    kept for the recomputation."""
    if _REMAT["on"] and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)

def _attn_block_spec(cfg: ModelConfig, *, moe: bool) -> Dict:
    return {
        "ln_attn": ParamSpec((cfg.d_model,), (None,), "zeros"),
        "ln_mlp": ParamSpec((cfg.d_model,), (None,), "zeros"),
        "attn": mla_mod.mla_spec(cfg) if cfg.mla else attn.attn_spec(cfg),
        "mlp": moe_mod.moe_spec(cfg) if moe else attn.ffn_spec(cfg),
    }


def _mamba_block_spec(cfg: ModelConfig) -> Dict:
    return {
        "ln": ParamSpec((cfg.d_model,), (None,), "zeros"),
        "mamba": ssm_mod.mamba_spec(cfg),
    }


def _cross_block_spec(cfg: ModelConfig) -> Dict:
    return {
        "ln_attn": ParamSpec((cfg.d_model,), (None,), "zeros"),
        "ln_mlp": ParamSpec((cfg.d_model,), (None,), "zeros"),
        "gate": ParamSpec((1,), (None,), "zeros"),      # tanh-gated residual
        "attn": attn.attn_spec(cfg),
        "mlp": attn.ffn_spec(cfg),
    }


def segment_spec(cfg: ModelConfig, seg: Segment) -> Dict:
    if seg.kind == "attn":
        return cm.stack_spec(_attn_block_spec(cfg, moe=cfg.moe is not None),
                             seg.count)
    if seg.kind == "attn_dense":  # the dense-FFN blocks of an MoE model
        return cm.stack_spec({
            "ln_attn": ParamSpec((cfg.d_model,), (None,), "zeros"),
            "ln_mlp": ParamSpec((cfg.d_model,), (None,), "zeros"),
            "attn": attn.attn_spec(cfg),
            "mlp": attn.ffn_spec(cfg),
        }, seg.count)
    if seg.kind == "mamba":
        return cm.stack_spec(_mamba_block_spec(cfg), seg.count)
    if seg.kind == "rwkv":
        return cm.stack_spec(rwkv_mod.rwkv_spec(cfg), seg.count)
    if seg.kind == "zamba_unit":
        return cm.stack_spec({
            "mambas": cm.stack_spec(_mamba_block_spec(cfg),
                                    seg.mamba_per_unit),
            "ln_attn": ParamSpec((cfg.d_model,), (None,), "zeros"),
            "ln_mlp": ParamSpec((cfg.d_model,), (None,), "zeros"),
            "mlp": attn.ffn_spec(cfg),
        }, seg.count)
    if seg.kind == "vision_unit":
        return cm.stack_spec({
            "selfs": cm.stack_spec(_attn_block_spec(cfg, moe=False),
                                   seg.self_per_unit),
            "cross": _cross_block_spec(cfg),
        }, seg.count)
    if seg.kind == "encoder":
        return cm.stack_spec(_attn_block_spec(cfg, moe=False), seg.count)
    if seg.kind == "decoder":
        unit = _attn_block_spec(cfg, moe=False)
        unit["cross"] = _cross_block_spec(cfg)
        return cm.stack_spec(unit, seg.count)
    raise ValueError(f"unknown segment kind {seg.kind}")


def model_spec(cfg: ModelConfig) -> Dict:
    spec: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), (cm.VOCAB, cm.EMBED)),
        "final_norm": ParamSpec((cfg.d_model,), (None,), "zeros"),
        "segments": [segment_spec(cfg, s) for s in cfg.segments],
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = {"w": ParamSpec((cfg.d_model, cfg.vocab_size),
                                          (cm.EMBED, cm.VOCAB))}
    if any(s.kind == "zamba_unit" for s in cfg.segments):
        # zamba's single *shared* full-attention block (weights reused by
        # every unit)
        spec["shared_attn"] = {
            "ln_attn": ParamSpec((cfg.d_model,), (None,), "zeros"),
            "attn": attn.attn_spec(cfg),
        }
    if cfg.frontend_dim:
        spec["frontend_proj"] = {"w": ParamSpec(
            (cfg.frontend_dim, cfg.d_model), (None, cm.EMBED))}
    return spec


def window_schedule(cfg: ModelConfig, count: int,
                    offset: int = 0) -> List[int]:
    """Per-layer attention window (GLOBAL_WINDOW = full lookback)."""
    if not cfg.local_window or not cfg.global_every:
        return [GLOBAL_WINDOW] * count
    return [GLOBAL_WINDOW if (i + 1) % cfg.global_every == 0
            else cfg.local_window for i in range(offset, offset + count)]


def embed_tokens(params: Dict, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """The tokens' embedding rows (vocabulary-parallel where the table is
    a 'model' rank's rows: ``tp.embed``)."""
    return tp.embed(params["embed"], tokens, cfg.vocab_size)


def lm_logits(params: Dict, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Final norm + LM head, tied or not (a plain large product, as in the
    reference, which leaves it to XLA). Where the head is a 'model' rank's
    part the logits are this rank's vocabulary columns."""
    x = cm.rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    if cfg.tie_embeddings:
        return tp.tied_logits(x, params["embed"], cfg.vocab_size)
    return cm.linear(params["lm_head"], x,
                     whole=(cfg.d_model, cfg.vocab_size))


def frontend_proj(params: Dict, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """``frontend_proj`` of the modality's frames (B, T, frontend_dim);
    factorized, both of its factors may be a 'model' rank's columns."""
    r = min(cfg.frontend_dim, cfg.d_model, cfg.flexrank.max_rank
            or cfg.d_model)
    return cm.linear(params["frontend_proj"], x,
                     whole=(cfg.frontend_dim, cfg.d_model, r))


def paged_compatible(cfg: ModelConfig) -> bool:
    """The paged path covers pure self-attention stacks (MoE FFNs
    included; MLA stacks go to drain)."""
    return (cfg.mla is None and cfg.frontend_dim == 0
            and all(s.kind in ("attn", "attn_dense") for s in cfg.segments))


def _seg_ranks(ranks, i):
    if not isinstance(ranks, dict) or "segments" not in ranks:
        return None
    segs = ranks["segments"]
    return segs[i] if i < len(segs) else None


def _layer(tree, l: int):
    return cm.tree_map(lambda a: a[l], tree)


def rget_tree(ranks, key):
    if not isinstance(ranks, dict):
        return None
    return ranks.get(key)


def _apply_attn_block(p, x, cfg, *, positions, window, ranks, cache=None,
                      moe=False):
    """rms_norm -> self-attention (MLA where the config has it) ->
    residual -> rms_norm -> FFN (or MoE) -> residual. Returns (x, the
    attention cache or None, the block's aux loss: the MoE's, else 0)."""
    h = cm.rms_norm(x, p["ln_attn"], eps=cfg.norm_eps)
    attn_fn = mla_mod.mla_apply if cfg.mla else attn.attn_apply
    with cm.tap_scope("attn"):
        y, new_cache = attn_fn(p["attn"], h, cfg, positions=positions,
                               window=window,
                               ranks=rget_tree(ranks, "attn"), cache=cache)
    x = x + y
    h = cm.rms_norm(x, p["ln_mlp"], eps=cfg.norm_eps)
    with cm.tap_scope("mlp"):
        if moe:
            # the reference's choice: expert-parallel for every uncached
            # call of more than one token (moe_apply_ep is moe_apply
            # without a mesh)
            apply_fn = (moe_mod.moe_apply_ep
                        if cache is None and h.shape[1] > 1
                        else moe_mod.moe_apply)
            y, aux = apply_fn(p["mlp"], h, cfg,
                              ranks=rget_tree(ranks, "mlp"))
        else:
            y, aux = attn.ffn_apply(p["mlp"], h,
                                    ranks=rget_tree(ranks, "mlp"),
                                    d_ff=cfg.d_ff), 0.0
    return x + y, new_cache, aux


def _apply_cross_block(p, x, cfg, *, kv_source, ranks, static_kv=None):
    """rms_norm -> cross-attention over ``kv_source`` (or the cached
    ``static_kv``), no RoPE, non-causal -> residual through ``tanh(gate)``
    -> rms_norm -> FFN -> residual. Taps under ``cross/attn`` and
    ``cross/mlp``."""
    h = cm.rms_norm(x, p["ln_attn"], eps=cfg.norm_eps)
    positions = torch.arange(x.shape[1], device=x.device)
    with cm.tap_scope("cross"), cm.tap_scope("attn"):
        y, _ = attn.attn_apply(p["attn"], h, cfg, positions=positions,
                               window=GLOBAL_WINDOW,
                               ranks=rget_tree(ranks, "attn"),
                               kv_source=kv_source, static_kv=static_kv,
                               causal=False, use_rope=False)
    x = x + torch.tanh(p["gate"].to(x.dtype)) * y
    h = cm.rms_norm(x, p["ln_mlp"], eps=cfg.norm_eps)
    with cm.tap_scope("cross"), cm.tap_scope("mlp"):
        return x + attn.ffn_apply(p["mlp"], h, ranks=rget_tree(ranks, "mlp"),
                                  d_ff=cfg.d_ff)


_CROSS_KEYS = ("cross_k", "cross_v")
# an attention cache's host values, shared by its stacked blocks: the next
# row to write and, on a rank whose rows are cut, (axis, first row)
HOST_KEYS = ("idx", "rows")


def _self_cache(cache: Dict, l: int) -> Dict:
    """Layer ``l``'s self-attention cache out of a stacked attention cache
    (its cross K/V left out), the host values shared."""
    return {k: t if k in HOST_KEYS else t[l] for k, t in cache.items()
            if k not in _CROSS_KEYS}


def _cross_kv(cache: Optional[Dict], l: int):
    """Layer (or unit) ``l``'s cached cross (k, v), or None."""
    if not isinstance(cache, dict) or "cross_k" not in cache:
        return None
    return cache["cross_k"][l], cache["cross_v"][l]


def _apply_mamba_block(p, x, cfg, *, ranks, state=None):
    h = cm.rms_norm(x, p["ln"], eps=cfg.norm_eps)
    with cm.tap_scope("mamba"):
        y, new_state = ssm_mod.mamba_apply(p["mamba"], h, cfg,
                                           ranks=rget_tree(ranks, "mamba"),
                                           state=state)
    return x + y, new_state


def _store(stacked: Dict, l: int, new: Dict) -> None:
    """Write one layer's new recurrent state into row ``l`` of the stacked
    state tensors, in place."""
    for key, t in new.items():
        stacked[key][l].copy_(t)


def run_segment(seg: Segment, params: Dict, x: torch.Tensor,
                cfg: ModelConfig, *, positions: torch.Tensor,
                ranks: Optional[Dict], layer_offset: int,
                cache: Optional[Dict] = None,
                shared_attn_params: Optional[Dict] = None,
                shared_attn_ranks: Optional[Dict] = None,
                kv_source: Optional[torch.Tensor] = None):
    """Walk one segment layer by layer. Returns (x, cache, aux), aux the
    sum of the segment's MoE aux losses (a float32 tensor; 0.0 without
    MoE).

    Without ``cache`` (train, calibration, eval) the result's cache is
    None. With the segment's decode cache (``init_decode_state``) every
    layer continues from its row of the stacked state: attention K/V (or
    MLA's latent) are written in place at the cache's ``idx``, recurrent
    states are replaced in place by the step's new ones, and the returned
    cache is the same tensors with ``idx`` advanced by the step's
    tokens.

    A 'zamba_unit' runs its mamba stack under ``tap_scope("mambas")`` (tap
    keys with two layer indices, ``segments/i/@u/mambas/@m/...``), then the
    shared attention block under the absolute scope ``shared_attn/attn``
    (one moment per projection, summed over every unit; with a cache each
    unit keeps its own K/V for the shared weights), then its FFN.

    An 'encoder' runs bidirectional blocks at the global window (no
    cache). A 'decoder' layer and a 'vision_unit' (its self blocks under
    ``tap_scope("selfs")``, ``segments/i/@u/selfs/@l/...``, at the global
    window) end in the cross block, over ``kv_source`` or the layer's
    (unit's) cached ``cross_k``/``cross_v``; with neither the cross block
    is skipped."""
    s = x.shape[1]
    if seg.kind in ("attn", "attn_dense", "decoder"):
        windows = window_schedule(cfg, seg.count, layer_offset)
        moe = cfg.moe is not None and seg.kind == "attn"
        aux = 0.0
        for l in range(seg.count):
            def layer(x, l=l):
                cache_l = None if cache is None else _self_cache(cache, l)
                p_l = _layer(params, l)
                with cm.tap_scope(f"@{l}"):
                    x, _, aux_l = _apply_attn_block(
                        p_l, x, cfg, positions=positions, window=windows[l],
                        ranks=ranks, cache=cache_l, moe=moe)
                    skv = _cross_kv(cache, l)
                    if seg.kind == "decoder" and (kv_source is not None
                                                  or skv is not None):
                        x = _apply_cross_block(
                            p_l["cross"], x, cfg, kv_source=kv_source,
                            ranks=rget_tree(ranks, "cross"), static_kv=skv)
                return x, aux_l
            x, aux_l = _body(layer, x)
            aux = aux + aux_l
        return x, None if cache is None else dict(
            cache, idx=cache["idx"] + s), aux
    if seg.kind == "encoder":
        for l in range(seg.count):
            def layer(x, l=l):
                p_l = _layer(params, l)
                with cm.tap_scope(f"@{l}"):
                    h = cm.rms_norm(x, p_l["ln_attn"], eps=cfg.norm_eps)
                    with cm.tap_scope("attn"):
                        y, _ = attn.attn_apply(
                            p_l["attn"], h, cfg, positions=positions,
                            window=GLOBAL_WINDOW,
                            ranks=rget_tree(ranks, "attn"), causal=False)
                    x = x + y
                    h = cm.rms_norm(x, p_l["ln_mlp"], eps=cfg.norm_eps)
                    with cm.tap_scope("mlp"):
                        return x + attn.ffn_apply(
                            p_l["mlp"], h, ranks=rget_tree(ranks, "mlp"),
                            d_ff=cfg.d_ff)
            x = _body(layer, x)
        return x, cache, 0.0
    if seg.kind == "vision_unit":
        sranks = rget_tree(ranks, "selfs")
        scache = None if cache is None else cache["selfs"]
        for u in range(seg.count):
            def unit(x, u=u):
                p_u = _layer(params, u)
                with cm.tap_scope(f"@{u}"):
                    with cm.tap_scope("selfs"):
                        for l in range(seg.self_per_unit):
                            def self_layer(x, l=l):
                                cache_l = None if scache is None else \
                                    _self_cache(_self_cache(scache, u), l)
                                with cm.tap_scope(f"@{l}"):
                                    return _apply_attn_block(
                                        _layer(p_u["selfs"], l), x, cfg,
                                        positions=positions,
                                        window=GLOBAL_WINDOW, ranks=sranks,
                                        cache=cache_l)[0]
                            x = _body(self_layer, x)
                    skv = _cross_kv(cache, u)
                    if kv_source is not None or skv is not None:
                        x = _apply_cross_block(
                            p_u["cross"], x, cfg, kv_source=kv_source,
                            ranks=rget_tree(ranks, "cross"), static_kv=skv)
                return x
            x = _body(unit, x)
        if cache is None:
            return x, None, 0.0
        return x, dict(cache, selfs=dict(cache["selfs"],
                                         idx=cache["selfs"]["idx"] + s)), \
            0.0
    if seg.kind == "mamba":
        for l in range(seg.count):
            def layer(x, l=l):
                state_l = None if cache is None else _layer(cache, l)
                with cm.tap_scope(f"@{l}"):
                    return _apply_mamba_block(_layer(params, l), x, cfg,
                                              ranks=ranks, state=state_l)
            x, new = _body(layer, x)
            if cache is not None:
                _store(cache, l, new)
        return x, cache, 0.0
    if seg.kind == "rwkv":
        for l in range(seg.count):
            def layer(x, l=l):
                state_l = None if cache is None else _layer(cache, l)
                with cm.tap_scope(f"@{l}"):
                    return rwkv_mod.rwkv_apply(_layer(params, l), x, cfg,
                                               ranks=ranks, state=state_l)
            x, new = _body(layer, x)
            if cache is not None:
                _store(cache, l, new)
        return x, cache, 0.0
    if seg.kind != "zamba_unit":
        raise ValueError(f"unknown segment kind {seg.kind}")
    mranks = rget_tree(ranks, "mambas")
    for u in range(seg.count):
        def unit(x, u=u):
            p_u = _layer(params, u)
            mcache = None if cache is None else _layer(cache["mamba"], u)
            acache = None if cache is None else {
                "k": cache["attn"]["k"][u], "v": cache["attn"]["v"][u],
                "idx": cache["attn"]["idx"]}
            with cm.tap_scope(f"@{u}"):
                with cm.tap_scope("mambas"):
                    for l in range(seg.mamba_per_unit):
                        def mamba_layer(x, l=l):
                            state_l = None if mcache is None else _layer(
                                mcache, l)
                            with cm.tap_scope(f"@{l}"):
                                return _apply_mamba_block(
                                    _layer(p_u["mambas"], l), x, cfg,
                                    ranks=mranks, state=state_l)
                        x, new = _body(mamba_layer, x)
                        if mcache is not None:
                            _store(mcache, l, new)
                h = cm.rms_norm(x, shared_attn_params["ln_attn"],
                                eps=cfg.norm_eps)
                with cm.tap_scope("shared_attn/attn", absolute=True):
                    y, _ = attn.attn_apply(
                        shared_attn_params["attn"], h, cfg,
                        positions=positions, window=GLOBAL_WINDOW,
                        ranks=rget_tree(shared_attn_ranks, "attn"),
                        cache=acache)
                x = x + y
                h = cm.rms_norm(x, p_u["ln_mlp"], eps=cfg.norm_eps)
                tp.require_whole(p_u["mlp"], lambda: attn.ffn_spec(cfg),
                                 "zamba mlp")
                with cm.tap_scope("mlp"):
                    return x + attn.ffn_apply(p_u["mlp"], h, d_ff=cfg.d_ff,
                                              ranks=rget_tree(ranks, "mlp"))
        x = _body(unit, x)
    if cache is None:
        return x, None, 0.0
    return x, {"mamba": cache["mamba"],
               "attn": dict(cache["attn"], idx=cache["attn"]["idx"] + s)}, \
        0.0


def run_encoder(params: Dict, cfg: ModelConfig, enc_input: torch.Tensor,
                ranks: Optional[Dict] = None) -> torch.Tensor:
    """The encoder side of an encoder-decoder model over the frontend's
    frames (B, T, F): ``frontend_proj`` where F is ``frontend_dim`` (at
    full rank under a ``ranks`` tree, as in the reference), the encoder
    segments at positions ``0 .. T - 1``, then ``rms_norm`` with the
    model's ``final_norm`` (the LM head's). T must fit one query chunk or
    be a multiple of it (``attention.Q_CHUNK``)."""
    x = enc_input
    if cfg.frontend_dim and x.shape[-1] == cfg.frontend_dim:
        x = frontend_proj(params, x, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    for i, seg in enumerate(cfg.segments):
        if seg.kind != "encoder":
            continue
        with cm.tap_scope(f"segments/{i}", absolute=True):
            x, _, _ = run_segment(seg, params["segments"][i], x, cfg,
                                  positions=positions,
                                  ranks=_seg_ranks(ranks, i), layer_offset=0)
    return cm.rms_norm(x, params["final_norm"], eps=cfg.norm_eps)


def forward(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            ranks: Optional[Dict] = None,
            frontend: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None):
    """Train/prefill forward. tokens: (B, S). Returns (logits (B, S, V),
    aux_loss), aux the float32 sum of every MoE layer's load-balancing
    loss (zero without MoE).

    ``frontend``: the modality's embeddings (B, T_f, frontend_dim): the
    encoder's input for audio, the cross blocks' K/V source (through
    ``frontend_proj``, at full rank under ``ranks``) for vlm. Encoder
    segments are skipped here (and do not advance the layer offset)."""
    x = embed_tokens(params, tokens, cfg)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    kv_source = None
    if cfg.family == "audio" and frontend is not None:
        kv_source = run_encoder(params, cfg, frontend, ranks)
    elif cfg.family == "vlm" and frontend is not None:
        kv_source = frontend_proj(params, frontend, cfg)
    offset = 0
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, seg in enumerate(cfg.segments):
        if seg.kind == "encoder":
            continue
        with cm.tap_scope(f"segments/{i}", absolute=True):
            x, _, aux = run_segment(
                seg, params["segments"][i], x, cfg, positions=positions,
                ranks=_seg_ranks(ranks, i), layer_offset=offset,
                shared_attn_params=params.get("shared_attn"),
                shared_attn_ranks=rget_tree(ranks, "shared_attn"),
                kv_source=kv_source)
        aux_total = aux_total + aux
        offset += seg.count
    return lm_logits(params, x, cfg), aux_total


# ------------------------------------------------------------- decode

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      dtype=torch.bfloat16, device=None,
                      cross_kv_len: int = 0) -> Dict:
    """Zero decode state matching the segment structure:

      {'pos': 0, 'segments': [per segment: attention {'k', 'v': (L, B,
       max_len, Hkv, D) in ``dtype``, 'idx': 0}, or for MLA {'c_kv': (L,
       B, max_len, kv_rank), 'k_rope': (L, B, max_len, rope_dim), 'idx':
       0}; mamba {'conv', 'ssd'};
       rwkv {'shift_t', 'shift_c', 'wkv'}; zamba_unit {'mamba': {'conv':
       (U, M, B, K-1, C), 'ssd': (U, M, B, H, N, P)}, 'attn': {'k', 'v':
       (U, B, max_len, Hkv, D), 'idx': 0}}; encoder None; decoder the
       attention cache; vision_unit {'selfs': {'k', 'v': (U, P, B,
       max_len, Hkv, D), 'idx': 0}}]}

    ``cross_kv_len`` > 0 adds zero cross-attention buffers 'cross_k',
    'cross_v': (L or U, B, cross_kv_len, Hkv, D) in ``dtype`` to every
    decoder and vision_unit segment, for ``attach_cross_kv`` to fill once
    a request.

    A rank's part of it under a mesh is ``launch/specs.py:cache_specs``'s.

    The recurrent states are float32 (the reference's default). ``pos`` and
    ``idx`` are host ints, where the reference keeps int32 arrays: the
    drain loop knows them, so slicing the cache by them never waits for
    the card (``bridge.decode_state_to_numpy`` gives the reference's
    arrays). Every unit of a zamba or vision segment has zeros of its own:
    the reference broadcasts one unit's, which the port's in-place updates
    would then share."""
    hd = cfg.resolved_head_dim

    def kv(count):
        return attn.init_kv_cache(cfg, batch, max_len, dtype=dtype,
                                  num_instances=count, device=device)

    def with_cross(c, count):
        if cross_kv_len:
            shape = (count, batch, cross_kv_len, cfg.num_kv_heads, hd)
            for k in _CROSS_KEYS:
                c[k] = torch.zeros(shape, dtype=dtype, device=device)
        return c

    segments = []
    for seg in cfg.segments:
        if seg.kind == "encoder":
            segments.append(None)
        elif seg.kind in ("attn", "attn_dense") and cfg.mla:
            segments.append(mla_mod.init_mla_cache(
                cfg, batch, max_len, dtype=dtype, num_instances=seg.count,
                device=device))
        elif seg.kind in ("attn", "attn_dense"):
            segments.append(kv(seg.count))
        elif seg.kind == "decoder":
            segments.append(with_cross(kv(seg.count), seg.count))
        elif seg.kind == "vision_unit":
            selfs = kv(seg.count * seg.self_per_unit)
            for k in ("k", "v"):
                selfs[k] = selfs[k].reshape(seg.count, seg.self_per_unit,
                                            *selfs[k].shape[1:])
            segments.append(with_cross({"selfs": selfs}, seg.count))
        elif seg.kind == "mamba":
            segments.append(ssm_mod.init_mamba_state(
                cfg, batch, num_instances=seg.count, device=device))
        elif seg.kind == "rwkv":
            segments.append(rwkv_mod.init_rwkv_state(
                cfg, batch, num_instances=seg.count, device=device))
        elif seg.kind == "zamba_unit":
            mamba = ssm_mod.init_mamba_state(
                cfg, batch, num_instances=seg.count * seg.mamba_per_unit,
                device=device)
            segments.append({
                "mamba": {k: t.reshape(seg.count, seg.mamba_per_unit,
                                       *t.shape[1:])
                          for k, t in mamba.items()},
                "attn": kv(seg.count)})
        else:
            raise ValueError(f"unknown segment kind {seg.kind}")
    return {"pos": 0, "segments": segments}


def attach_cross_kv(params: Dict, cfg: ModelConfig, state: Dict,
                    kv_source: torch.Tensor) -> Dict:
    """Fill the state's cross-attention K/V buffers once a request, IN
    PLACE: each cross block's ``compute_cross_kv`` over ``kv_source``,
    the projected source (vlm: ``frontend_proj`` of the patches; audio:
    the encoder's output), (B, cross_kv_len, d), in the buffers' head
    layout (this rank's heads or all). Returns the state."""
    nkv = cfg.num_kv_heads
    for i, seg in enumerate(cfg.segments):
        c = state["segments"][i]
        if not isinstance(c, dict) or "cross_k" not in c:
            continue
        cross_p = params["segments"][i]["cross"]["attn"]
        want = c["cross_k"].shape[-2]
        for l in range(c["cross_k"].shape[0]):
            k, v = attn.compute_cross_kv(_layer(cross_p, l), cfg, kv_source)
            k0 = attn.first_head(k, nkv)
            c["cross_k"][l].copy_(tp.own_heads(k, nkv, k0, want)[0])
            c["cross_v"][l].copy_(tp.own_heads(v, nkv, k0, want)[0])
    return state


def has_cross_kv(state: Dict) -> bool:
    return any(isinstance(c, dict) and "cross_k" in c
               for c in state["segments"])


def decode_step(params: Dict, cfg: ModelConfig, state: Dict,
                tokens: torch.Tensor, *, ranks: Optional[Dict] = None,
                kv_source: Optional[torch.Tensor] = None):
    """One decode step. tokens: (B, S). Returns (logits (B, S, V), state).

    S = 1 is the classic decode step; S > 1 runs a single-pass batched
    prefill through the same state (``prefill``). The state's tensors are
    updated in place (the reference returns new arrays; the paged steps
    update their pools in place too) and the returned state holds them
    with ``pos`` advanced by S.

    ``kv_source``: the cross blocks' source every step (audio: the
    encoder's output; vlm: the raw patches, projected here by
    ``frontend_proj`` unless the state holds cached cross K/V). With
    cached cross K/V (``attach_cross_kv``) the step takes one token (S of
    1), as in the reference; without either the cross blocks are
    skipped."""
    pos = state["pos"]
    s = tokens.shape[1]
    positions = torch.arange(pos, pos + s, device=tokens.device)
    x = embed_tokens(params, tokens, cfg)
    if (cfg.family == "vlm" and kv_source is not None
            and not has_cross_kv(state)
            and kv_source.shape[-1] == cfg.frontend_dim):
        kv_source = frontend_proj(params, kv_source, cfg)
    segments = []
    offset = 0
    for i, seg in enumerate(cfg.segments):
        if seg.kind == "encoder":
            segments.append(None)
            continue
        x, new_c, _ = run_segment(seg, params["segments"][i], x, cfg,
                                  positions=positions,
                                  ranks=_seg_ranks(ranks, i),
                                  layer_offset=offset,
                                  cache=state["segments"][i],
                                  shared_attn_params=params.get(
                                      "shared_attn"),
                                  shared_attn_ranks=rget_tree(
                                      ranks, "shared_attn"),
                                  kv_source=kv_source)
        segments.append(new_c)
        offset += seg.count
    return lm_logits(params, x, cfg), {"pos": pos + s, "segments": segments}


def prefill(params: Dict, cfg: ModelConfig, state: Dict,
            tokens: torch.Tensor, *, ranks: Optional[Dict] = None,
            kv_source: Optional[torch.Tensor] = None):
    """Single-pass batched prefill: the whole prompt (B, S) in one forward
    that writes the decode state. Returns (logits (B, S, V), state);
    ``logits[:, -1]`` seeds the first generated token. The recurrent
    segments carry their state through the plain chunked forms: an rwkv
    prompt longer than the family's chunk must be a multiple of it, and a
    mamba prompt runs as one chunk of S steps (an (B, S, S, H) decay
    tensor), as in the reference. ``kv_source`` as for ``decode_step``;
    over cached cross K/V a prompt of S > 1 (other than the cache's
    length) raises ``ValueError``, as it does in the reference."""
    return decode_step(params, cfg, state, tokens, ranks=ranks,
                       kv_source=kv_source)


def _run_paged_segments(params, cfg, x, caches, ranks, attn_fn):
    """rms_norm -> paged attention (``attn_fn``) -> residual -> rms_norm ->
    ffn (or MoE, over the step's flat batch) -> residual, layer by layer, shared by the paged decode and mixed
    steps so that the two stay structurally identical. ``attn_fn(p_attn,
    h, window, k_pool, v_pool, ranks)`` -> (y, k_pool, v_pool) with the
    pools of one layer, updated in place; ``window`` is the layer's window,
    or None for all-global configs. Returns (x, segment pools)."""
    windowed = bool(cfg.local_window and cfg.global_every)
    offset = 0
    for i, seg in enumerate(cfg.segments):
        seg_ranks = _seg_ranks(ranks, i)
        pool = caches["segments"][i]
        windows = window_schedule(cfg, seg.count, offset)
        moe = cfg.moe is not None and seg.kind == "attn"
        for l in range(seg.count):
            p_l = _layer(params["segments"][i], l)
            ranks_l = None if seg_ranks is None else _layer(seg_ranks, l)
            h = cm.rms_norm(x, p_l["ln_attn"], eps=cfg.norm_eps)
            y, _, _ = attn_fn(p_l["attn"], h,
                              windows[l] if windowed else None,
                              pool["k"][l], pool["v"][l],
                              (ranks_l or {}).get("attn"))
            x = x + y
            h = cm.rms_norm(x, p_l["ln_mlp"], eps=cfg.norm_eps)
            if moe:
                y, _ = moe_mod.moe_apply(p_l["mlp"], h, cfg,
                                         ranks=(ranks_l or {}).get("mlp"))
            else:
                y = attn.ffn_apply(p_l["mlp"], h, d_ff=cfg.d_ff,
                                   ranks=(ranks_l or {}).get("mlp"))
            x = x + y
        offset += seg.count
    return x, caches["segments"]


def paged_decode_step(params: Dict, cfg: ModelConfig, caches: Dict,
                      tokens: torch.Tensor, *,
                      ranks: Optional[Dict] = None):
    """One continuous-batching decode step over the block-paged KV cache:
    one token a slot, each slot at its own position.

    tokens: (B, 1). ``caches`` (``PagedKVCache.model_caches()``):

      {'positions': (B,) 0-based index of each slot's current token,
       'block_tables': (B, MB),
       'segments': [{'k': (count, NB, BS, Hkv, D), 'v': ...} per segment]}

    The pools are updated in place. The serving engine runs every
    iteration through ``paged_mixed_step``; this entry, whose attention
    needs no per-token ``slot_ids``, is the pure-decode path. Returns
    (logits (B, 1, V), caches with ``positions + 1``).
    """
    assert paged_compatible(cfg), cfg.name
    positions = caches["positions"]
    block_tables = caches["block_tables"]
    x = embed_tokens(params, tokens, cfg)

    def attn_fn(p, h, window, kp, vp, attn_ranks):
        return attn.paged_attn_apply(
            p, h, cfg, positions=positions, block_tables=block_tables,
            k_pool=kp, v_pool=vp, window=window, ranks=attn_ranks)

    x, segments = _run_paged_segments(params, cfg, x, caches, ranks, attn_fn)
    return lm_logits(params, x, cfg), {"positions": positions + 1,
                                       "block_tables": block_tables,
                                       "segments": segments}


def paged_mixed_step(params: Dict, cfg: ModelConfig, caches: Dict,
                     tokens: torch.Tensor, *,
                     ranks: Optional[Dict] = None):
    """One mixed chunked-prefill/decode iteration over the paged KV cache.

    tokens: (1, T), a flat token batch. ``caches``:

      {'slot_ids':  (T,) block-table row per token (pads -> a null row),
       'positions': (T,) 0-based position of each token in its sequence,
       'block_tables': (B + null rows, MB),
       'segments': [{'k': (count, NB, BS, Hkv, D), 'v': ...} per segment],
       'sample_ids': optional (S,) flat-token indices to score}

    The pools are updated in place. With ``sample_ids`` the final norm and
    LM head run only over the gathered rows. Returns (logits (1, S, V) or
    (1, T, V), caches).
    """
    assert paged_compatible(cfg), cfg.name
    slot_ids = caches["slot_ids"]
    positions = caches["positions"]
    block_tables = caches["block_tables"]
    x = embed_tokens(params, tokens, cfg)

    def attn_fn(p, h, window, kp, vp, attn_ranks):
        return attn.paged_prefill_attn_apply(
            p, h, cfg, slot_ids=slot_ids, positions=positions,
            block_tables=block_tables, k_pool=kp, v_pool=vp, window=window,
            ranks=attn_ranks)

    x, segments = _run_paged_segments(params, cfg, x, caches, ranks, attn_fn)
    new_caches = {"slot_ids": slot_ids, "positions": positions,
                  "block_tables": block_tables, "segments": segments}
    if "sample_ids" in caches:
        x = x[:, caches["sample_ids"]]
        new_caches["sample_ids"] = caches["sample_ids"]
    return lm_logits(params, x, cfg), new_caches


def paged_verify_step(params: Dict, cfg: ModelConfig, caches: Dict,
                      tokens: torch.Tensor, *,
                      ranks: Optional[Dict] = None):
    """Full-row verification forward of nested self-speculative decoding:
    ``k+1`` scored positions per sequence in one call over the paged cache.

    The layout is ``paged_mixed_step``'s flat-token layout: each verifying
    sequence contributes a run of ``k+1`` consecutive tokens (its last
    committed token, then ``k`` draft proposals) routed to its target
    cache slot by ``slot_ids``/``positions``; target prefill chunks of
    other sequences may ride the same batch. Every run's K/V lands in the
    target slot's blocks before attention, so position ``i`` of a run
    attends over exactly the context target-only decoding would have seen,
    and rejected suffixes are rolled back host-side with
    ``PagedKVCache.truncate_slot``. Returns the logits rows named by
    ``caches['sample_ids']`` (all ``(1, T, V)`` without it). It is the
    mixed step's computation (the same ``_run_paged_segments`` loop and
    flat-token attention kernel), under the name the decoder calls.
    """
    return paged_mixed_step(params, cfg, caches, tokens, ranks=ranks)
