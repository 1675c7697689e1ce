"""GQA self-attention (+RoPE, logit softcap), cross-attention and FFN
blocks: the paged serving forwards (decode and mixed), the contiguous
train/prefill forward and the contiguous decode over a (B, T) K/V cache
(exact query-chunked attention), cross-attention over a source or its
cached K/V, spec/apply pairs driven by ``transformer``.

Each projection names its activation tap ("q", "k", "v", "o", "gate",
"up", "down") for the calibration pass.

Under a mesh whose 'model' axis cuts the projections (``models/tp.py``)
``project_qkv`` (which every attention path runs) and ``attn_apply`` run
this rank's heads and ``ffn_apply`` its MLP columns:
q, k, v and gate/up are column-parallel, o and down row-parallel. Where
the rank's q columns are whole heads (the head count divides the axis)
it attends over them alone, with the k/v heads they read: its own where
the kv-head count divides too, else picked out of every k/v head. Where
a split falls inside a head the product's output is gathered to every
head first.

A rank's decode cache holds what the reference's ``cache_shardings``
places on it (``launch/specs.py:cache_specs``): the k/v heads its shape
says (this rank's ``Hkv / n`` or all of them) and, where the placement
cuts the sequence over 'model' (kv-heads that do not divide the axis) or
'data' (a batch of one), its own rows: then the cache dict carries
``rows`` = (the axis, the global position of its first row). Such a
rank writes the step's rows that fall in its range, attends its queries
over its rows at their global key positions, and the ranks of the axis
merge their parts (``attend``): the maximum of the row logits, the sum
of their exponentials, and the sum of the float32 products of the
normalized probabilities (rounded to the cache's type, as the one-rank
softmax's are) with the rows' values. A rank whose rows the causal mask
hides wholly adds zeros. Where 'model' cuts the rows every rank attends
every query head."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.meshctx import get_current_mesh
from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models import tp
from repro_torch.models.common import ParamSpec, linear

Q_CHUNK = 1024  # query chunk for exact chunked attention
NEG_INF = -1e30


def attn_spec(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    return {
        "q": {"w": ParamSpec((d, cfg.num_heads * hd), (cm.EMBED, cm.HEADS))},
        "k": {"w": ParamSpec((d, cfg.num_kv_heads * hd),
                             (cm.EMBED, cm.KV_HEADS))},
        "v": {"w": ParamSpec((d, cfg.num_kv_heads * hd),
                             (cm.EMBED, cm.KV_HEADS))},
        "o": {"w": ParamSpec((cfg.num_heads * hd, d), (cm.HEADS, cm.EMBED))},
        "q_norm": ParamSpec((hd,), (None,), "zeros"),
        "k_norm": ParamSpec((hd,), (None,), "zeros"),
    }


def ffn_spec(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "gate": {"w": ParamSpec((d, f), (cm.EMBED, cm.MLP))},
        "up": {"w": ParamSpec((d, f), (cm.EMBED, cm.MLP))},
        "down": {"w": ParamSpec((f, d), (cm.MLP, cm.EMBED))},
    }


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return cap * torch.tanh(logits / cap)
    return logits


def _query_chunks(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """q (B, S, Hq, D) pre-scaled by ``1/sqrt(D)`` as (B, n, qc, Hkv, G,
    D): ``n`` query chunks of ``qc`` (at most ``Q_CHUNK``, or the whole
    S where it does not split)."""
    b, s, hq, dh = q.shape
    qc = min(Q_CHUNK, s)
    n_chunks = max(s // qc, 1)
    if not (s % qc == 0 or n_chunks == 1):
        raise ValueError(f"sequence {s} is not a multiple of the query "
                         f"chunk {qc}")
    qc = s // n_chunks
    return (q * (1.0 / math.sqrt(dh))).reshape(b, n_chunks, qc, hkv,
                                               hq // hkv, dh)


def masked_logits(qc: torch.Tensor, k: torch.Tensor, *,
                  q_positions: torch.Tensor, k_positions: torch.Tensor,
                  window: int, softcap: float = 0.0,
                  causal: bool = True) -> torch.Tensor:
    """One query chunk's float32 logits (B, Hkv, G, qc, T) against keys
    (B, T, Hkv, D): softcapped, ``-1e30`` where the key lies outside the
    window or (``causal``) after the query."""
    logits = _softcap(torch.einsum("bqhgd,bthd->bhgqt", qc, k).float(),
                      softcap)
    delta = q_positions[:, None] - k_positions[None, :]
    valid = delta < window
    if causal:
        valid &= delta >= 0
    return torch.where(valid[None, None, None], logits,
                       torch.full_like(logits, NEG_INF))


def rows_max(logits: torch.Tensor) -> torch.Tensor:
    """Step 1 of the merge over rows: each query's largest logit here."""
    return logits.amax(-1, keepdim=True)


def rows_sum(logits: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Step 2: the sum of ``exp(logit - m)`` here, ``m`` the maximum over
    every rank's rows."""
    return torch.exp(logits - m).sum(-1, keepdim=True)


def rows_out(logits: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """Step 3: this rank's part of the output (B, qc, Hkv, G, D), float32:
    the probabilities normalized by ``l``, the sum over every rank's rows,
    rounded to ``v``'s type (the one-rank softmax's rounding point), times
    the values here."""
    probs = (torch.exp(logits - m) / l).to(v.dtype)
    return torch.einsum("bhgqt,bthd->bqhgd", probs.float(), v.float())


def chunked_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   q_positions: torch.Tensor, k_positions: torch.Tensor,
                   window: int, softcap: float = 0.0,
                   causal: bool = True, group=None) -> torch.Tensor:
    """Exact attention, one query chunk of at most ``Q_CHUNK`` at a time:
    q pre-scaled by ``1/sqrt(D)``, float32 logits, a ``-1e30`` mask, softmax
    in float32. q: (B, S, Hq, D); k/v: (B, T, Hkv, D); positions: (S,) /
    (T,). ``window``: lookback horizon (T or more for global).

    ``group``: the ranks whose k/v hold the other rows of the sequence
    (``k_positions`` global): the softmax is merged over them in three
    all-reduces (module note)."""
    b, s, hq, dh = q.shape
    qs = _query_chunks(q, k.shape[2])
    q_pos = q_positions.reshape(qs.shape[1], qs.shape[2])
    outs = []
    for c in range(qs.shape[1]):
        # the last chunk's logits and probabilities go before this chunk's
        # are built: one chunk's float32 logits live at a time
        logits = probs = None
        logits = masked_logits(qs[:, c], k, q_positions=q_pos[c],
                               k_positions=k_positions, window=window,
                               softcap=softcap, causal=causal)
        if group is None:
            probs = torch.softmax(logits, dim=-1).to(v.dtype)
            outs.append(torch.einsum("bhgqt,bthd->bqhgd", probs, v))
            continue
        m = C.all_reduce(rows_max(logits), group, "max")
        l = C.all_reduce(rows_sum(logits, m), group)
        outs.append(C.all_reduce(rows_out(logits, m, l, v), group)
                    .to(v.dtype))
    return torch.stack(outs, dim=1).reshape(b, s, hq, dh)


def _qkv_whole(cfg: ModelConfig, d_in: int, heads: int):
    """A q/k/v projection's whole (d_in, d_out)."""
    return (d_in, heads * cfg.resolved_head_dim)


def project_qkv(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                ranks: Dict, positions: torch.Tensor, rope: bool = True,
                kv_source: Optional[torch.Tensor] = None,
                static_kv=None):
    """q/k/v projection + head norms + RoPE, in the reference's order:
    q -> q_norm, then k and v, then k_norm, then RoPE. k/v come from
    ``x``, from ``kv_source`` (cross-attention), or are ``static_kv``
    taken as they are (then no k_norm).

    Under a 'model' axis that cuts the projections (module note) q, k and
    v hold this rank's heads, or every head where the split falls inside
    one. Returns (q, k, v, q0, k0): q0 and k0 the first q and k/v head
    held (0 without a 'model' axis)."""
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    wq = _qkv_whole(cfg, d, nh)
    self_kv = kv_source is None and static_kv is None
    xq, entered = tp.enter(x, [(p["q"], wq)] + (
        [(p["k"], _qkv_whole(cfg, d, nkv)), (p["v"], _qkv_whole(cfg, d, nkv))]
        if self_kv else []))
    q, q0 = tp.heads(linear(p["q"], xq, rank=ranks.get("q"), tap="q",
                            whole=wq, entered=entered), nh, hd)
    group = tp.axis()[0]
    q = cm.rms_norm(q, _norm_scale(p["q_norm"], q, nh, group),
                    eps=cfg.norm_eps)
    if static_kv is not None:
        k, v = static_kv
        k0 = first_head(k, nkv)
    else:
        src = xq if kv_source is None else kv_source
        wkv = _qkv_whole(cfg, src.shape[-1], nkv)
        if kv_source is not None:
            src, entered = tp.enter(src, [(p["k"], wkv), (p["v"], wkv)])
        k, k0 = tp.heads(linear(p["k"], src, rank=ranks.get("k"), tap="k",
                                whole=wkv, entered=entered), nkv, hd)
        v, _ = tp.heads(linear(p["v"], src, rank=ranks.get("v"), tap="v",
                               whole=wkv, entered=entered), nkv, hd)
        k = cm.rms_norm(k, _norm_scale(p["k_norm"], k, nkv, group),
                        eps=cfg.norm_eps)
    if rope:
        q = cm.rope(q, positions, base=cfg.rope_base)
        k = cm.rope(k, positions, base=cfg.rope_base)
    return q, k, v, q0, k0


def attn_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
               positions: torch.Tensor, window: int,
               ranks: Optional[Dict] = None, cache: Optional[Dict] = None,
               kv_source: Optional[torch.Tensor] = None,
               static_kv=None, causal: bool = True,
               use_rope: bool = True
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self- or cross-attention: project, attend, project out. x: (B, S,
    d); positions: (S,).

    Self-attention without ``cache`` (train/prefill) attends over the
    sequence itself; returns (y, None). With ``cache`` = {'k', 'v': (B, T,
    Hkv, D), 'idx': a host int} (the contiguous prefill/decode) the step's
    K/V are written IN PLACE at rows ``idx .. idx + S - 1`` and the
    queries attend over all T rows with key positions ``0 .. T - 1``: the
    causal mask hides the rows not yet written, as in the reference.
    Returns (y, the cache with 'idx': idx + S). A cache with ``rows`` =
    (axis, first) holds rows ``first ..`` of a sequence cut over the
    mesh's ``axis`` (module note); ``idx`` stays global.

    Cross-attention: q from ``x`` (then ``q_norm``), k/v from
    ``kv_source`` (B, T, d) (then ``k_norm`` on k), or ``static_kv``
    = (k, v), each (B, T, Hkv, D), taken as they are (``compute_cross_kv``
    made them); no RoPE. Against ``kv_source`` the keys sit at positions
    ``0 .. T - 1``. Against ``static_kv`` the reference takes the key
    positions from the queries, so its mask broadcasts only when S is 1 or
    T; any other S raises ``ValueError`` here, as the reference does.

    Under a 'model' axis that cuts the projections each rank attends over
    its heads (module note); ``y`` is whole."""
    r = ranks or {}
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    if static_kv is not None and kv_source is None \
            and s not in (1, static_kv[0].shape[1]):
        t = static_kv[0].shape[1]
        raise ValueError(
            f"cached cross K/V of {t} keys takes one query token a call "
            f"(or {t}), not {s}: the reference's key positions come from "
            "the queries there, and its mask does not broadcast")
    q, k, v, q0, k0 = project_qkv(p, x, cfg, ranks=r, positions=positions,
                                  rope=use_rope and kv_source is None,
                                  kv_source=kv_source, static_kv=static_kv)
    new_cache, rows_group = None, None
    if cache is not None:
        idx = cache["idx"]
        ck, cv = cache["k"], cache["v"]
        t = ck.shape[1]
        axis, first = cache.get("rows", (None, 0))
        if axis is not None:
            mesh = get_current_mesh()
            if mesh is None or axis not in mesh.axis_names:
                raise ValueError(f"a cache whose rows are cut over "
                                 f"'{axis}' runs under a mesh with that axis")
            rows_group = mesh.group(axis)
        total = t if axis is None else t * mesh.size(axis)
        if idx + s > total:
            raise ValueError(f"decode cache of {total} positions cannot "
                             f"take {s} more at {idx}")
        k, k0 = tp.own_heads(k, nkv, k0, ck.shape[2])
        v, _ = tp.own_heads(v, nkv, k0, ck.shape[2])
        # the step's rows that fall in this rank's range
        lo, hi = max(idx, first), min(idx + s, first + t)
        if lo < hi:
            ck[:, lo - first:hi - first] = k[:, lo - idx:hi - idx].to(
                ck.dtype)
            cv[:, lo - first:hi - first] = v[:, lo - idx:hi - idx].to(
                cv.dtype)
        new_cache = dict(cache, idx=idx + s)
        k_positions = first + torch.arange(t, device=x.device)
        # the reference's einsum promotes a low-precision cache to the
        # queries' type; torch's needs the cast
        k, v = ck.to(q.dtype), cv
        if axis == "model" and q.shape[2] < nh:
            # every 'model' rank attends every query head over its rows
            q, q0 = C.gather(q, 2, tp.axis()[0]), 0
    elif kv_source is not None:
        k_positions = torch.arange(kv_source.shape[1], device=x.device)
    elif static_kv is not None:
        # the reference takes the queries' positions here (S is 1 or T,
        # checked above); with the cross block's non-causal global window
        # either masks nothing, and so do T zeros
        k_positions = torch.zeros(k.shape[1], dtype=positions.dtype,
                                  device=x.device)
    else:
        k_positions = positions
    if k.shape[2] < nkv and q.shape[2] == nh:
        # this rank's k/v heads: the queries are cut to the heads that
        # read them
        q, q0 = tp.own_heads(q, nh, q0, q.shape[2] * k.shape[2] // nkv)
    if q.shape[2] < nh and k.shape[2] == nkv:
        # whole k/v read by this rank's queries only: their gradient here
        # is this rank's part of it, summed over the ranks
        group = tp.axis()[0]
        k, v = C.reduce_grad(k, group), C.reduce_grad(v, group)
    k, v = tp.kv_for(q.shape[2], q0, k, v, k0, nh // nkv)
    out = chunked_attend(q, k.to(q.dtype), v, q_positions=positions,
                         k_positions=k_positions, window=window,
                         softcap=cfg.attn_logit_softcap,
                         causal=causal and kv_source is None,
                         group=rows_group)
    out = out.reshape(b, s, q.shape[2] * hd)
    return linear(p["o"], out, rank=r.get("o"), tap="o",
                  whole=(nh * hd, d)), new_cache


def _norm_scale(scale: torch.Tensor, heads: torch.Tensor, count: int,
                group) -> torch.Tensor:
    """A head norm's (replicated) scale, its gradient summed over the
    'model' ranks where each normalizes its part of the ``count`` heads."""
    return C.reduce_grad(scale, group) if heads.shape[2] < count else scale


def first_head(t: torch.Tensor, count: int) -> int:
    """The first k/v head of a cached (B, T, h, D): this rank's where it
    holds ``count / n`` of them, else 0."""
    return 0 if t.shape[2] == count else tp.axis()[2] * t.shape[2]


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                  dtype=torch.bfloat16, num_instances: int = 1,
                  device=None) -> Dict:
    """Zero K/V caches of ``num_instances`` stacked attention blocks:
    {'k', 'v': (L, B, max_len, Hkv, D), 'idx': 0}. ``idx``, the next row
    to write, is a host int shared by the L blocks (the reference keeps an
    int32 array of L equal values): the drain loop knows it, so reading it
    never waits for the card. A rank's part of it is
    ``launch/specs.py:cache_specs``'s."""
    shape = (num_instances, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "idx": 0}


def paged_attn_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                     positions: torch.Tensor, block_tables: torch.Tensor,
                     k_pool: torch.Tensor, v_pool: torch.Tensor,
                     window: Optional[int] = None,
                     ranks: Optional[Dict] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode self-attention over a block-paged KV cache.

    x: (B, 1, d), one token per sequence, each at its own position.
    ``positions``: (B,) 0-based index of the current token; its K/V is
    scattered IN PLACE (the JAX reference donates the pools) into
    (block_tables[b, pos // BS], pos % BS) before attending over the
    ``pos + 1`` valid keys. Returns (y, k_pool, v_pool)."""
    r = ranks or {}
    hd = cfg.resolved_head_dim
    bsz = x.shape[0]
    bs = k_pool.shape[1]

    q, k, v, _, _ = project_qkv(p, x, cfg, ranks=r,
                                positions=positions[:, None])

    blk = block_tables[torch.arange(bsz, device=x.device),
                       positions // bs].long()
    off = positions % bs
    k_pool[blk, off] = k[:, 0].to(k_pool.dtype)
    v_pool[blk, off] = v[:, 0].to(v_pool.dtype)

    out = ops.paged_attention_forward(
        q[:, 0], k_pool, v_pool, block_tables, positions + 1,
        softcap=cfg.attn_logit_softcap, window=window)
    out = out.reshape(bsz, 1, cfg.num_heads * hd)
    y = linear(p["o"], out, rank=r.get("o"), tap="o")
    return y, k_pool, v_pool


def paged_prefill_attn_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                             slot_ids: torch.Tensor, positions: torch.Tensor,
                             block_tables: torch.Tensor,
                             k_pool: torch.Tensor, v_pool: torch.Tensor,
                             window: Optional[int] = None,
                             ranks: Optional[Dict] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Mixed chunked-prefill/decode self-attention over a block-paged cache.

    x: (1, T, d), a flat token batch; token t belongs to table row
    ``slot_ids[t]`` at ``positions[t]``. Every token's K/V is scattered into
    (block_tables[slot, pos // BS], pos % BS) before attention, so
    intra-chunk causality reduces to the per-token context ``pos + 1``.
    The scatter updates ``k_pool``/``v_pool`` IN PLACE (the JAX reference
    donates them); pad tokens point at a row of null blocks and all write
    identical values there, so duplicate targets are harmless. Returns
    (y, k_pool, v_pool).
    """
    r = ranks or {}
    hd = cfg.resolved_head_dim
    t = x.shape[1]
    bs = k_pool.shape[1]

    q, k, v, _, _ = project_qkv(p, x, cfg, ranks=r,
                                positions=positions[None, :])

    blk = block_tables[slot_ids, positions // bs].long()
    off = positions % bs
    k_pool[blk, off] = k[0].to(k_pool.dtype)
    v_pool[blk, off] = v[0].to(v_pool.dtype)

    out = ops.paged_prefill_attention_forward(
        q[0], k_pool, v_pool, block_tables, slot_ids, positions + 1,
        softcap=cfg.attn_logit_softcap, window=window)
    out = out.reshape(1, t, cfg.num_heads * hd)
    y = linear(p["o"], out, rank=r.get("o"), tap="o")
    return y, k_pool, v_pool


def ffn_apply(p: Dict, x: torch.Tensor, *, d_ff: int,
              ranks: Optional[Dict] = None) -> torch.Tensor:
    """The gated MLP of hidden width ``d_ff``. The leaves may be a 'model'
    rank's columns of gate/up and rows of down (``models/tp.py``); the
    output is whole."""
    r = ranks or {}
    d = x.shape[-1]
    x, entered = tp.enter(x, [(p["gate"], (d, d_ff)), (p["up"], (d, d_ff))])
    gate = linear(p["gate"], x, rank=r.get("gate"), tap="gate",
                  whole=(d, d_ff), entered=entered)
    up = linear(p["up"], x, rank=r.get("up"), tap="up", whole=(d, d_ff),
                entered=entered)
    return linear(p["down"], cm.swiglu(gate, up), rank=r.get("down"),
                  tap="down", whole=(d_ff, d))


def compute_cross_kv(p: Dict, cfg: ModelConfig, kv_source: torch.Tensor, *,
                     ranks: Optional[Dict] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention (k, v), each (B, T, Hkv, D), from the projected
    source (B, T, d), once per request (the reference's "decode fast
    path"): the k/v projections (no tap) and ``k_norm`` on k. Under a
    'model' axis that cuts them, this rank's heads where its columns are
    whole heads (``tp.heads``), else every head."""
    r = ranks or {}
    nkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    wkv = _qkv_whole(cfg, kv_source.shape[-1], nkv)
    src, entered = tp.enter(kv_source, [(p["k"], wkv), (p["v"], wkv)])
    k, _ = tp.heads(linear(p["k"], src, rank=r.get("k"), whole=wkv,
                           entered=entered), nkv, hd)
    v, _ = tp.heads(linear(p["v"], src, rank=r.get("v"), whole=wkv,
                           entered=entered), nkv, hd)
    return cm.rms_norm(k, _norm_scale(p["k_norm"], k, nkv, tp.axis()[0]),
                       eps=cfg.norm_eps), v
