"""GQA self-attention (+RoPE, logit softcap), cross-attention and FFN
blocks: the paged serving forwards (decode and mixed), the contiguous
train/prefill forward and the contiguous decode over a (B, T) K/V cache
(exact query-chunked attention), cross-attention over a source or its
cached K/V, spec/apply pairs driven by ``transformer``.

Each projection names its activation tap ("q", "k", "v", "o", "gate",
"up", "down") for the calibration pass."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common as cm
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


def chunked_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   q_positions: torch.Tensor, k_positions: torch.Tensor,
                   window: int, softcap: float = 0.0,
                   causal: bool = True) -> torch.Tensor:
    """Exact attention, one query chunk of at most ``Q_CHUNK`` at a time:
    q pre-scaled by ``1/sqrt(D)``, float32 logits, a ``-1e30`` mask, softmax
    in float32. q: (B, S, Hq, D); k/v: (B, T, Hkv, D); positions: (S,) /
    (T,). ``window``: lookback horizon (T or more for global)."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qc = min(Q_CHUNK, s)
    n_chunks = max(s // qc, 1)
    if not (s % qc == 0 or n_chunks == 1):
        raise ValueError(f"sequence {s} is not a multiple of the query "
                         f"chunk {qc}")
    qc = s // n_chunks
    q = (q * (1.0 / math.sqrt(dh))).reshape(b, n_chunks, qc, hkv, g, dh)
    q_pos = q_positions.reshape(n_chunks, qc)
    outs = []
    for c in range(n_chunks):
        logits = torch.einsum("bqhgd,bthd->bhgqt", q[:, c], k).float()
        logits = _softcap(logits, softcap)
        delta = q_pos[c][:, None] - k_positions[None, :]
        valid = delta < window
        if causal:
            valid &= delta >= 0
        logits = torch.where(valid[None, None, None], logits,
                             torch.full_like(logits, NEG_INF))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhgqt,bthd->bqhgd", probs, v))
    return torch.stack(outs, dim=1).reshape(b, s, hq, dh)


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1)


def project_qkv(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                ranks: Dict, positions: torch.Tensor,
                rope: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q/k/v projection + head norms + RoPE, in the reference's order:
    q -> q_norm, then k and v, then k_norm, then RoPE."""
    q = _split_heads(linear(p["q"], x, rank=ranks.get("q"), tap="q"),
                     cfg.num_heads)
    q = cm.rms_norm(q, p["q_norm"], eps=cfg.norm_eps)
    k = _split_heads(linear(p["k"], x, rank=ranks.get("k"), tap="k"),
                     cfg.num_kv_heads)
    v = _split_heads(linear(p["v"], x, rank=ranks.get("v"), tap="v"),
                     cfg.num_kv_heads)
    k = cm.rms_norm(k, p["k_norm"], eps=cfg.norm_eps)
    if rope:
        q = cm.rope(q, positions, base=cfg.rope_base)
        k = cm.rope(k, positions, base=cfg.rope_base)
    return q, k, v


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
    Returns (y, {'k', 'v', 'idx': idx + S}).

    Cross-attention: q from ``x`` (then ``q_norm``), k/v from
    ``kv_source`` (B, T, d) (then ``k_norm`` on k), or ``static_kv``
    = (k, v), each (B, T, Hkv, D), taken as they are (``compute_cross_kv``
    made them); no RoPE. Against ``kv_source`` the keys sit at positions
    ``0 .. T - 1``. Against ``static_kv`` the reference takes the key
    positions from the queries, so its mask broadcasts only when S is 1 or
    T; any other S raises ``ValueError`` here, as the reference does."""
    r = ranks or {}
    b, s = x.shape[:2]
    if kv_source is None and static_kv is None:
        q, k, v = project_qkv(p, x, cfg, ranks=r, positions=positions,
                              rope=use_rope)
    else:
        q = _split_heads(linear(p["q"], x, rank=r.get("q"), tap="q"),
                         cfg.num_heads)
        q = cm.rms_norm(q, p["q_norm"], eps=cfg.norm_eps)
        if static_kv is not None:
            k, v = static_kv
            if kv_source is None and s not in (1, k.shape[1]):
                raise ValueError(
                    f"cached cross K/V of {k.shape[1]} keys takes one query "
                    f"token a call (or {k.shape[1]}), not {s}: the "
                    "reference's key positions come from the queries there, "
                    "and its mask does not broadcast")
        else:
            k = _split_heads(linear(p["k"], kv_source, rank=r.get("k"),
                                    tap="k"), cfg.num_kv_heads)
            v = _split_heads(linear(p["v"], kv_source, rank=r.get("v"),
                                    tap="v"), cfg.num_kv_heads)
            k = cm.rms_norm(k, p["k_norm"], eps=cfg.norm_eps)
        if use_rope and kv_source is None:
            q = cm.rope(q, positions, base=cfg.rope_base)
            k = cm.rope(k, positions, base=cfg.rope_base)
    new_cache = None
    if cache is not None:
        idx = cache["idx"]
        ck, cv = cache["k"], cache["v"]
        t = ck.shape[1]
        if idx + s > t:
            raise ValueError(f"decode cache of {t} positions cannot take "
                             f"{s} more at {idx}")
        ck[:, idx:idx + s] = k.to(ck.dtype)
        cv[:, idx:idx + s] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv, "idx": idx + s}
        k_positions = torch.arange(t, device=x.device)
        # the reference's einsum promotes a low-precision cache to the
        # queries' type; torch's needs the cast
        out = chunked_attend(q, ck.to(q.dtype), cv, q_positions=positions,
                             k_positions=k_positions, window=window,
                             softcap=cfg.attn_logit_softcap, causal=causal)
    else:
        if kv_source is not None:
            k_positions = torch.arange(kv_source.shape[1], device=x.device)
        elif static_kv is not None:
            # the reference takes the queries' positions here (S is 1 or
            # T, checked above); with the cross block's non-causal global
            # window either masks nothing, and so do T zeros
            k_positions = torch.zeros(k.shape[1], dtype=positions.dtype,
                                      device=x.device)
        else:
            k_positions = positions
        out = chunked_attend(q, k.to(q.dtype), v, q_positions=positions,
                             k_positions=k_positions, window=window,
                             softcap=cfg.attn_logit_softcap,
                             causal=causal and kv_source is None)
    out = out.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim)
    return linear(p["o"], out, rank=r.get("o"), tap="o"), new_cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                  dtype=torch.bfloat16, num_instances: int = 1,
                  device=None) -> Dict:
    """Zero K/V caches of ``num_instances`` stacked attention blocks:
    {'k', 'v': (L, B, max_len, Hkv, D), 'idx': 0}. ``idx``, the next row to
    write, is a host int shared by the L blocks (the reference keeps an
    int32 array of L equal values): the drain loop knows it, so reading it
    never waits for the card."""
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

    q, k, v = project_qkv(p, x, cfg, ranks=r, positions=positions[:, None])

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

    q, k, v = project_qkv(p, x, cfg, ranks=r, positions=positions[None, :])

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


def ffn_apply(p: Dict, x: torch.Tensor, *,
              ranks: Optional[Dict] = None) -> torch.Tensor:
    r = ranks or {}
    gate = linear(p["gate"], x, rank=r.get("gate"), tap="gate")
    up = linear(p["up"], x, rank=r.get("up"), tap="up")
    return linear(p["down"], cm.swiglu(gate, up), rank=r.get("down"),
                  tap="down")


def compute_cross_kv(p: Dict, cfg: ModelConfig, kv_source: torch.Tensor, *,
                     ranks: Optional[Dict] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention (k, v), each (B, T, Hkv, D), from the projected
    source (B, T, d), once per request (the reference's "decode fast
    path"): the k/v projections (no tap) and ``k_norm`` on k."""
    r = ranks or {}
    k = _split_heads(linear(p["k"], kv_source, rank=r.get("k")),
                     cfg.num_kv_heads)
    v = _split_heads(linear(p["v"], kv_source, rank=r.get("v")),
                     cfg.num_kv_heads)
    return cm.rms_norm(k, p["k_norm"], eps=cfg.norm_eps), v
