"""Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style).

Queries go through a LoRA bottleneck (q_down -> q_up); keys and values
are compressed into a small latent ``c_kv`` (kv_lora_rank) that is
up-projected per head, with a decoupled RoPE sub-head (rope_head_dim)
shared across heads for the keys. The decode cache stores only the
latent, ``(c_kv, k_rope)``.

Without a cache (train, calibration, the ``forward`` of a served row)
attention is exact and query-chunked over the up-projected keys and
values. With one (the drain engine's contiguous prefill and decode) the
step's latent is written in place and attention runs against the latent
cache with ``kv_up`` absorbed into the query and output sides: the same
arithmetic in another order. The projections go through
``common.linear`` (the GAR kernel on a deployed row); the absorbed
``kv_up`` is rebuilt as a dense weight from its factors
(``effective_weight``), a small product since its input is the latent.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import tp
from repro_torch.models.attention import NEG_INF, Q_CHUNK
from repro_torch.models.common import ParamSpec, linear


def mla_spec(cfg: ModelConfig) -> Dict:
    a = cfg.mla
    d = cfg.d_model
    h = cfg.num_heads
    qd = a.nope_head_dim + a.rope_head_dim
    return {
        "q_down": {"w": ParamSpec((d, a.q_lora_rank), (cm.EMBED, None))},
        "q_norm": ParamSpec((a.q_lora_rank,), (None,), "zeros"),
        "q_up": {"w": ParamSpec((a.q_lora_rank, h * qd), (None, cm.HEADS))},
        "kv_down": {"w": ParamSpec((d, a.kv_lora_rank + a.rope_head_dim),
                                   (cm.EMBED, None))},
        "kv_norm": ParamSpec((a.kv_lora_rank,), (None,), "zeros"),
        "kv_up": {"w": ParamSpec(
            (a.kv_lora_rank, h * (a.nope_head_dim + a.v_head_dim)),
            (None, cm.HEADS))},
        "o": {"w": ParamSpec((h * a.v_head_dim, d), (cm.HEADS, cm.EMBED))},
    }


def effective_weight(p: Dict, rank: Optional[int]) -> torch.Tensor:
    """Dense (d_in, d_out) weight of a dense, GAR or rank-masked
    factorized linear."""
    if "w" in p:
        return p["w"]
    if "u_hat" in p:
        vt = p["v_tilde"]
        eye = torch.eye(vt.shape[1], dtype=vt.dtype, device=vt.device)
        u_tilde = torch.cat([eye, p["u_hat"]], dim=0)
        return (vt @ u_tilde.T)[:, p["perm_inv"]]
    v, u = p["v"], p["u"]
    if rank is not None:
        keep = torch.arange(v.shape[-1], device=v.device) < rank
        v = v * keep.to(v.dtype)
    return v @ u.T


def _masked_softmax(logits: torch.Tensor, q_pos: torch.Tensor,
                    k_pos: torch.Tensor, window: int) -> torch.Tensor:
    """Causal window mask at ``-1e30`` over (.., S, T) float32 logits,
    then softmax."""
    delta = q_pos[:, None] - k_pos[None, :]
    valid = (delta >= 0) & (delta < window)
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    return torch.softmax(logits, dim=-1)


def mla_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, window: int,
              ranks: Optional[Dict] = None, cache: Optional[Dict] = None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """MLA self-attention. x: (B, S, d); positions: (S,).

    ``cache`` = {'c_kv': (B, T, kv_rank), 'k_rope': (B, T, rope_dim),
    'idx': a host int}: the step's latent is written IN PLACE at rows
    ``idx .. idx + S - 1`` and the queries attend over all T rows (key
    positions ``0 .. T - 1``, the causal mask hiding the rows not yet
    written); returns (y, {'c_kv', 'k_rope', 'idx': idx + S}). Without a
    cache returns (y, None). A low-precision cache is cast to the
    queries' type where it meets them, as ``jnp.einsum`` promotes."""
    tp.require_whole(p, lambda: mla_spec(cfg), "mla")
    a = cfg.mla
    r = ranks or {}
    b, s, _ = x.shape
    h = cfg.num_heads
    nd, rd, vd = a.nope_head_dim, a.rope_head_dim, a.v_head_dim
    scale = 1.0 / math.sqrt(nd + rd)

    q = linear(p["q_down"], x, rank=r.get("q_down"), tap="q_down")
    q = cm.rms_norm(q, p["q_norm"], eps=cfg.norm_eps)
    q = linear(p["q_up"], q, rank=r.get("q_up"), tap="q_up")
    q = q.reshape(b, s, h, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = cm.rope(q_rope, positions, base=cfg.rope_base)

    ckv_full = linear(p["kv_down"], x, rank=r.get("kv_down"), tap="kv_down")
    c_kv, k_rope = (ckv_full[..., :a.kv_lora_rank],
                    ckv_full[..., a.kv_lora_rank:])
    c_kv = cm.rms_norm(c_kv, p["kv_norm"], eps=cfg.norm_eps)
    k_rope = cm.rope(k_rope[:, :, None, :], positions,
                     base=cfg.rope_base)[:, :, 0]

    if cache is not None:
        idx = cache["idx"]
        c_all, kr_all = cache["c_kv"], cache["k_rope"]
        t = c_all.shape[1]
        if idx + s > t:
            raise ValueError(f"decode cache of {t} positions cannot take "
                             f"{s} more at {idx}")
        c_all[:, idx:idx + s] = c_kv.to(c_all.dtype)
        kr_all[:, idx:idx + s] = k_rope.to(kr_all.dtype)
        new_cache = {"c_kv": c_all, "k_rope": kr_all, "idx": idx + s}
        # absorbed decode: kv_up folded into the query and output sides,
        # attention against the latent cache
        w_up = effective_weight(p["kv_up"], r.get("kv_up"))
        w_up = w_up.reshape(a.kv_lora_rank, h, nd + vd)
        w_k, w_v = w_up[..., :nd], w_up[..., nd:]
        q_lat = torch.einsum("bshn,chn->bshc", q_nope, w_k.to(q_nope.dtype))
        c_q = c_all.to(q_lat.dtype)
        logits = (torch.einsum("bshc,btc->bhst", q_lat, c_q)
                  + torch.einsum("bshd,btd->bhst", q_rope,
                                 kr_all.to(q_rope.dtype))).float() * scale
        probs = _masked_softmax(logits, positions,
                                torch.arange(t, device=x.device),
                                window).to(x.dtype)
        out_lat = torch.einsum("bhst,btc->bshc", probs, c_all.to(x.dtype))
        out = torch.einsum("bshc,chv->bshv", out_lat, w_v.to(x.dtype))
        out = out.reshape(b, s, h * vd)
        return linear(p["o"], out, rank=r.get("o"), tap="o"), new_cache

    kv = linear(p["kv_up"], c_kv, rank=r.get("kv_up"), tap="kv_up")
    kv = kv.reshape(b, s, h, nd + vd)
    k_nope, v = kv[..., :nd], kv[..., nd:]

    # exact query-chunked attention (the discipline of
    # ``attention.chunked_attend``)
    qc = min(Q_CHUNK, s)
    n_chunks = max(s // qc, 1)
    if not (s % qc == 0 or n_chunks == 1):
        raise ValueError(f"sequence {s} is not a multiple of the query "
                         f"chunk {qc}")
    qc = s // n_chunks
    outs = []
    for c in range(n_chunks):
        sl = slice(c * qc, (c + 1) * qc)
        logits = (torch.einsum("bqhd,bthd->bhqt", q_nope[:, sl], k_nope)
                  + torch.einsum("bqhd,btd->bhqt", q_rope[:, sl], k_rope)
                  ).float() * scale
        probs = _masked_softmax(logits, positions[sl], positions,
                                window).to(v.dtype)
        outs.append(torch.einsum("bhqt,bthd->bqhd", probs, v))
    out = torch.cat(outs, dim=1).reshape(b, s, h * vd)
    return linear(p["o"], out, rank=r.get("o"), tap="o"), None


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                   dtype=torch.bfloat16, num_instances: int = 1,
                   device=None) -> Dict:
    """Zero latent caches of ``num_instances`` stacked MLA blocks:
    {'c_kv': (L, B, max_len, kv_rank), 'k_rope': (L, B, max_len,
    rope_dim), 'idx': 0}, ``idx`` a host int as in
    ``attention.init_kv_cache``."""
    a = cfg.mla
    return {
        "c_kv": torch.zeros((num_instances, batch, max_len, a.kv_lora_rank),
                            dtype=dtype, device=device),
        "k_rope": torch.zeros((num_instances, batch, max_len,
                               a.rope_head_dim), dtype=dtype, device=device),
        "idx": 0,
    }
