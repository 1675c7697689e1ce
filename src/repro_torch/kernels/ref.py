"""Plain PyTorch versions of the port's kernels.

Each function repeats the arithmetic of its counterpart in the JAX
package's ``kernels/ref.py``: q pre-scaled by ``1/sqrt(d)`` before the dot,
float32 logits, a ``-1e30`` mask, the two-level blocked CDF (``block=1024``)
clamped to ``V-1``, first-occurrence argmax, and the sequential WKV6 and
SSD recurrences. The CPU tests hold them against that module;
``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def gar_matmul_ref(x: torch.Tensor, v_tilde: torch.Tensor,
                   u_hat: torch.Tensor):
    """(z, tail) for z = x @ v_tilde, tail = z @ u_hat^T."""
    z = x @ v_tilde
    return z, z @ u_hat.T


def gar_tail_ref(z: torch.Tensor, u_hat: torch.Tensor) -> torch.Tensor:
    """The GAR kernel's second stage on a given z: z @ u_hat^T."""
    return z @ u_hat.T


def lowrank_matmul_ref(x: torch.Tensor, v: torch.Tensor, u: torch.Tensor,
                       rank: Optional[int] = None) -> torch.Tensor:
    """y = ((x @ v) * [col < rank]) @ u^T; ``rank`` None keeps every
    column."""
    z = x @ v
    if rank is not None:
        mask = (torch.arange(z.shape[-1], device=z.device) < rank).to(z.dtype)
        z = z * mask
    return z @ u.T


def wkv6_ref(r, k, v, w, u):
    """Sequential WKV6 recurrence from a zero state. r/k/v/w: (BH, S, N);
    u: (BH, N). ``y_t = r_t^T (S + u k_t v_t^T)``, ``S <- diag(w_t) S +
    k_t v_t^T``, S (N, N) float32."""
    bh, s, n = r.shape
    r, k, v, w, u = (t.float() for t in (r, k, v, w, u))
    state = torch.zeros((bh, n, n), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(s):
        kv = k[:, t, :, None] * v[:, t, None, :]
        ys.append(torch.einsum("bn,bnm->bm", r[:, t],
                               state + u[:, :, None] * kv))
        state = state * w[:, t, :, None] + kv
    return torch.stack(ys, dim=1).reshape(bh, s, n)


def ssd_ref(x, dt, a, b, c):
    """Sequential Mamba2 SSD recurrence from a zero state. x: (BH, S, P);
    dt: (BH, S); a: (BH,); b/c: (BH, S, N). ``S <- exp(dt_t a) S + b_t
    (x_t dt_t)^T``, ``y_t = c_t S``, S (N, P) float32."""
    bh, s, p = x.shape
    n = b.shape[-1]
    x, dt, a, b, c = (t.float() for t in (x, dt, a, b, c))
    state = torch.zeros((bh, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)
        state = state * decay[:, None, None] + torch.einsum(
            "bn,bp->bnp", b[:, t], x[:, t] * dt[:, t, None])
        ys.append(torch.einsum("bn,bnp->bp", c[:, t], state))
    return torch.stack(ys, dim=1).reshape(bh, s, p)


def paged_attention_ref(q, k_pool, v_pool, block_tables, context_lens, *,
                        softcap: float = 0.0, window: Optional[int] = None):
    """Decode attention over a block-paged KV cache (gather + plain softmax).

    q: (B, Hq, D); k_pool/v_pool: (NB, BS, Hkv, D); block_tables: (B, MB)
    integer block ids (0 = null block); context_lens: (B,) valid keys.
    """
    b, hq, d = q.shape
    _, bs, hkv, _ = k_pool.shape
    mb = block_tables.shape[1]
    g = hq // hkv
    bt = block_tables.long()
    k = k_pool[bt].reshape(b, mb * bs, hkv, d)
    v = v_pool[bt].reshape(b, mb * bs, hkv, d)
    qg = (q * (1.0 / math.sqrt(d))).reshape(b, hkv, g, d)
    logits = torch.einsum("bhgd,bthd->bhgt", qg, k).float()
    if softcap and softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    k_pos = torch.arange(mb * bs, device=q.device)[None, :]
    ctx = context_lens.long()[:, None]
    valid = k_pos < ctx
    if window is not None:
        valid &= k_pos >= (ctx - window)
    logits = torch.where(valid[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgt,bthd->bhgd", probs, v)
    return out.reshape(b, hq, d).to(q.dtype)


def paged_prefill_attention_ref(q, k_pool, v_pool, block_tables, slot_ids,
                                context_lens, *, softcap: float = 0.0,
                                window: Optional[int] = None):
    """Flat-token paged attention: token ``t`` reads table row
    ``slot_ids[t]`` and attends over its first ``context_lens[t]`` keys.
    q: (T, Hq, D); block_tables: (B, MB); slot_ids/context_lens: (T,)."""
    per_token_tables = block_tables[slot_ids.long()]
    return paged_attention_ref(q, k_pool, v_pool, per_token_tables,
                               context_lens, softcap=softcap, window=window)


def topk_threshold_ref(z: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Per-row k-th largest value of already temperature-scaled logits
    (rows keep every entry ``>= threshold``), -inf where ``top_k == 0``."""
    v = z.shape[-1]
    srt = torch.sort(z, dim=-1, descending=True).values
    k = torch.clamp(top_k.long(), 1, v) - 1
    thr = torch.gather(srt, 1, k[:, None])[:, 0]
    return torch.where(top_k > 0, thr, torch.full_like(thr, -math.inf))


def warp_probs_ref(logits, temperature, threshold):
    """Temperature scaling, threshold mask, normalization; one-hot argmax
    for greedy rows (``temperature <= 0``)."""
    v = logits.shape[-1]
    t = torch.clamp(temperature, min=1e-30)[:, None]
    z = logits.float() / t
    z = torch.where(z >= threshold[:, None], z, torch.full_like(z, -math.inf))
    z = z - torch.max(z, dim=-1, keepdim=True).values
    p = torch.exp(z)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    one_hot = (torch.argmax(logits, dim=-1)[:, None]
               == torch.arange(v, device=logits.device)[None, :]).float()
    return torch.where(temperature[:, None] > 0, p, one_hot)


def sample_cdf_ref(weights: torch.Tensor, u: torch.Tensor,
                   block: int = 1024) -> torch.Tensor:
    """Inverse-CDF draw per row from non-negative weights: the count of
    CDF entries ``<= u * total`` (``searchsorted(side="right")``), clamped
    to ``V-1``. Two-level: block sums locate the crossing block, one
    within-block cumsum resolves the index. Returns (S,) int32."""
    s, v = weights.shape
    bv = min(block, v)
    pad = (-v) % bv
    w = weights.float()
    if pad:
        w = torch.nn.functional.pad(w, (0, pad))
    nb = w.shape[1] // bv
    blocks = w.reshape(s, nb, bv)
    bsum = blocks.sum(-1)
    cum = torch.cumsum(bsum, dim=-1)
    target = u.float() * cum[:, -1]
    b = (cum <= target[:, None]).sum(-1)
    b = torch.clamp(b, max=nb - 1)
    prev = torch.gather(cum, 1, torch.clamp(b - 1, min=0)[:, None])[:, 0]
    carry = torch.where(b > 0, prev, torch.zeros_like(prev))
    inner = blocks[torch.arange(s, device=w.device), b]
    cs = carry[:, None] + torch.cumsum(inner, dim=-1)
    idx = b * bv + (cs <= target[:, None]).sum(-1)
    return torch.clamp(idx, max=v - 1).to(torch.int32)


def topk_mask_sample_ref(logits, temperature, threshold, u,
                         return_probs: bool = True):
    """Fused warp + draw: temperature/top-k warp each row and draw one
    token by inverse CDF with uniform ``u``; greedy rows take the raw
    argmax. ``threshold`` None means no row truncates. Returns ``(tokens
    (S,) int32, probs (S, V) or None)``."""
    t = torch.clamp(temperature, min=1e-30)[:, None]
    z = logits.float() / t
    if threshold is not None:
        z = torch.where(z >= threshold[:, None], z,
                        torch.full_like(z, -math.inf))
    e = torch.exp(z - torch.max(z, dim=-1, keepdim=True).values)
    sampled = sample_cdf_ref(e, u)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    tokens = torch.where(temperature > 0, sampled, greedy)
    if not return_probs:
        return tokens, None
    p = e / torch.sum(e, dim=-1, keepdim=True)
    one_hot = (greedy[:, None].long()
               == torch.arange(logits.shape[-1],
                               device=logits.device)[None, :]).float()
    return tokens, torch.where(temperature[:, None] > 0, p, one_hot)
