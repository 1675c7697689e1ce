"""Device-resident sampling: keyed uniforms and fused token emission.

The host sampler (``serving.sampling``) draws every stochastic uniform as a
pure function of ``(seed, req_id, purpose, position)``. The JAX package
folds those four integers into a threefry2x32 key
(``PRNGKey(seed)`` -> ``fold_in`` x3 -> ``uniform``); ``keyed_uniform``
here is a bit-exact torch port of that chain (the partitionable threefry
layout), so the two engines draw the same tokens from the same keys.

``paged_sample_step`` is one mixed serving iteration that returns int32
token ids only: the LM head runs over the gathered sample positions and
the temperature/top-k draw runs in ``ops.topk_mask_sample_forward`` (the
CUDA kernel on the card, its plain version on the CPU).

``paged_verify_accept_step`` is one speculative round's target forward
with Leviathan accept/resample (``device_accept``) after it: the round
returns ``(accepted_len, commit tokens)`` per sequence plus the finishing
prefill chunks' first tokens. The accept arithmetic is the reference's
plain ``ref.py`` arithmetic on tensors, vectorised over the round's plans.
Its keyed uniforms sit at positions ``committed + m`` where the accepted
count ``m`` exists only on the device, so ``accept_uniforms`` hashes every
candidate position on the host before the round is queued and the step
gathers them by ``m``: the round makes no host synchronisation until its
commit is read, and its draws stay bit-exact to the JAX package's.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as tfm
from repro_torch.serving.sampling import DRAW_ACCEPT, DRAW_RESIDUAL, \
    DRAW_TARGET
from repro_torch.threefry import M32, threefry2x32

def _uniform_bits(seed, req_id, purpose, position):
    """The float32 bit pattern in [1, 2) of each keyed uniform, from uint32
    keys held in int64 arrays: ``PRNGKey(seed)`` is ``(0, seed)`` for an
    int32 seed, each ``fold_in`` hashes ``(0, part)`` under the key, and
    ``uniform`` takes the xor of the two words hashed at index 0."""
    k0, k1 = seed * 0, seed
    zero = seed * 0
    for part in (req_id, purpose, position):
        k0, k1 = threefry2x32(k0, k1, zero, part)
    b0, b1 = threefry2x32(k0, k1, zero, zero)
    return ((b0 ^ b1) >> 9) | 0x3F800000


def keyed_uniform(seed: torch.Tensor, req_id: torch.Tensor,
                  purpose: torch.Tensor,
                  position: torch.Tensor) -> torch.Tensor:
    """One float32 uniform in [0, 1) per element as a pure function of
    ``(seed, req_id, purpose, position)``, bit-exact to the JAX package's
    ``keyed_uniform``. Inputs are integer tensors of one shape holding int32
    values (a seed is the int32 view of its low 32 bits). The keys are
    hashed on the host in numpy (some 700 array operations, a fraction of a
    millisecond for a batch of rows; on the card each would be a kernel
    launch); the uniforms are returned on the keys' device."""
    u = _uniforms_np(*[a.cpu().numpy()
                       for a in (seed, req_id, purpose, position)])
    return torch.from_numpy(u).to(seed.device)


def _uniforms_np(seed, req_id, purpose, position) -> np.ndarray:
    """``keyed_uniform`` on numpy integer arrays of one shape (int32
    values), hashed on the host. Returns float32."""
    keys = [np.asarray(a).astype(np.int64) & M32
            for a in (seed, req_id, purpose, position)]
    bits = _uniform_bits(*keys).astype(np.uint32).view(np.float32)
    return np.maximum(bits - np.float32(1.0), np.float32(0.0))


def sample_rows(logits: torch.Tensor, sampling: Dict, *,
                return_probs: bool = False):
    """Draw one token per gathered logits row with the row's keyed uniform.

    ``sampling``: {'temperature' (S,), 'top_k' (S,) int or None,
    'seed'/'req_id'/'purpose'/'position' (S,) int32}. The keys may lie on
    the CPU while the logits are on the card (the engine keeps them there);
    the uniforms are hashed on the host and moved to the logits' device
    without waiting for the stream (a pageable copy is staged at once).
    Greedy rows (temperature <= 0) take the raw argmax. Returns (S,) int32
    tokens (plus the warped (S, V) probs when ``return_probs``)."""
    u = keyed_uniform(sampling["seed"], sampling["req_id"],
                      sampling["purpose"], sampling["position"])
    return ops.topk_mask_sample_forward(
        logits, sampling["temperature"], sampling.get("top_k"),
        u.to(logits.device, non_blocking=True), return_probs=return_probs)


def paged_sample_step(params, cfg, caches: Dict, tokens, sampling: Dict, *,
                      ranks=None, return_probs: bool = False):
    """One fused mixed serving iteration: forward + gathered LM head +
    sampling. ``caches`` must carry ``sample_ids`` aligned row for row with
    the ``sampling`` arrays. Returns ``(tokens (S,) int32, caches)``; the
    pools are updated in place."""
    logits, new_caches = tfm.paged_mixed_step(params, cfg, caches, tokens,
                                              ranks=ranks)
    out = sample_rows(logits[0], sampling, return_probs=return_probs)
    return out, new_caches


def accept_uniforms(seed, req_id, committed, k_cap: int) -> np.ndarray:
    """Every keyed uniform ``device_accept`` may read, hashed on the host:
    for each plan (int32 arrays ``seed``/``req_id``/``committed`` of shape
    (P,)), ``DRAW_ACCEPT`` at ``committed + j`` for ``j < k_cap``, then
    ``DRAW_RESIDUAL`` and ``DRAW_TARGET`` at ``committed + j`` for ``j <=
    k_cap``. Returns a (P, 3 * k_cap + 2) float32 array in that column
    order; the step gathers the last two groups at ``j = m``."""
    seed, req_id, committed = (np.asarray(a, np.int64)
                               for a in (seed, req_id, committed))
    cols = []
    for purpose, n in ((DRAW_ACCEPT, k_cap), (DRAW_RESIDUAL, k_cap + 1),
                       (DRAW_TARGET, k_cap + 1)):
        pos = committed[:, None] + np.arange(n)[None, :]
        cols.append(_uniforms_np(
            np.broadcast_to(seed[:, None], pos.shape),
            np.broadcast_to(req_id[:, None], pos.shape),
            np.full(pos.shape, purpose), pos))
    return np.concatenate(cols, axis=1)


def _warp_rows(rows: torch.Tensor, temperature: torch.Tensor,
               top_k: Optional[torch.Tensor]) -> torch.Tensor:
    """Warped distributions of an (N, V) row batch with per-row knobs: the
    float32 warp of the reference's ``_warp_rows`` (``ref.py``'s threshold
    and warp), so a token the accept test draws from ``p`` is the one the
    target-only sampler would draw at the same key."""
    if top_k is None:
        thr = torch.full(rows.shape[:1], -math.inf, dtype=torch.float32,
                         device=rows.device)
    else:
        z = rows.float() / torch.clamp(temperature.float(), min=1e-30)[:, None]
        thr = ref.topk_threshold_ref(z, top_k)
    return ref.warp_probs_ref(rows, temperature.float(), thr)


def device_accept(rows: torch.Tensor, accept: Dict):
    """Leviathan accept/resample over one round's verify runs, vectorised
    over plans: the port of the reference's ``device_accept`` (and of the
    greedy longest-accepted-prefix rule for greedy sequences).

    ``rows``: (P, K+1, V) target logits, each plan's ``k+1`` scored
    positions padded to the round's draft cap ``K`` (rows past a plan's own
    ``k`` are never read). ``accept``, tensors on ``rows``' device:

      {'k' (P,), 'drafts' (P, K), 'temperature' (P,),
       'top_k' (P,) or absent, 'q' (P, K, V) or absent,
       'u' (P, 3K + 2) float32 from ``accept_uniforms`` (with 'q')}

    ``q`` holds the draft row's warped proposal distributions; greedy-only
    rounds leave it out and skip the stochastic arithmetic. Returns
    ``(commit (P, K+1) int32, accepted (P,) int32)``: every plan commits
    ``accepted + 1`` tokens, the accepted drafts and then the first
    rejection's residual resample or the all-accepted bonus draw (``k = 0``
    is one ``DRAW_TARGET`` draw, the verify-only commit)."""
    p_count, kk, v = rows.shape
    k_cap = kk - 1
    dev = rows.device
    ks = accept["k"].long()
    drafts = accept["drafts"].long()
    temps = accept["temperature"].float()
    greedy_tok = torch.argmax(rows, dim=-1)                    # (P, K+1)
    j = torch.arange(k_cap, device=dev)[None, :]
    in_run = j < ks[:, None]
    # greedy: the longest prefix of drafts matching the target argmax
    g_ok = (drafts == greedy_tok[:, :k_cap]) & in_run
    g_m = torch.cumprod(g_ok.long(), dim=1).sum(dim=1)
    idx = torch.arange(kk, device=dev)[None, :]
    g_commit = torch.where(idx <= g_m[:, None], greedy_tok,
                           torch.zeros_like(greedy_tok))
    if accept.get("q") is None:
        return g_commit.to(torch.int32), g_m.to(torch.int32)

    top_k = accept.get("top_k")
    p_warp = _warp_rows(
        rows.reshape(p_count * kk, v),
        temps[:, None].expand(p_count, kk).reshape(-1),
        None if top_k is None
        else top_k[:, None].expand(p_count, kk).reshape(-1),
    ).reshape(p_count, kk, v)
    q = accept["q"].float()                                    # (P, K, V)
    u = accept["u"]
    u_acc = u[:, :k_cap]
    px = torch.gather(p_warp[:, :k_cap], 2, drafts[..., None])[..., 0]
    qx = torch.gather(q, 2, drafts[..., None])[..., 0]
    # accept with probability min(1, p/q): u*q <= p sidesteps q == 0
    ok = (u_acc * qx <= px) & in_run
    m = torch.cumprod(ok.long(), dim=1).sum(dim=1)             # (P,)
    plan = torch.arange(p_count, device=dev)
    p_m = p_warp[plan, m]
    q_m = q[plan, torch.clamp(m, max=k_cap - 1)]
    # the first rejection (m < k) resamples the normalized residual
    residual = torch.clamp(p_m - q_m, min=0.0)
    tot = residual.sum(dim=-1)
    res_w = torch.where(tot[:, None] > 1e-12, residual, p_m)
    u_res = torch.gather(u[:, k_cap: 2 * k_cap + 1], 1, m[:, None])[:, 0]
    u_bon = torch.gather(u[:, 2 * k_cap + 1:], 1, m[:, None])[:, 0]
    res_tok = ref.sample_cdf_ref(res_w, u_res).long()
    # all accepted (m == k): the bonus draw comes straight from the target
    bon_tok = ref.sample_cdf_ref(p_m, u_bon).long()
    final = torch.where(m == ks, bon_tok, res_tok)
    drafts_pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    commit = torch.where(idx < m[:, None], drafts_pad,
                         torch.where(idx == m[:, None], final[:, None],
                                     torch.zeros_like(drafts_pad)))
    stoch = temps > 0
    return (torch.where(stoch[:, None], commit, g_commit).to(torch.int32),
            torch.where(stoch, m, g_m).to(torch.int32))


def paged_verify_accept_step(params, cfg, caches: Dict, tokens,
                             accept: Dict, chunk_sampling: Optional[Dict],
                             *, ranks=None):
    """One speculative round's target forward: verify runs and riding
    prefill chunks in one flat batch, then acceptance and the finishing
    chunks' first-token draws.

    ``caches['sample_ids']`` lays the gathered rows out as ``P`` verify
    runs of exactly ``K+1`` rows each (a plan pads its run to the round's
    draft cap by repeating a row, never read), then the finishing chunks'
    final-token rows described by ``chunk_sampling`` (or nothing, when
    ``None``). Returns ``(commit (P, K+1) int32, accepted (P,) int32,
    chunk_tokens ((C,) int32 or None), caches)``; the pools are updated in
    place, and nothing here waits for the card."""
    logits, new_caches = tfm.paged_verify_step(params, cfg, caches, tokens,
                                               ranks=ranks)
    rows = logits[0]
    p_count, kk = accept["drafts"].shape[0], accept["drafts"].shape[1] + 1
    commit, m = device_accept(
        rows[: p_count * kk].reshape(p_count, kk, -1), accept)
    chunk_tokens = None
    if chunk_sampling is not None:
        c = chunk_sampling["temperature"].shape[0]
        chunk_tokens = sample_rows(rows[p_count * kk: p_count * kk + c],
                                   chunk_sampling)
    return commit, m, chunk_tokens, new_caches
