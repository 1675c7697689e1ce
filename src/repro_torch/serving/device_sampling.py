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

Speculative acceptance (``device_accept``, ``paged_verify_accept_step``)
waits for the speculative-decoding slice (ROADMAP).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.threefry import M32, threefry2x32
from repro_torch.models import transformer as tfm

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
    keys = [a.cpu().numpy().astype(np.int64) & M32
            for a in (seed, req_id, purpose, position)]
    bits = _uniform_bits(*keys).astype(np.uint32).view(np.float32)
    return torch.from_numpy(np.maximum(bits - np.float32(1.0),
                                       np.float32(0.0))).to(seed.device)


def sample_rows(logits: torch.Tensor, sampling: Dict, *,
                return_probs: bool = False):
    """Draw one token per gathered logits row with the row's keyed uniform.

    ``sampling``: {'temperature' (S,), 'top_k' (S,) int or None,
    'seed'/'req_id'/'purpose'/'position' (S,) int32}. The keys may lie on
    the CPU while the logits are on the card (the engine keeps them there);
    the uniforms are hashed on the host and moved to the logits' device.
    Greedy rows (temperature <= 0) take the raw argmax. Returns (S,) int32
    tokens (plus the warped (S, V) probs when ``return_probs``)."""
    u = keyed_uniform(sampling["seed"], sampling["req_id"],
                      sampling["purpose"], sampling["position"])
    return ops.topk_mask_sample_forward(
        logits, sampling["temperature"], sampling.get("top_k"),
        u.to(logits.device), return_probs=return_probs)


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
