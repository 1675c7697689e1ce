"""Nested self-speculative decoding: draft with a low-rank prefix submodel,
verify with the full-rank row, over the paged KV cache.

FlexRank's importance-ordered nesting makes every lower budget row a prefix
view of every higher one: a draft/verify pair that needs no separate draft
model and no extra weight memory. ``SpecConfig`` names the draft budget and
draft-length policy (fixed or adaptive-k); ``SpecDecoder`` drives the
draft/verify rounds for one budget row inside the serving engine's
continuous-batching loop. Greedy acceptance is token-identical to
target-only decoding; stochastic acceptance (``stochastic_accept``,
Leviathan accept/resample) is distribution-identical to target-only
sampling.
"""
from repro_torch.spec.config import SpecConfig
from repro_torch.spec.decoder import SpecDecoder, stochastic_accept

__all__ = ["SpecConfig", "SpecDecoder", "stochastic_accept"]
