"""Per-request token sampling: temperature / top-k with explicit PRNG state.

The seed engine argmaxed everything; this module makes sampling a
per-request property. ``Request.sampling`` carries the knobs, every admitted
``Sequence`` owns a ``SamplerState`` whose generator is seeded
deterministically from ``(seed, req_id)`` — so a preempted sequence that is
recomputed replays *exactly* the same draws (``reset()`` re-seeds), keeping
the scheduler's recompute-identity guarantee even for stochastic requests.

Greedy (``temperature == 0``, the default) stays the fast path: engines
argmax the whole batch on device and only fall back to the host-side sampler
for the slots that asked for it.

Two PRNG disciplines coexist, split off the same ``(seed, req_id)`` key:

  * the **sequential stream** (``sample``): one draw per committed token, in
    commit order. Used by the drain and mixed engines, where every sampler
    path consumes exactly one draw per token — ``reset()`` + recompute then
    replays the identical stream.
  * **stream-split keyed draws** (``uniform`` / ``sample_at``): each draw is
    keyed by ``(seed, req_id, purpose, position)`` — a counter-based scheme
    where the uniforms backing a committed position are a pure function of
    the key, not of how many draws happened before. Speculative decoding
    needs this: a round may propose, test, and resample several positions
    and then throw some of those draws away on rejection or mid-round
    preemption; sequential consumption would drift the stream, keyed draws
    cannot. The ``DRAW_*`` purposes keep the proposal, accept-test, and
    residual-resample uniforms of one position mutually independent.

This module is host-side numpy and doubles as the **test oracle** for the
device-resident pipeline: ``serving.device_sampling`` ports the keyed-draw
discipline onto JAX's counter-based PRNG (``fold_in`` over the same
``(seed, req_id, purpose, position)`` tuple) and fuses the warp + draw into
the jitted serving step, so engines with ``device_sampling=True`` (the
default) never ship logits to the host. Greedy tokens are bit-identical
across the two; stochastic tokens agree in distribution (the uniforms come
from different generators), which is what the chi-squared/TV equivalence
suite in ``tests/test_device_sampling.py`` pins.

For speculative decoding the sampler also exposes its *warped distribution*
(``probs``): the temperature/top-k-transformed categorical the request
actually samples from. Stochastic speculative acceptance (accept draft ``x``
with probability ``min(1, p_tgt(x) / p_draft(x))``, resample from the
normalized residual ``max(p_tgt - p_draft, 0)`` on rejection) must run on
these warped distributions — that is what makes the committed tokens exactly
distributed as target-only sampling with the same knobs.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np

# Stream-split draw purposes (see module docstring). One committed position
# consumes at most one draw per purpose, so the tuple (seed, req_id,
# purpose, position) never collides across a sequence's lifetime — including
# across preemption-recompute attempts, which simply re-derive the same
# uniforms at the same positions.
DRAW_TARGET = 0     # direct target-distribution sample: verify-only commit,
                    # all-accepted bonus token, prefill-completion token
DRAW_DRAFT = 1      # draft-row proposal
DRAW_ACCEPT = 2     # accept test u <= p_tgt(x) / p_draft(x)
DRAW_RESIDUAL = 3   # resample from the normalized residual on rejection


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs. ``temperature == 0`` means greedy (the
    default everywhere); ``top_k == 0`` means no top-k truncation."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")


GREEDY = SamplingParams()


def sample_from(probs: np.ndarray, u: float) -> int:
    """Inverse-CDF sample from a (V,) probability vector with uniform ``u``.

    The CDF is renormalized by its own total so callers may pass an
    unnormalized (but non-negative) weight vector."""
    cdf = np.cumsum(probs)
    return int(min(np.searchsorted(cdf, u * cdf[-1], side="right"),
                   len(cdf) - 1))


class SamplerState:
    """One request's sampler: params + a resettable PRNG stream.

    The stream is keyed by ``(seed, req_id)`` so two requests with the same
    user seed still draw independently, and ``reset()`` restores the stream
    to its initial state for preemption-recompute replay. Keyed draws
    (``uniform``) are derived from the same key but are stateless — they
    need no reset and are immune to stream drift by construction.
    """

    def __init__(self, params: Optional[SamplingParams], req_id: int):
        self.params = params or GREEDY
        # the stream key, public: the device sampling pipeline exports it
        # as the (seed, req_id) half of its fold_in chain
        self.seed = int(self.params.seed)
        self.req_id = int(req_id)
        self._key = (self.params.seed, req_id)
        self._rng: Optional[np.random.Generator] = None
        self.reset()

    def reset(self) -> None:
        """Rewind the PRNG to its initial state (recompute replays draws)."""
        if not self.greedy:
            self._rng = np.random.default_rng(self._key)

    @property
    def greedy(self) -> bool:
        return self.params.temperature <= 0.0

    def state_snapshot(self):
        """Copy of the sequential-stream PRNG state (None for greedy — the
        stream is never materialized). Keyed draws are stateless and need
        no snapshot. Used by the pipelined engine's speculative-plan
        rollback: restoring makes the stream replay bit-identically."""
        if self._rng is None:
            return None
        return copy.deepcopy(self._rng.bit_generator.state)

    def state_restore(self, snap) -> None:
        if snap is None:
            self._rng = None
            return
        if self._rng is None:
            self._rng = np.random.default_rng(self._key)
        self._rng.bit_generator.state = copy.deepcopy(snap)

    def probs(self, logits: np.ndarray) -> np.ndarray:
        """The warped categorical this sampler draws from, as a (V,) float64
        probability vector: temperature scaling then top-k truncation.
        Greedy degenerates to one-hot argmax (the zero-temperature limit)."""
        logits = np.asarray(logits, np.float64)
        if self.greedy:
            p = np.zeros(logits.shape[-1])
            p[int(np.argmax(logits))] = 1.0
            return p
        z = logits / self.params.temperature
        if self.params.top_k:
            k = min(self.params.top_k, z.shape[-1])
            cutoff = np.partition(z, -k)[-k]
            z = np.where(z >= cutoff, z, -np.inf)
        z = z - z.max()
        p = np.exp(z)
        return p / p.sum()

    def uniform(self, position: int, purpose: int) -> float:
        """Stream-split keyed draw: one uniform in [0, 1) as a pure function
        of ``(seed, req_id, purpose, position)``. ``position`` is the
        0-based index of the token in the full sequence (prompt included);
        ``purpose`` one of the ``DRAW_*`` constants."""
        return float(np.random.default_rng(
            (self._key[0], self._key[1], purpose, position)).random())

    def sample(self, logits: np.ndarray) -> int:
        """Draw one token from a (V,) float logits row off the sequential
        stream (exactly one draw consumed — the drain/mixed-engine
        discipline)."""
        logits = np.asarray(logits, np.float64)
        if self.greedy:
            return int(np.argmax(logits))
        return sample_from(self.probs(logits), float(self._rng.random()))

    def sample_at(self, position: int, logits: np.ndarray) -> int:
        """Draw the token at ``position`` from the warped target
        distribution with the position-keyed ``DRAW_TARGET`` uniform (the
        speculative decoder's target-sample path — drift-free under
        rollback and preemption replay)."""
        logits = np.asarray(logits, np.float64)
        if self.greedy:
            return int(np.argmax(logits))
        return sample_from(self.probs(logits),
                           self.uniform(position, DRAW_TARGET))


def sample_token(seq, logits_row) -> int:
    """Sample the next token for ``seq`` from its (V,) logits row off the
    sequential stream. Engines call this at every point a token is
    materialized (decode step, prefill completion, verify position) so one
    code path owns the greedy/stochastic split. The speculative decoder
    instead uses ``SamplerState.sample_at`` and the ``DRAW_*`` keyed draws
    for sequences participating in stochastic speculation."""
    sampler = getattr(seq, "sampler", None)
    if sampler is None or sampler.greedy:
        return int(np.argmax(np.asarray(logits_row)))
    return sampler.sample(np.asarray(logits_row))
