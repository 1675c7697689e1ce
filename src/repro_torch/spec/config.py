"""Speculative-decoding configuration for the elastic serving engine (a
copy of the JAX package's framework-free ``spec/config.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Knobs for nested self-speculative decoding.

    ``draft_rank``: budget fraction (like ``Request.budget``) naming the
    *draft* profile-table row. For every served target row the engine
    resolves the largest nested prefix row strictly below it within this
    fraction (``core.flexrank.nested_prefix_row``); rows with no smaller
    prefix row (the bottom row) serve without speculation.

    ``spec_len``: maximum draft tokens proposed per round (the classic
    ``k``). Per-request override via ``Request.spec_len`` (0 disables
    speculation for that request). With ``adaptive_k`` unset every round
    drafts at this depth; with it set, ``spec_len`` is the ceiling the
    per-sequence controller may grow back up to.

    ``gap_chunk``: draft-cache warmup tokens fed per round. The draft slot
    is never prefilled eagerly — the first rounds after a sequence starts
    decoding stream its committed tokens (prompt included) through the
    draft row in chunks of this size, while the sequence keeps decoding at
    ``k = 0`` through verify. Drafting starts once the draft cache has
    caught up.

    ``stochastic``: Leviathan-style stochastic speculative sampling for
    sequences with temperature/top-k sampling — the draft row proposes from
    its own *sampled* (warped) distribution, the verify pass accepts each
    proposal with probability ``min(1, p_tgt / p_draft)`` and resamples
    from the normalized residual on rejection, so the committed tokens are
    *distributed exactly* as target-only sampling (distributional, not
    token-level, identity — the greedy guarantee stays token-exact).
    ``False`` keeps the verify-only fallback: stochastic requests run
    verify-only ``k = 0`` rounds off the sequential sampler stream, which
    is token-identical to the non-speculative engines.

    ``adaptive_k``: per-sequence draft-length control. Each sequence tracks
    a trailing acceptance-rate EWMA (weight ``k_ewma`` on the newest
    round); its draft length grows by one when the EWMA clears ``k_grow``
    and shrinks by one when it drops below ``k_shrink``, clamped to
    ``[0, spec_len]``. A sequence parked at ``k = 0`` re-probes with a
    single draft every ``k_probe`` rounds so a phase change can re-enable
    speculation. Controller state lives on the ``Sequence`` and resets with
    preemption-recompute, so replay stays deterministic.
    """
    draft_rank: float = 0.5
    spec_len: int = 4
    gap_chunk: int = 32
    stochastic: bool = True
    adaptive_k: bool = False
    k_ewma: float = 0.5
    k_grow: float = 0.8
    k_shrink: float = 0.4
    k_probe: int = 8

    def __post_init__(self):
        if not 0.0 < self.draft_rank <= 1.0:
            raise ValueError(
                f"draft_rank must be in (0, 1], got {self.draft_rank}")
        if self.spec_len < 1:
            raise ValueError(f"spec_len must be >= 1, got {self.spec_len}")
        if self.gap_chunk < 1:
            raise ValueError(f"gap_chunk must be >= 1, got {self.gap_chunk}")
        if not 0.0 < self.k_ewma <= 1.0:
            raise ValueError(f"k_ewma must be in (0, 1], got {self.k_ewma}")
        if not 0.0 <= self.k_shrink < self.k_grow <= 1.0:
            raise ValueError(
                "need 0 <= k_shrink < k_grow <= 1, got "
                f"k_shrink={self.k_shrink}, k_grow={self.k_grow}")
        if self.k_probe < 1:
            raise ValueError(f"k_probe must be >= 1, got {self.k_probe}")

    # -------------------------------------------------- per-sequence policy

    def request_can_draft(self, seq) -> bool:
        """Whether this request can EVER draft: not opted out via
        ``Request.spec_len = 0``, and — for stochastic sampling — only when
        ``stochastic`` acceptance is enabled (otherwise sampled sequences
        keep the verify-only fallback). Permanently-disabled sequences
        skip draft-cache warmup entirely — no draft-row forwards, no
        draft-slot blocks — and decode through verify-only rounds."""
        if (seq.sampler is not None and not seq.sampler.greedy
                and not self.stochastic):
            return False
        return seq.request.spec_len is None or seq.request.spec_len > 0

    def _spec_len_cap(self, seq) -> int:
        k = self.spec_len
        if seq.request.spec_len is not None:
            k = seq.request.spec_len
        return k

    def request_spec_len(self, seq) -> int:
        """Effective draft length for one sequence this round: per-request
        override, verify-only opt-outs, the adaptive-k controller when
        enabled, and never drafting past what the request can still accept
        (a draft beyond ``remaining - 1`` can only be wasted — the round
        always commits one correction token). Call once per planned round:
        the ``k = 0`` probe counter advances here."""
        if not self.request_can_draft(seq):
            return 0
        cap = self._spec_len_cap(seq)
        if self.adaptive_k:
            if seq.spec_k is None:
                seq.spec_k = cap             # start optimistic, degrade
            k = min(seq.spec_k, cap)
            if k == 0:
                seq.spec_idle_rounds += 1
                if seq.spec_idle_rounds >= self.k_probe:
                    seq.spec_idle_rounds = 0
                    k = 1                    # probe: one draft to re-measure
        else:
            k = cap
        return max(0, min(k, seq.remaining - 1))

    def observe_round(self, seq, k: int, accepted: int) -> Optional[dict]:
        """Feed one drafting round's outcome (``accepted`` of ``k`` drafts
        survived) into the sequence's adaptive-k controller. No-op unless
        ``adaptive_k``; rounds that drafted nothing carry no signal.

        Returns a decision record (``req``/``k``/``accepted``/``ewma``/
        ``action``/``new_k``/``reason``) when the controller ran, so the
        decoder can trace every adaptive-k move with its reason; ``None``
        when the round carried no signal."""
        if not self.adaptive_k or k <= 0:
            return None
        rate = accepted / k
        ewma = seq.spec_accept_ewma
        seq.spec_accept_ewma = (rate if ewma is None
                                else (1.0 - self.k_ewma) * ewma
                                + self.k_ewma * rate)
        cur = seq.spec_k if seq.spec_k is not None else k
        if seq.spec_accept_ewma >= self.k_grow:
            cur += 1
            action = "grow"
            reason = f"ewma {seq.spec_accept_ewma:.3f} >= k_grow {self.k_grow}"
        elif seq.spec_accept_ewma < self.k_shrink:
            cur -= 1
            action = "shrink"
            reason = (f"ewma {seq.spec_accept_ewma:.3f} < "
                      f"k_shrink {self.k_shrink}")
        else:
            action = "hold"
            reason = (f"ewma {seq.spec_accept_ewma:.3f} in "
                      f"[{self.k_shrink}, {self.k_grow})")
        seq.spec_k = max(0, min(cur, self._spec_len_cap(seq)))
        if seq.spec_k > 0:
            seq.spec_idle_rounds = 0
        return {"req": seq.req_id, "k": k, "accepted": accepted,
                "ewma": seq.spec_accept_ewma, "action": action,
                "new_k": seq.spec_k, "reason": reason}
