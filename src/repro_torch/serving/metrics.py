"""Serving metrics: tokens/s, time-to-first-token (broken into queue /
prefill / first-decode), KV-cache occupancy, per-iteration token-budget
accounting for mixed prefill/decode iterations, a per-iteration
dispatch/host wall-time split (the device-resident sampling pipeline's
observable), and draft/verify acceptance accounting for speculative
decoding rounds.

Collected host-side by the engine loop (one sample per scheduler iteration)
— cheap enough to stay on for production traffic.

This module is the post-hoc per-run aggregator (``summary()`` means and
percentiles). Live observability — structured trace events and exportable
Prometheus/JSONL series — lives in ``repro.obs`` and is fed from the same
callbacks when a ``tracer``/``registry`` is attached (see
``ServingMetrics.__init__`` and ``docs/observability.md``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.obs import (CAT_REQUEST, CAT_SPEC, NULL_TRACER, request_tid)


def _pct(xs: List[float], q: float) -> float:
    """Linear-interpolation quantile (numpy's default ``linear`` method).

    The previous nearest-rank-with-rounding rule was biased at small N —
    e.g. p90 of two samples returned the max outright and p50 of an even
    list picked one middle element instead of their midpoint. Interpolating
    between the floor/ceil order statistics at fractional rank
    ``q * (N - 1)`` is exact for the N=1/N=2 edges and matches
    ``np.percentile`` everywhere (pinned by tests/test_metrics.py)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    pos = q * (len(s) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def _mean(xs: List[float]) -> float:
    return sum(xs) / len(xs) if xs else 0.0


@dataclasses.dataclass
class RequestTrace:
    submit_t: float
    admit_t: Optional[float] = None        # seated in a batch slot
    prefill_end_t: Optional[float] = None  # last prompt chunk dispatched
    first_token_t: Optional[float] = None  # first generated token sampled
    finish_t: Optional[float] = None
    new_tokens: int = 0
    preemptions: int = 0
    prefix_hit_tokens: int = 0             # prompt tokens skipped via cache
    cancelled: bool = False                # client cancelled mid-flight

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def ttft_parts(self) -> Optional[Tuple[float, float, float]]:
        """(queue, prefill, first_decode) seconds — the TTFT decomposition.
        queue: submit -> admission into a slot; prefill: admission -> last
        prompt chunk through the forward; first_decode: chunk completion ->
        first token sampled. In today's synchronous engines the first token
        is argmaxed from the prefill dispatch itself, so first_decode is
        ~0 by construction — it becomes meaningful once sampling moves off
        the host loop (async/batched samplers, ROADMAP). Components describe
        the attempt that actually DELIVERED: recompute semantics discard a
        preemption victim's generated tokens, so ``on_preempt`` clears the
        attempt timestamps (``admit_t``/``prefill_end_t``/``first_token_t``)
        along with the token count and the re-admission records them fresh
        — a preempted-then-recomputed request's TTFT spans submit to the
        recomputed attempt's first token, never the discarded one
        (pinned by tests/test_metrics.py)."""
        if (self.first_token_t is None or self.admit_t is None
                or self.prefill_end_t is None):
            return None
        return (self.admit_t - self.submit_t,
                self.prefill_end_t - self.admit_t,
                self.first_token_t - self.prefill_end_t)


class ServingMetrics:
    """Aggregates per-request traces plus engine-level counters.

    Optionally fans the same lifecycle callbacks out to the observability
    layer (``repro.obs``): ``tracer`` receives request-lifecycle instants
    as they happen plus synthesized queue/prefill/decode duration spans at
    finish (one Perfetto track per request), and ``registry`` keeps
    exportable counters/gauges/histograms (tokens, TTFT parts, occupancy,
    spec acceptance) alive for Prometheus scrapes and JSONL snapshots.
    Both default to off and cost nothing when off; pass the engine's
    ``tracer``/``registry`` (or construct your own) to turn them on. The
    tracer should share this object's clock so spans line up."""

    def __init__(self, clock=time.perf_counter, *, tracer=None,
                 registry=None):
        self._clock = clock
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.registry = registry
        if registry is not None:
            self._m_tokens = registry.counter(
                "repro_generated_tokens_total", "generated tokens delivered")
            self._m_prefill = registry.counter(
                "repro_prefill_tokens_total", "prompt tokens prefilled")
            self._m_preempt = registry.counter(
                "repro_preemptions_total", "sequences preempted for recompute")
            self._m_finished = registry.counter(
                "repro_requests_finished_total", "requests served to completion")
            self._m_ttft = registry.histogram(
                "repro_ttft_seconds", "submit -> first generated token")
            self._m_ttft_part = registry.histogram(
                "repro_ttft_part_seconds",
                "TTFT decomposition (label part: queue/prefill/first_decode)")
            self._m_occ = registry.gauge(
                "repro_kv_occupancy", "paged-cache block occupancy [0, 1]")
            self._m_frag = registry.gauge(
                "repro_kv_free_fragmentation",
                "1 - largest contiguous free run / free blocks")
            self._m_free = registry.gauge(
                "repro_kv_free_blocks", "free-list level")
            self._m_disp = registry.histogram(
                "repro_iteration_dispatch_seconds",
                "per-iteration device dispatch+sync time")
            self._m_host = registry.histogram(
                "repro_iteration_host_seconds",
                "per-iteration host scheduling/commit time")
            self._m_overlap = registry.histogram(
                "repro_iteration_overlap_seconds",
                "per-iteration device time hidden under host work "
                "(lookahead pipelining)")
            self._m_lookahead = registry.counter(
                "repro_lookahead_iterations_total",
                "iterations planned speculatively before the prior commit")
            self._m_rollback = registry.counter(
                "repro_rollbacks_total",
                "speculative plans invalidated and replanned (label reason)")
            self._m_cancel = registry.counter(
                "repro_cancellations_total",
                "requests cancelled by the client mid-flight")
            self._m_draft = registry.counter(
                "repro_spec_draft_tokens_total", "draft tokens proposed")
            self._m_accept = registry.counter(
                "repro_spec_accepted_tokens_total", "draft tokens accepted")
            self._m_ewma = registry.gauge(
                "repro_spec_accept_ewma",
                "trailing speculative acceptance rate (0.1-weight EWMA)")
            self._m_queue = registry.gauge(
                "repro_queue_depth", "waiting requests (label row)")
            self._m_phits = registry.counter(
                "repro_prefix_cache_hits_total",
                "admissions that matched >= 1 cached prefix block")
            self._m_phit_tokens = registry.counter(
                "repro_prefix_cache_hit_tokens_total",
                "prompt tokens skipped via prefix-cache hits")
            self._m_pcached = registry.gauge(
                "repro_prefix_cached_blocks", "blocks in the prefix index")
            self._m_pcow = registry.gauge(
                "repro_prefix_cow_copies",
                "device copy-on-write block copies (cumulative this run)")
            self._m_pevict = registry.gauge(
                "repro_prefix_evictions",
                "warm blocks recycled out of the prefix index (cumulative)")
        self._accept_ewma: Optional[float] = None
        self.traces: Dict[int, RequestTrace] = {}
        self.decode_steps = 0
        self.prefill_tokens = 0
        # cumulative generated tokens across all requests — the engine's
        # heartbeat: the watchdog's no-progress stall and inter-token SLO
        # rules key off this advancing (see obs/watchdog.py)
        self.generated_tokens = 0
        self.preemptions = 0
        self.occupancy_samples: List[float] = []
        # one (decode_tokens, prefill_tokens) pair per mixed iteration —
        # the token-budget audit trail for the chunked-prefill engine
        self.iteration_log: List[Tuple[int, int]] = []
        # one (draft_tokens, verify_tokens, accepted_tokens, drafting_seqs)
        # tuple per speculative round — the draft/verify audit trail
        self.spec_round_log: List[Tuple[int, int, int, int]] = []
        # one (dispatch_s, host_s, overlap_s) triple per iteration.
        # dispatch_s: the VISIBLE wait on the device — time the host spent
        # blocked syncing the iteration's outputs; host_s: everything else
        # the iteration spent on the host (planning, commits, python
        # sampling on the host-oracle path); overlap_s: device time hidden
        # under host work by lookahead pipelining (the window between
        # enqueueing the dispatch and starting the sync, during which the
        # device ran while the host planned the next iteration). Serial
        # engines report overlap_s = 0 and dispatch_s = full device time.
        # The attribution invariant either way: wall-clock ~ sum(dispatch)
        # + sum(host) — overlapped device time is never double-counted
        # (pinned by the scripted-clock test in tests/test_metrics.py).
        self.timing_log: List[Tuple[float, float, float]] = []
        # pipelined-engine counters: speculatively planned iterations,
        # rollbacks (plan invalidated by the prior commit) by reason, and
        # client cancellations
        self.lookahead_iterations = 0
        self.rollbacks = 0
        self.rollback_reasons: Dict[str, int] = {}
        self.cancellations = 0
        self.draft_tokens = 0
        self.accepted_draft_tokens = 0
        self.drafting_seq_rounds = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self._start: Optional[float] = None
        self._end: Optional[float] = None

    def now(self) -> float:
        return self._clock()

    def on_submit(self, req_id: int) -> None:
        t = self.now()
        if self._start is None:
            self._start = t
        self.traces[req_id] = RequestTrace(submit_t=t)
        if self.tracer.enabled:
            self.tracer.instant("submit", CAT_REQUEST,
                                tid=request_tid(req_id))

    def on_admit(self, req_id: int) -> None:
        """Request seated in a batch slot (prefill may start)."""
        tr = self.traces[req_id]
        if tr.first_token_t is None:
            tr.admit_t = self.now()
        if self.tracer.enabled:
            self.tracer.instant("admit", CAT_REQUEST,
                                tid=request_tid(req_id),
                                args={"attempt": tr.preemptions + 1})

    def on_prefill_chunk(self, num_tokens: int) -> None:
        """A prefill chunk of ``num_tokens`` rode this iteration's budget."""
        self.prefill_tokens += num_tokens
        if self.registry is not None:
            self._m_prefill.inc(num_tokens)

    def on_prefill_end(self, req_id: int) -> None:
        """The request's final prompt chunk went through the forward."""
        tr = self.traces[req_id]
        if tr.first_token_t is None:
            tr.prefill_end_t = self.now()
        if self.tracer.enabled:
            self.tracer.instant("prefill_end", CAT_REQUEST,
                                tid=request_tid(req_id))

    def on_first_token(self, req_id: int, prefill_tokens: int = 0) -> None:
        """First generated token sampled. ``prefill_tokens``: prompt tokens
        prefilled in one shot (the non-chunked paths); chunked prefill
        reports per-chunk via ``on_prefill_chunk`` and passes 0."""
        tr = self.traces[req_id]
        t = self.now()
        if tr.first_token_t is None:
            if tr.admit_t is None:        # callers that skip on_admit
                tr.admit_t = tr.submit_t
            if tr.prefill_end_t is None:
                tr.prefill_end_t = t
            tr.first_token_t = t
            if self.tracer.enabled:
                self.tracer.instant("first_token", CAT_REQUEST,
                                    tid=request_tid(req_id))
            if self.registry is not None:
                self._m_ttft.observe(tr.ttft)
                parts = tr.ttft_parts
                if parts is not None:
                    for part, v in zip(("queue", "prefill", "first_decode"),
                                       parts):
                        self._m_ttft_part.labels(part=part).observe(v)
        tr.new_tokens += 1
        self.generated_tokens += 1
        self.prefill_tokens += prefill_tokens
        if self.registry is not None:
            self._m_tokens.inc()
            if prefill_tokens:
                self._m_prefill.inc(prefill_tokens)

    def on_decode_step(self, new_tokens: int, occupancy: float) -> None:
        self.decode_steps += 1
        self.occupancy_samples.append(occupancy)
        if self.registry is not None:
            self._m_occ.set(occupancy)

    def on_mixed_step(self, decode_tokens: int, prefill_tokens: int,
                      occupancy: float) -> None:
        """One mixed prefill/decode iteration: ``decode_tokens`` sequences
        advanced a token and ``prefill_tokens`` prompt tokens rode along."""
        self.iteration_log.append((decode_tokens, prefill_tokens))
        if decode_tokens:
            self.decode_steps += 1
        self.occupancy_samples.append(occupancy)
        if self.tracer.enabled:
            self.tracer.counter("kv_occupancy", occupancy)
        if self.registry is not None:
            self._m_occ.set(occupancy)

    def on_cache_stats(self, free_blocks: int, fragmentation: float,
                       prefix=None) -> None:
        """Free-list level + fragmentation gauges (fragmentation is served
        from the allocator's incremental run tracker — O(1) amortised, so
        this is safe on the per-iteration hot path). ``prefix``: an optional
        ``kv_cache.PrefixCacheStats`` snapshot feeding the prefix-cache
        gauges."""
        if self.registry is not None:
            self._m_free.set(free_blocks)
            self._m_frag.set(fragmentation)
            if prefix is not None:
                self._m_pcow.set(prefix.cow_copies)
                self._m_pevict.set(prefix.evictions)

    def on_prefix_hit(self, req_id: int, tokens: int,
                      cached_blocks: int = 0) -> None:
        """Admission matched ``tokens`` prompt tokens in the prefix index —
        that many positions skip prefill entirely this attempt."""
        self.prefix_hits += 1
        self.prefix_hit_tokens += tokens
        self.traces[req_id].prefix_hit_tokens = tokens
        if self.tracer.enabled:
            self.tracer.instant("prefix_hit", CAT_REQUEST,
                                tid=request_tid(req_id),
                                args={"tokens": tokens})
        if self.registry is not None:
            self._m_phits.inc()
            self._m_phit_tokens.inc(tokens)
            self._m_pcached.set(cached_blocks)

    def on_queue_depths(self, depths: Dict[int, int]) -> None:
        """Per-budget-row waiting-queue depths (gauge labeled by row)."""
        if self.registry is not None:
            for row, depth in depths.items():
                self._m_queue.labels(row=row).set(depth)

    def on_spec_round(self, draft_tokens: int, verify_tokens: int,
                      accepted_tokens: int, drafting_seqs: int = 0) -> None:
        """One speculative draft/verify round: ``draft_tokens`` proposals
        went through the draft row, ``verify_tokens`` positions through the
        full-row verify forward, and ``accepted_tokens`` drafts survived the
        longest-accepted-prefix check across ``drafting_seqs`` sequences
        that proposed at least one draft (committed corrections are counted
        by ``on_token``, not here)."""
        self.spec_round_log.append(
            (draft_tokens, verify_tokens, accepted_tokens, drafting_seqs))
        self.draft_tokens += draft_tokens
        self.accepted_draft_tokens += accepted_tokens
        self.drafting_seq_rounds += drafting_seqs
        if draft_tokens:
            rate = accepted_tokens / draft_tokens
            self._accept_ewma = (rate if self._accept_ewma is None
                                 else 0.9 * self._accept_ewma + 0.1 * rate)
        if self.tracer.enabled:
            self.tracer.instant(
                "spec_round", CAT_SPEC,
                args={"draft": draft_tokens, "verify": verify_tokens,
                      "accepted": accepted_tokens,
                      "drafting_seqs": drafting_seqs})
        if self.registry is not None:
            self._m_draft.inc(draft_tokens)
            self._m_accept.inc(accepted_tokens)
            if self._accept_ewma is not None:
                self._m_ewma.set(self._accept_ewma)

    def on_iteration_timing(self, dispatch_s: float, host_s: float,
                            overlap_s: float = 0.0) -> None:
        """One iteration's device/host wall-time split. ``dispatch_s``: the
        host's VISIBLE wait on the jitted forward (and fused sampling) —
        for serial engines that is the whole device time, for the pipelined
        engine only the residual sync after host work ran under the
        dispatch; ``host_s``: everything else the iteration spent on the
        host — scheduling, cache bookkeeping, commits, and (on the
        host-sampling oracle path) the per-row python sampling loop;
        ``overlap_s``: device time hidden under host work (0 for serial
        engines). ``dispatch_s + host_s`` always sums to the iteration's
        wall-clock share — overlapped time is attributed once, to the host
        work that hid it, never double-counted."""
        self.timing_log.append((dispatch_s, max(host_s, 0.0),
                                max(overlap_s, 0.0)))
        if self.registry is not None:
            self._m_disp.observe(dispatch_s)
            self._m_host.observe(max(host_s, 0.0))
            if overlap_s > 0.0:
                self._m_overlap.observe(overlap_s)

    def on_lookahead(self) -> None:
        """One iteration was planned + dispatched speculatively, before the
        previous iteration's commit."""
        self.lookahead_iterations += 1
        if self.registry is not None:
            self._m_lookahead.inc()

    def on_rollback(self, reason: str) -> None:
        """A speculative plan was invalidated by the commit it raced
        (forced fault, prefix-hit drift, cancellation, ...) — its host
        state was restored and the iteration replanned."""
        self.rollbacks += 1
        self.rollback_reasons[reason] = (
            self.rollback_reasons.get(reason, 0) + 1)
        if self.registry is not None:
            self._m_rollback.labels(reason=reason).inc()

    def on_cancel(self, req_id: int) -> None:
        """Client cancelled the request mid-flight; its slot and blocks are
        already freed by the engine. The trace keeps the tokens delivered
        before the cancel and is closed with ``cancelled=True``."""
        self.cancellations += 1
        tr = self.traces[req_id]
        tr.cancelled = True
        tr.finish_t = self.now()
        self._end = tr.finish_t
        if self.tracer.enabled:
            self.tracer.instant("cancel", CAT_REQUEST,
                                tid=request_tid(req_id),
                                args={"delivered": tr.new_tokens})
        if self.registry is not None:
            self._m_cancel.inc()

    def on_token(self, req_id: int) -> None:
        self.traces[req_id].new_tokens += 1
        self.generated_tokens += 1
        if self.registry is not None:
            self._m_tokens.inc()

    @property
    def accept_ewma(self) -> Optional[float]:
        """Trailing speculative acceptance-rate EWMA (None before any
        speculative round) — the watchdog's collapse signal."""
        return self._accept_ewma

    @property
    def spec_rounds(self) -> int:
        return len(self.spec_round_log)

    def on_preempt(self, req_id: int) -> None:
        self.preemptions += 1
        tr = self.traces[req_id]
        tr.preemptions += 1
        # recompute semantics discard the victim's generated tokens; only
        # delivered tokens may count toward throughput — and only the
        # delivering attempt's timeline may count toward TTFT, so the
        # attempt timestamps reset with the tokens (the re-admission
        # records fresh ones; ``submit_t`` and the preemption counter are
        # the only survivors of an attempt)
        tr.new_tokens = 0
        tr.prefix_hit_tokens = 0
        tr.admit_t = None
        tr.prefill_end_t = None
        tr.first_token_t = None
        if self.tracer.enabled:
            self.tracer.instant("preempt", CAT_REQUEST,
                                tid=request_tid(req_id),
                                args={"preemptions": tr.preemptions})
        if self.registry is not None:
            self._m_preempt.inc()

    def on_finish(self, req_id: int) -> None:
        tr = self.traces[req_id]
        tr.finish_t = self.now()
        self._end = tr.finish_t
        if self.registry is not None:
            self._m_finished.inc()
        if self.tracer.enabled:
            self._trace_request_spans(req_id, tr)

    def _trace_request_spans(self, req_id: int, tr: RequestTrace) -> None:
        """Synthesize the finished request's duration spans from its
        ``RequestTrace`` timestamps — one Perfetto track per request with
        ``request`` covering submit -> finish and ``queue``/``prefill``/
        ``decode`` sub-spans for the delivering attempt."""
        tid = request_tid(req_id)
        t = self.tracer
        t.instant("finish", CAT_REQUEST, tid=tid)
        t.complete("request", CAT_REQUEST, tr.submit_t, tr.finish_t, tid=tid,
                   args={"req": req_id, "new_tokens": tr.new_tokens,
                         "preemptions": tr.preemptions})
        if tr.admit_t is not None:
            t.complete("queue", CAT_REQUEST, tr.submit_t, tr.admit_t, tid=tid)
        if tr.admit_t is not None and tr.prefill_end_t is not None:
            t.complete("prefill", CAT_REQUEST, tr.admit_t, tr.prefill_end_t,
                       tid=tid)
        if tr.first_token_t is not None:
            t.complete("decode", CAT_REQUEST, tr.first_token_t, tr.finish_t,
                       tid=tid)

    # ----------------------------------------------------------- summary

    def summary(self) -> Dict[str, float]:
        ttfts = [t.ttft for t in self.traces.values() if t.ttft is not None]
        parts = [t.ttft_parts for t in self.traces.values()
                 if t.ttft_parts is not None]
        gen = sum(t.new_tokens for t in self.traces.values())
        end = self._end if self._end is not None else self.now()
        start = self._start if self._start is not None else end
        wall = (end - start) or 1e-9
        occ = self.occupancy_samples
        return {
            "requests": len(self.traces),
            "generated_tokens": gen,
            "tokens_per_s": gen / wall,
            "wall_s": wall,
            "ttft_mean_s": _mean(ttfts),
            "ttft_p90_s": _pct(ttfts, 0.9),
            "ttft_queue_mean_s": _mean([p[0] for p in parts]),
            "ttft_prefill_mean_s": _mean([p[1] for p in parts]),
            "ttft_first_decode_mean_s": _mean([p[2] for p in parts]),
            "decode_steps": self.decode_steps,
            "mixed_iterations": len(self.iteration_log),
            "dispatch_ms_mean": _mean([t[0] for t in self.timing_log]) * 1e3,
            "host_ms_mean": _mean([t[1] for t in self.timing_log]) * 1e3,
            "dispatch_s_total": sum(t[0] for t in self.timing_log),
            "host_s_total": sum(t[1] for t in self.timing_log),
            "overlap_ms_mean": _mean([t[2] for t in self.timing_log]) * 1e3,
            "overlap_s_total": sum(t[2] for t in self.timing_log),
            # fraction of total device busy time hidden under host work:
            # overlap / (overlap + visible dispatch). 0 for serial engines.
            "overlap_fraction": (
                sum(t[2] for t in self.timing_log)
                / max(sum(t[0] + t[2] for t in self.timing_log), 1e-12)),
            "lookahead_iterations": self.lookahead_iterations,
            "rollbacks": self.rollbacks,
            "cancellations": self.cancellations,
            "preemptions": self.preemptions,
            "cache_occupancy_mean": _mean(occ),
            "cache_occupancy_peak": max(occ) if occ else 0.0,
            "spec_rounds": len(self.spec_round_log),
            "spec_draft_tokens": self.draft_tokens,
            "spec_accepted_tokens": self.accepted_draft_tokens,
            "spec_acceptance_rate": (self.accepted_draft_tokens
                                     / max(self.draft_tokens, 1)),
            # accepted drafts per drafting sequence-round (<= spec_len);
            # each such round also commits one correction token on top
            "spec_mean_accepted_len": (self.accepted_draft_tokens
                                       / max(self.drafting_seq_rounds, 1)),
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
        }
