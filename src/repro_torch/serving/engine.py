"""Elastic serving engine: continuous batching over nested FlexRank
submodels, on the card.

Holds one set of shared FlexRank weights plus the nested profile table;
each request names a budget, the router maps it to a GAR-deployed row and
the engine serves the row with chunked prefill fused into decode
iterations: every iteration builds one flat token batch (each decoding
sequence's next token, then FIFO prompt chunks of at most
``prefill_chunk`` tokens under the token budget) and runs it through one
``paged_mixed_step`` forward over the block-paged KV cache. Cache pressure
preempts the youngest block holder for recompute.

Token emission is device-resident by default: the forward gathers only the
sample positions for the LM head and draws with the keyed
``(seed, req_id, purpose, position)`` uniforms, so each iteration brings
back int32 ids only. ``device_sampling=False`` keeps the host sampler (the
oracle path).

With ``spec`` (a ``repro_torch.spec.SpecConfig``) a row that has a nested
prefix row within ``spec.draft_rank`` is served by nested self-speculative
decoding (``repro_torch.spec.SpecDecoder``): the prefix row drafts up to
``spec_len`` tokens a round and the full row verifies them in one
flat-token forward. Per-request override via ``Request.spec_len``.

With ``lookahead`` (or ``REPRO_ASYNC=1``) and device sampling, a row runs
the one-iteration lookahead pipeline: iteration i+1 is planned and queued
on the card from speculatively advanced host state before iteration i's
tokens are read, and a lost speculation rolls the host state back for a
replan. ``serve_session`` serves a live ``serving.session.StreamSession``:
requests arrive on an event loop, tokens stream back as they commit, and
clients may cancel.

The drain engine (``mode="drain"``, and ``auto`` for every family the
paged path does not cover: the recurrent rwkv6 and zamba2, MLA's
minicpm3, and the audio and vision families, whose requests are text
only, so their cross blocks are skipped) serves static
batches of at most ``max_batch`` requests a budget row, prompts padded to
the batch's longest, through the contiguous ``prefill``/``decode_step``
and one sampling call a step over the last position's logits.

The live telemetry plane (``repro_torch.obs``) hangs off the loops as in
the reference: ``registry`` (a ``MetricsRegistry``) takes the serving
counters, cache and queue gauges each iteration; ``watchdog`` (a
``Watchdog``) is ticked once an iteration or speculative round and writes
a postmortem bundle when a rule fires; ``costaudit`` (a
``CostModelAudit``, or True to build one on the engine's cost table)
holds each (row, width bucket)'s measured dispatch time against the
analytic decode bytes; ``statusz()`` is the live snapshot the status
server and the bundles serve. None of it touches a token.

This is the JAX package's engine, ported plan for plan: operand layouts,
width buckets and event order match it, so the two engines emit identical
token streams, with or without lookahead and with or without the
telemetry plane.
"""
from __future__ import annotations

import os
import threading
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import flexrank as FR
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.obs import CAT_ITER, CAT_SCHED, make_tracer, profiling
from repro_torch.serving import device_sampling as dsamp
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.kv_cache import CacheOOM, PagedKVCache
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.sampling import DRAW_TARGET, SamplerState
from repro_torch.serving.scheduler import (BudgetRouter, Request, Result,
                                           Scheduler, Sequence)

__all__ = ["ElasticEngine", "Request", "Result", "CacheOOM"]


class _ImmediateLog:
    """Plan log of the synchronous engine: every emission fires the moment
    planning records it. ``emit``/``finish``/``cancel_finish`` are the
    surface the planner writes against; the pipelined engine swaps in
    ``_DeferredLog`` and nothing in the planner changes."""

    deferred = False

    def __init__(self, engine, metrics, results):
        self.engine = engine
        self.metrics = metrics
        self.results = results

    def emit(self, fn, *args, **kw):
        fn(*args, **kw)

    def finish(self, seq):
        self.engine._finish(seq, self.metrics, self.results)

    def cancel_finish(self, seq):
        self.engine._finish_cancelled(seq, self.metrics, self.results)


class _DeferredLog:
    """Plan log of the pipelined engine: emissions buffer as
    ``(fn, args, kwargs)``, every argument captured by value at plan time,
    and fire in plan order when the iteration commits. A rolled-back plan's
    log is dropped whole, so no metric, trace event, result or stream
    emission of an abandoned speculation escapes. Deferred finishes read
    the sequence's ``generated`` list at flush time, after the commit
    patched the plan's placeholder tokens with the sampled values."""

    deferred = True

    def __init__(self, engine, metrics, results):
        self.engine = engine
        self.metrics = metrics
        self.results = results
        self._buf: list = []

    def emit(self, fn, *args, **kw):
        self._buf.append((fn, args, kw))

    def finish(self, seq):
        self._buf.append((self.engine._finish,
                          (seq, self.metrics, self.results), {}))

    def cancel_finish(self, seq):
        self._buf.append((self.engine._finish_cancelled,
                          (seq, self.metrics, self.results), {}))

    def flush(self):
        buf, self._buf = self._buf, []
        for fn, args, kw in buf:
            fn(*args, **kw)


class _MixedPlan:
    """One mixed iteration's decision record: what the planner decided
    (decode slots, prompt chunks, sample rows), the patch lists the
    pipelined commit uses to swap the sampled values in for the
    placeholders its predicted advance wrote, the deferred emissions
    (``plog``), the admissions the commit re-probes for prefix-hit drift,
    and the iteration's timing. ``tokens_dev`` is the dispatch's (S,) token
    vector on the engine's device; ``tokens_host`` the host tensor its copy
    lands in, ready once ``ready`` (a CUDA event, None on the CPU) has
    passed; ``sampled`` the committed numpy values."""

    __slots__ = ("plog", "empty", "decode_slots", "decode_seqs", "chunks",
                 "sample_ids", "metas", "finish_rows", "gen_patches",
                 "feed_rows", "admissions", "cancel_cursor", "total_chunk",
                 "host_s", "commit_s", "sync_s", "overlap_s",
                 "t_enqueue", "t_sync_end", "tokens_dev", "tokens_host",
                 "ready", "sampled")

    def __init__(self, plog):
        self.plog = plog
        self.empty = True
        self.decode_slots: list = []
        self.decode_seqs: list = []
        self.chunks: list = []
        self.sample_ids: list = []
        self.metas: list = []
        self.finish_rows: dict = {}
        self.gen_patches: list = []     # (seq, generated index, sample row)
        self.feed_rows: dict = {}       # slot -> (seq, sample row)
        self.admissions: list = []      # (seq, prefix-hit tokens at plan)
        self.cancel_cursor = 0
        self.total_chunk = 0
        self.host_s = 0.0
        self.commit_s = 0.0
        self.sync_s = 0.0
        self.overlap_s = 0.0
        self.t_enqueue = 0.0
        self.t_sync_end = 0.0
        self.tokens_dev = None
        self.tokens_host = None
        self.ready = None
        self.sampled = None


class ElasticEngine:
    def __init__(self, cfg: ModelConfig, params_fact, table, infos, *,
                 max_batch: int = 8, max_len: int = 256,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 prefill_order: str = "fifo",
                 spec=None,
                 device_sampling: Optional[bool] = None,
                 prefix_cache: Optional[bool] = None,
                 lookahead: Optional[bool] = None,
                 tracer=None, registry=None,
                 watchdog=None, costaudit=None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params_fact = cm.tree_map(lambda t: t.to(self.device),
                                       params_fact)
        self.table = table
        self.infos = infos
        self.max_batch = max_batch
        self.max_len = max_len
        self.block_size = block_size
        self.num_blocks = num_blocks
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        # prefill_chunk=None serves through the same mixed loop with a chunk
        # the size of the longest possible prompt
        self._chunk = prefill_chunk if prefill_chunk is not None else max_len
        if prefill_order not in ("fifo", "srpf"):
            raise ValueError(f"unknown prefill_order {prefill_order!r}")
        self.prefill_order = prefill_order
        if token_budget is None and prefill_chunk is not None:
            token_budget = max_batch + prefill_chunk
        if token_budget is not None and token_budget < max_batch + 1:
            raise ValueError(
                f"token_budget {token_budget} leaves no room for prefill "
                f"beside {max_batch} decode slots (need >= max_batch + 1)")
        self.token_budget = token_budget
        self._mixed_budget = (token_budget if token_budget is not None
                              else max_batch + self._chunk)
        self.spec = spec
        # REPRO_DEVICE_SAMPLING / REPRO_PREFIX_CACHE flip the defaults, as
        # in the JAX engine
        if device_sampling is None:
            env = os.environ.get("REPRO_DEVICE_SAMPLING")
            device_sampling = env != "0" if env is not None else True
        self.device_sampling = bool(device_sampling)
        if prefix_cache is None:
            prefix_cache = os.environ.get("REPRO_PREFIX_CACHE", "0") == "1"
        self.prefix_cache = bool(prefix_cache)
        # one-iteration lookahead: plan and queue iteration i+1 from
        # speculatively advanced host state before reading iteration i's
        # tokens. It needs device sampling (the host sampler reads logits
        # between dispatch and commit, the very wait the pipeline removes);
        # an engine without it runs the serial loop. REPRO_ASYNC flips the
        # default, as in the JAX engine.
        if lookahead is None:
            lookahead = os.environ.get("REPRO_ASYNC", "0") == "1"
        self.lookahead = bool(lookahead)
        # fault injection for the rollback tests: called at every
        # speculative plan's validation with the committed iteration count;
        # True forces a rollback and replan (the replan is not validated)
        self.lookahead_fault = None
        # client cancellations: a monotone, lock-guarded log of req_ids.
        # A plan records the log length it consumed; the committed cursor
        # advances only when that plan commits, so a rolled-back plan's
        # replan applies the same entries again
        self._cancel_list: List[int] = []
        self._cancel_lock = threading.Lock()
        self._cancel_cursor = 0
        self._seq_index: Dict[int, Sequence] = {}
        self._session = None
        self._iterations = 0
        # observability (repro_torch.obs): ``tracer`` collects span and
        # instant events for Chrome-trace/JSONL export (None resolves via
        # REPRO_TRACE to the no-op NULL_TRACER); ``registry`` keeps
        # Prometheus-exportable counters, gauges and histograms (None turns
        # that path off)
        self.tracer = tracer if tracer is not None else make_tracer()
        self.registry = registry
        self._deployed: Dict[int, object] = {}
        # seconds each budget row's GAR deploy took (device time included)
        self.deploy_seconds: Dict[int, float] = {}
        self._cost_table = np.asarray(
            [FR.deployed_param_count(cfg, infos, table, k)
             for k in range(table.table.shape[0])], np.int64)
        self.router = BudgetRouter(self._cost_table)
        # live telemetry plane: ``watchdog`` is ticked once an engine
        # iteration with the loop's heartbeat and captures a postmortem
        # bundle when a rule fires; ``costaudit`` accumulates measured
        # dispatch seconds per (row, width bucket) against the analytic
        # cost model (an instance, or True to build one on this engine's
        # cost table)
        self.watchdog = watchdog
        if costaudit is True:
            from repro_torch.obs import CostModelAudit
            costaudit = CostModelAudit(cfg, self._cost_table,
                                       max_len=max_len, registry=registry)
        self.costaudit = costaudit
        # live-state handle for ``statusz()``: the serving loops park their
        # scheduler, cache and batcher here so the status server can
        # snapshot them from its own thread mid-run
        self._live: Dict[str, object] = {}
        self.last_metrics: Optional[ServingMetrics] = None

    # ------------------------------------------------------------ routing

    def _budget_row(self, budget: float) -> int:
        return self.router.route(budget)

    def _realize(self, row: int):
        """GAR-deploy the budget row (cached), on the engine's device."""
        if row not in self._deployed:
            t0 = time.perf_counter()
            self._deployed[row] = FR.gar_deploy(
                self.params_fact, self.cfg, self.infos, self.table, row)
            self._sync()
            self.deploy_seconds[row] = time.perf_counter() - t0
        return self._deployed[row]

    def spec_draft_row(self, row: int) -> Optional[int]:
        """Draft row for serving ``row`` speculatively: the largest nested
        prefix row within ``spec.draft_rank`` of the full model, strictly
        below the target. ``None`` (speculation off for this row) when spec
        is unset or no smaller prefix row fits."""
        if self.spec is None:
            return None
        return FR.nested_prefix_row(self.table, row, self.spec.draft_rank,
                                    self._cost_table)

    def cancel(self, req_id: int) -> None:
        """Best-effort client cancellation, applied at the next plan
        boundary: a waiting request leaves its queue, a seated one frees its
        slot and blocks, and an in-flight lookahead that assumed the request
        rolls back. Tokens generated before it takes effect stay delivered;
        the request finishes with ``Result.cancelled = True``. Thread-safe;
        unknown or finished ids are ignored."""
        with self._cancel_lock:
            self._cancel_list.append(int(req_id))

    # ----------------------------------------------------------- generate

    def generate(self, requests: List[Request], *, mode: str = "auto",
                 metrics: Optional[ServingMetrics] = None) -> List[Result]:
        """Serve ``requests`` to completion. ``mode``: 'continuous' (paged
        cache + iteration-level batching), 'drain' (static batches through
        the contiguous prefill/decode), or 'auto' (continuous whenever the
        family supports it, else drain)."""
        if mode not in ("auto", "continuous", "drain"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "auto":
            mode = "continuous" if tfm.paged_compatible(self.cfg) else "drain"
        if mode == "drain":
            with torch.no_grad():
                return self.generate_drain(requests, metrics=metrics)
        if not tfm.paged_compatible(self.cfg):
            raise ValueError(
                f"{self.cfg.name}: paged continuous batching covers "
                "attn/attn_dense stacks only; use mode='drain' or 'auto'")
        with torch.no_grad():
            return self._generate_continuous(requests, metrics=metrics)

    def serve_session(self, session, *,
                      metrics: Optional[ServingMetrics] = None,
                      idle_wait_s: float = 0.02) -> Dict[int, Result]:
        """Serve a live ``serving.session.StreamSession`` until it closes:
        requests arrive open-loop on the session's event loop, are drained
        into a persistent scheduler at commit boundaries, and every
        committed token streams back through the submitting client's
        ``StreamHandle`` as it lands. Runs on the caller's (worker) thread,
        whose grad mode is its own, so it enters ``torch.no_grad()`` here;
        returns the req_id -> Result map once the session has closed and
        the last request drained."""
        metrics = metrics or ServingMetrics(tracer=self.tracer,
                                            registry=self.registry)
        self.last_metrics = metrics
        sched = Scheduler(self.router, tracer=self.tracer)
        self._bind_live(sched, metrics)
        with self._cancel_lock:
            self._cancel_list = []
        self._cancel_cursor = 0
        self._seq_index = {}
        results: Dict[int, Result] = {}
        self._session = session
        session.bind(self)
        try:
            with torch.no_grad():
                while True:
                    self._drain_intake(sched, metrics)
                    if not sched.has_waiting():
                        if session.closed:
                            break
                        session.wait_for_work(idle_wait_s)
                        continue
                    self._serve_row(sched.next_row(), sched, metrics,
                                    results)
        finally:
            self._session = None
            session.mark_done()
        return results

    def _bind_live(self, sched: Scheduler, metrics: ServingMetrics) -> None:
        """Park a serve's scheduler and metrics for ``statusz()`` and hand
        the watchdog its postmortem sources."""
        self._live = {"sched": sched, "metrics": metrics}
        if self.watchdog is not None:
            self.watchdog.bind(
                tracer=self.tracer,
                trace_fn=(self.tracer.to_chrome if self.tracer.enabled
                          else None),
                state_fn=self.statusz, registry=self.registry)

    def _drain_intake(self, sched: Scheduler, metrics: ServingMetrics
                      ) -> None:
        """Pull newly submitted session requests into the scheduler. Called
        at commit boundaries and in the idle loop only, never inside a
        speculative plan, so a rollback's snapshot never races an
        arrival."""
        if self._session is None:
            return
        for request, handle in self._session.drain_new():
            if len(request.prompt) == 0:
                raise ValueError("empty prompt")
            seq = sched.submit(request)
            metrics.on_submit(seq.req_id)
            self._seq_index[seq.req_id] = seq
            self._session.register(handle, seq.req_id)

    def _serve_row(self, row: int, sched: Scheduler, metrics: ServingMetrics,
                   results: Dict[int, Result]) -> None:
        """Serve one budget row until its queue drains: speculatively when
        the row has a draft row, else through the mixed loop."""
        draft_row = self.spec_draft_row(row)
        if draft_row is not None:
            from repro_torch.spec import SpecDecoder
            SpecDecoder(self, row=row, draft_row=draft_row, spec=self.spec,
                        sched=sched, metrics=metrics,
                        results=results).serve()
        else:
            self._serve_row_mixed(row, sched, metrics, results)

    def _generate_continuous(self, requests: List[Request], *,
                             metrics: Optional[ServingMetrics] = None
                             ) -> List[Result]:
        metrics = metrics or ServingMetrics(tracer=self.tracer,
                                            registry=self.registry)
        self.last_metrics = metrics
        sched = Scheduler(self.router, tracer=self.tracer)
        self._bind_live(sched, metrics)
        with self._cancel_lock:
            self._cancel_list = []
        self._cancel_cursor = 0
        self._seq_index = {}
        submitted = []
        for r in requests:
            if len(r.prompt) == 0:
                raise ValueError("empty prompt")
            seq = sched.submit(r)
            metrics.on_submit(seq.req_id)
            self._seq_index[seq.req_id] = seq
            submitted.append(seq)
        results: Dict[int, Result] = {}
        if self.prefill_chunk is None and self.spec is None:
            warnings.warn(
                "continuous serving without prefill_chunk runs mixed "
                "iterations with a full-prompt-sized chunk (set "
                "prefill_chunk explicitly to silence this)",
                DeprecationWarning, stacklevel=3)
        while sched.has_waiting():
            self._serve_row(sched.next_row(), sched, metrics, results)
        return [results[s.req_id] for s in submitted]

    def _finish(self, seq: Sequence, metrics, results, *,
                cancelled: bool = False) -> None:
        """Close out a request: its Result holds the prompt and what was
        generated, and goes to the session's stream when one is served."""
        if cancelled:
            metrics.on_cancel(seq.req_id)
        else:
            metrics.on_finish(seq.req_id)
        tokens = np.concatenate([np.asarray(seq.request.prompt, np.int32),
                                 np.asarray(seq.generated, np.int32)])
        results[seq.req_id] = Result(
            tokens=tokens, budget_row=seq.row,
            deployed_params=self.router.deployed_params(seq.row),
            ttft_s=metrics.traces[seq.req_id].ttft, cancelled=cancelled)
        seq.state = "finished"
        if self._session is not None:
            self._session.finish(seq.req_id, results[seq.req_id])

    def _finish_cancelled(self, seq: Sequence, metrics, results) -> None:
        """Close out a cancelled request: the planner already unwound its
        slot or queue position; the Result keeps the prompt and whatever
        was generated (and streamed) before the cancel took effect."""
        self._finish(seq, metrics, results, cancelled=True)

    def _block_holders(self, cache, batcher):
        """Seated sequences that actually own blocks — the only useful
        victims (evicting a zero-block mid-prefill seat frees nothing)."""
        return [s for s in batcher.active_sequences()
                if cache.slots[batcher.slot_of(s)].blocks]

    def _evict(self, victim, sched, cache, batcher, metrics,
               reason: str = "cache_pressure", plog=None) -> int:
        """Preempt one sequence: free its slot + blocks, re-queue at the row
        front for recompute. Returns the vacated slot. ``reason`` is the
        trace's why: ``cache_pressure`` (a decoding slot could not reserve
        its next token), ``prefill_pinned`` (half-prefilled sequences held
        every block) or ``rollback_recompute`` (an abandoned speculative
        dispatch wrote K/V into a block this sequence holds after the
        rollback). With a ``plog`` the metric and trace emissions wait for
        the plan's commit; the state change is immediate either way."""
        vslot = batcher.slot_of(victim)
        vstate = victim.state                # requeue resets it to waiting
        batcher.leave(vslot)
        cache.free_slot(vslot)
        sched.requeue_front(victim)
        emit = (plog.emit if plog is not None
                else lambda fn, *a, **kw: fn(*a, **kw))
        emit(metrics.on_preempt, victim.req_id)
        if self.tracer.enabled:
            emit(self.tracer.instant,
                 "preempt", CAT_SCHED,
                 args={"req": victim.req_id, "slot": vslot, "reason": reason,
                       "policy": "youngest_first", "state": vstate})
        return vslot

    def _reserve_or_preempt(self, sched, cache, batcher, metrics, plog=None):
        """Reserve next-token room for every decoding slot; under cache
        pressure evict the youngest block-holding sequence (decoding OR
        mid-prefill) until the rest fit."""
        for slot in batcher.decode_slots():
            while (cache.token_append_needs_block(slot)
                   and cache.allocator.free_count == 0):
                victim = Scheduler.pick_victim(
                    self._block_holders(cache, batcher))
                if (victim is batcher.slots[slot]
                        and batcher.num_active == 1):
                    raise CacheOOM(
                        f"sequence {victim.req_id} alone exceeds the pool")
                vslot = self._evict(victim, sched, cache, batcher, metrics,
                                    reason="cache_pressure", plog=plog)
                if vslot == slot:
                    break                      # the appender itself was evicted
            seq = batcher.slots[slot]
            if seq is not None and seq.state == "decoding":
                cache.append_token(slot)

    # -------------------------------------------- live telemetry plane

    def _iteration_stats(self, sched, cache, metrics: ServingMetrics) -> None:
        """The registry's per-iteration cache and queue gauges (a mixed
        iteration or a speculative round); nothing without a registry."""
        if self.registry is not None:
            metrics.on_cache_stats(cache.allocator.free_count,
                                   cache.allocator.fragmentation(),
                                   prefix=cache.stats)
            metrics.on_queue_depths(
                {r: len(q) for r, q in sched.queues.items()})

    def _watchdog_tick(self, metrics: ServingMetrics, cache,
                       *, decoding: bool) -> None:
        """One per-iteration watchdog evaluation with the loop's cheap
        heartbeat signals (see obs/watchdog.py for the rules)."""
        self.watchdog.tick(
            progress_tokens=metrics.generated_tokens + metrics.prefill_tokens,
            decode_tokens=metrics.generated_tokens,
            decoding=decoding,
            metrics=metrics,
            fragmentation=cache.allocator.fragmentation(),
            free_blocks=cache.allocator.free_count,
            spec_accept_ewma=metrics.accept_ewma,
            spec_rounds=metrics.spec_rounds,
            prefix_stats=cache.stats if cache.prefix_cache else None)

    def statusz(self) -> dict:
        """Live engine snapshot for the ``/statusz`` endpoint and the
        watchdog's postmortem ``state.json``: per-request lifecycle
        states, per-row queue depths, KV occupancy/fragmentation, prefix
        cache hit rate, and adaptive-k state. Built to be called from the
        status-server thread while the engine runs: live structures are
        read best-effort (list-copied before iteration; a race that still
        slips through marks the snapshot ``partial`` instead of failing
        the scrape)."""
        out: Dict[str, object] = {
            "engine": {
                "arch": self.cfg.name,
                "max_batch": self.max_batch, "max_len": self.max_len,
                "block_size": self.block_size,
                "prefill_chunk": self.prefill_chunk,
                "token_budget": self.token_budget,
                "device_sampling": self.device_sampling,
                "prefix_cache": self.prefix_cache,
                "rows": len(self._cost_table),
                "row_params": self._cost_table.tolist(),
                "spec": None if self.spec is None else {
                    "draft_rank": self.spec.draft_rank,
                    "spec_len": self.spec.spec_len,
                    "adaptive_k": self.spec.adaptive_k},
            },
            "iterations": self._iterations,
        }
        try:
            live = dict(self._live)
            metrics = live.get("metrics") or self.last_metrics
            if metrics is not None:
                reqs = {}
                for req_id, tr in list(metrics.traces.items()):
                    state = ("finished" if tr.finish_t is not None
                             else "decoding" if tr.first_token_t is not None
                             else "prefilling" if tr.admit_t is not None
                             else "waiting")
                    reqs[req_id] = {
                        "state": state, "new_tokens": tr.new_tokens,
                        "preemptions": tr.preemptions,
                        "prefix_hit_tokens": tr.prefix_hit_tokens,
                        "ttft_s": tr.ttft}
                out["requests"] = reqs
                out["progress"] = {
                    "generated_tokens": metrics.generated_tokens,
                    "prefill_tokens": metrics.prefill_tokens,
                    "preemptions": metrics.preemptions,
                    "spec_rounds": metrics.spec_rounds,
                    "spec_accept_ewma": metrics.accept_ewma}
            sched = live.get("sched")
            if sched is not None:
                out["queues"] = {row: len(q)
                                 for row, q in list(sched.queues.items())}
            cache = live.get("cache")
            if cache is not None:
                out["serving_row"] = live.get("row")
                out["speculating"] = live.get("spec")
                out["kv"] = cache.statusz()
            batcher = live.get("batcher")
            if batcher is not None:
                out["adaptive_k"] = {
                    s.req_id: {"k": s.spec_k,
                               "accept_ewma": s.spec_accept_ewma}
                    for s in list(batcher.active_sequences())}
        except Exception as e:       # racing the engine thread; keep what
            out["partial"] = repr(e)  # rendered and say so
        if self.watchdog is not None:
            out["watchdog"] = self.watchdog.statusz()
        if self.costaudit is not None:
            out["costaudit"] = self.costaudit.statusz()
        return out

    # ------------------------------ chunked prefill / mixed iterations

    def _bucket_tokens(self, used: int, budget: Optional[int] = None) -> int:
        """Flat-batch width bucket: smallest power of two >= used (floor 8),
        capped at the token budget (the JAX engine's compile buckets)."""
        if budget is None:
            budget = self._mixed_budget
        t = 8
        while t < used:
            t *= 2
        return min(t, max(budget, used))

    def _serve_row_mixed(self, row: int, sched: Scheduler,
                         metrics: ServingMetrics,
                         results: Dict[int, Result]) -> None:
        """One budget row's chunked-prefill loop over a fresh paged cache.
        Two loops share one planner (``_plan_iteration``): the serial
        loop (plan, dispatch, sync, commit) and, with ``lookahead`` and
        device sampling, the one-iteration pipeline."""
        params = self._realize(row)
        cache = PagedKVCache(self.cfg, max_batch=self.max_batch,
                             max_len=self.max_len, block_size=self.block_size,
                             num_blocks=self.num_blocks,
                             prefix_cache=self.prefix_cache,
                             device=self.device)
        cache.tracer = self.tracer
        batcher = ContinuousBatcher(self.max_batch)
        self._live.update(row=row, cache=cache, batcher=batcher, spec=False)
        drive = (self._serve_row_pipelined
                 if self.lookahead and self.device_sampling
                 else self._serve_row_sync)
        drive(row, params, sched, cache, batcher, metrics, results)

    def _apply_cancellations(self, sched, cache, batcher, plog) -> int:
        """Apply every cancellation entry past the committed cursor: a
        waiting request leaves its row queue, a seated one frees its slot
        and blocks; unknown or already finished ids are ignored. Entries
        apply idempotently: a deferred (speculative) plan's consumption
        commits with the plan, so a rolled-back or still in-flight plan's
        entries are applied again by the next plan and no-op the second
        time. Returns the log length consumed (the plan's
        ``cancel_cursor``)."""
        with self._cancel_lock:
            n = len(self._cancel_list)
            entries = self._cancel_list[self._cancel_cursor: n]
        for req_id in entries:
            seq = self._seq_index.get(req_id)
            if seq is None or seq.state == "finished":
                continue
            if sched.remove_waiting(seq):
                plog.cancel_finish(seq)
                continue
            for slot, s in enumerate(batcher.slots):
                if s is seq:
                    batcher.leave(slot)
                    cache.free_slot(slot)
                    plog.cancel_finish(seq)
                    break
        if not plog.deferred:
            self._cancel_cursor = n
        return n

    def _plan_iteration(self, row: int, sched, cache, batcher,
                        metrics, plog) -> _MixedPlan:
        """One mixed iteration's scheduling half, shared by both loops:
        apply cancellations, seat waiting requests (probing the prefix
        cache), reserve decode room (preempting under pressure), plan the
        FIFO prompt chunks, and pick the sample rows. Emissions go through
        ``plog``; state changes apply at once, and the pipelined loop
        snapshots around this call to roll them back. Returns an ``empty``
        plan when the row drained."""
        tr = self.tracer
        plan = _MixedPlan(plog)
        while True:
            plan.cancel_cursor = self._apply_cancellations(
                sched, cache, batcher, plog)
            for slot in batcher.free_slots():
                if not sched.has_waiting(row):
                    break
                seq = sched.pop(row)
                plog.emit(metrics.on_admit, seq.req_id)
                if tr.enabled:
                    plog.emit(tr.instant, "admit", CAT_SCHED,
                              args={"req": seq.req_id, "row": row,
                                    "slot": slot, "reason": "slot_free",
                                    "attempt": seq.admissions})
                if seq.request.max_new_tokens <= 0:
                    plog.finish(seq)
                    continue
                if seq.prompt_len > self.max_len:
                    raise CacheOOM(f"sequence of {seq.prompt_len} tokens "
                                   f"exceeds max_len {self.max_len}")
                cache.open_slot(slot)
                hit = cache.probe_prefix(slot, seq.request.prompt)
                if hit:
                    seq.prefill_pos = hit
                    plog.emit(metrics.on_prefix_hit, seq.req_id, hit,
                              cache.cached_blocks)
                plan.admissions.append((seq, hit))
                batcher.seat_prefill(slot, seq)
            if batcher.num_active == 0:
                return plan                  # row drained (all slots free)

            # decode priority: reserve next-token room before any prefill
            self._reserve_or_preempt(sched, cache, batcher, metrics,
                                     plog=plog)
            decode_slots = batcher.decode_slots()

            budget_left = self._mixed_budget - len(decode_slots)
            prefilling = [batcher.slots[s] for s in batcher.prefill_slots()]
            chunks = []                      # (slot, seq, start, n)
            for seq, want in Scheduler.plan_prefill_chunks(
                    prefilling, budget_left, self._chunk,
                    order=self.prefill_order):
                slot = batcher.slot_of(seq)
                got = cache.extend_slot(slot, want, clip=True)
                if got:
                    chunks.append((slot, seq, seq.prefill_pos, got))

            if not decode_slots and not chunks:
                if batcher.num_active == 0:
                    continue                 # everyone was preempted
                self._unstick(sched, cache, batcher, metrics, plog=plog)
                continue
            break

        # sample plan: decode slots and finishing chunks only
        sample_ids, metas = [], []
        for i, slot in enumerate(decode_slots):
            seq = batcher.slots[slot]
            sample_ids.append(i)
            metas.append((seq.sampler, DRAW_TARGET,
                          seq.prompt_len + len(seq.generated)))
            plan.decode_seqs.append(seq)
        flat = len(decode_slots)
        finish_rows: Dict[int, int] = {}
        for slot, seq, start, n in chunks:
            if start + n == seq.prompt_len:
                finish_rows[slot] = len(sample_ids)
                sample_ids.append(flat + n - 1)
                metas.append((seq.sampler, DRAW_TARGET, seq.prompt_len))
            flat += n
        plan.empty = False
        plan.decode_slots = decode_slots
        plan.chunks = chunks
        plan.sample_ids = sample_ids
        plan.metas = metas
        plan.finish_rows = finish_rows
        plan.total_chunk = sum(n for _, _, _, n in chunks)
        return plan

    def _serve_row_sync(self, row: int, params, sched, cache, batcher,
                        metrics: ServingMetrics,
                        results: Dict[int, Result]) -> None:
        """Plan, dispatch, sync, commit — one iteration at a time."""
        tr = self.tracer
        plog = _ImmediateLog(self, metrics, results)
        while True:
            it0 = metrics.now()
            self._drain_intake(sched, metrics)
            plan = self._plan_iteration(row, sched, cache, batcher,
                                        metrics, plog)
            if plan.empty:
                break
            decode_slots, chunks = plan.decode_slots, plan.chunks
            disp0 = metrics.now()
            if tr.enabled:
                tr.complete("plan", CAT_ITER, it0, disp0,
                            args={"decode": len(decode_slots),
                                  "chunks": len(chunks)})
            if self.device_sampling:
                logits = None
                sampled = self._dispatch_mixed(params, cache, batcher,
                                               decode_slots, chunks,
                                               plan.sample_ids, plan.metas)
            else:
                logits = self._dispatch_mixed(params, cache, batcher,
                                              decode_slots, chunks,
                                              plan.sample_ids)
                # greedy fast path: argmax only the gathered sample rows
                sampled = torch.argmax(logits[0], dim=-1).to(
                    torch.int32).cpu().numpy()
            disp_s = metrics.now() - disp0

            # commit decodes first: `advance` must only see sequences that
            # actually decoded this iteration, not freshly flipped ones
            sampled_b = np.zeros(self.max_batch, np.int32)
            for i, slot in enumerate(decode_slots):
                seq = batcher.slots[slot]
                if logits is not None and not seq.sampler.greedy:
                    sampled[i] = seq.sampler.sample(
                        logits[0, i].cpu().numpy())
                sampled_b[slot] = sampled[i]
                metrics.on_token(seq.req_id)
                if self._session is not None:
                    self._session.emit(seq.req_id, len(seq.generated),
                                       int(sampled[i]))
            for slot in batcher.advance(sampled_b):
                seq = batcher.leave(slot)
                cache.free_slot(slot)
                self._finish(seq, metrics, results)

            # commit prefill chunks; a finishing chunk's first generated
            # token sits at its reserved sample row
            total_chunk = 0
            for slot, seq, start, n in chunks:
                seq.prefill_pos = start + n
                total_chunk += n
                metrics.on_prefill_chunk(n)
                cache.register_prefix(slot, seq.request.prompt,
                                      seq.prefill_pos)
                if seq.prefill_pos == seq.prompt_len:
                    metrics.on_prefill_end(seq.req_id)
                    ri = plan.finish_rows[slot]
                    first = int(sampled[ri])
                    if logits is not None and not seq.sampler.greedy:
                        first = seq.sampler.sample(
                            logits[0, ri].cpu().numpy())
                    if self._session is not None:
                        self._session.emit(seq.req_id, len(seq.generated),
                                           first)
                    seq.generated.append(first)
                    metrics.on_first_token(seq.req_id)
                    if seq.done:             # max_new_tokens == 1
                        batcher.leave(slot)
                        cache.free_slot(slot)
                        self._finish(seq, metrics, results)
                    else:
                        batcher.to_decoding(slot, first)
            metrics.on_mixed_step(len(decode_slots), total_chunk,
                                  cache.occupancy())
            it1 = metrics.now()
            metrics.on_iteration_timing(disp_s, it1 - it0 - disp_s)
            if tr.enabled:
                tr.complete("dispatch", CAT_ITER, disp0, disp0 + disp_s,
                            args={"sample_rows": len(plan.sample_ids)})
                tr.complete("commit", CAT_ITER, disp0 + disp_s, it1,
                            args={"decode": len(decode_slots),
                                  "prefill": total_chunk})
            self._iteration_stats(sched, cache, metrics)
            self._iterations += 1
            if self.costaudit is not None:
                self.costaudit.observe(
                    row,
                    self._bucket_tokens(len(decode_slots) + total_chunk),
                    disp_s)
            if self.watchdog is not None:
                self._watchdog_tick(metrics, cache,
                                    decoding=bool(decode_slots))

    # ------------------------------------- one-iteration-lookahead pipeline

    def _session_emit(self, seq: Sequence, idx: int) -> None:
        """Deferred per-token stream emission: runs at the owning plan's
        commit, after ``_commit_apply`` patched the placeholder at
        ``generated[idx]`` with the sampled value."""
        if self._session is not None:
            self._session.emit(seq.req_id, idx, int(seq.generated[idx]))

    def _advance_predicted(self, plan: _MixedPlan, cache, batcher,
                           metrics) -> None:
        """Apply the planned iteration's commit to host state now, with
        placeholder token 0 wherever a sampled value goes, and record the
        patch lists for the real commit. The prediction is exact in control
        flow: finishes count tokens (``max_new_tokens``; no stop tokens),
        preemption and block accounting never depend on token values, and
        prefix registration hashes prompt tokens only."""
        plog = plan.plog
        sampled_b = np.zeros(self.max_batch, np.int32)
        for i, slot in enumerate(plan.decode_slots):
            seq = plan.decode_seqs[i]
            plan.gen_patches.append((seq, len(seq.generated), i))
            plog.emit(metrics.on_token, seq.req_id)
            plog.emit(self._session_emit, seq, len(seq.generated))
        for slot in batcher.advance(sampled_b):
            seq = batcher.leave(slot)
            cache.free_slot(slot)
            plog.finish(seq)
        # surviving decode slots were fed placeholder 0 by ``advance``: the
        # next dispatch patches its copy from this iteration's device token
        # vector (``_feed_fixups``) and the commit feeds the real value
        for i, slot in enumerate(plan.decode_slots):
            if batcher.slots[slot] is plan.decode_seqs[i]:
                plan.feed_rows[slot] = (plan.decode_seqs[i], i)

        for slot, seq, start, n in plan.chunks:
            seq.prefill_pos = start + n
            plog.emit(metrics.on_prefill_chunk, n)
            # registration hashes prompt tokens, so it is exact at plan
            # time; the block's K/V lands when the already queued dispatch
            # runs, before any later dispatch can read it through a hit
            cache.register_prefix(slot, seq.request.prompt, seq.prefill_pos)
            if seq.prefill_pos == seq.prompt_len:
                plog.emit(metrics.on_prefill_end, seq.req_id)
                ri = plan.finish_rows[slot]
                idx = len(seq.generated)
                plan.gen_patches.append((seq, idx, ri))
                plog.emit(self._session_emit, seq, idx)
                seq.generated.append(0)      # placeholder first token
                plog.emit(metrics.on_first_token, seq.req_id)
                if seq.done:                 # max_new_tokens == 1
                    batcher.leave(slot)
                    cache.free_slot(slot)
                    plog.finish(seq)
                else:
                    batcher.to_decoding(slot, 0)
                    plan.feed_rows[slot] = (seq, ri)
        plog.emit(metrics.on_mixed_step, len(plan.decode_slots),
                  plan.total_chunk, cache.occupancy())

    @staticmethod
    def _feed_fixups(plan: _MixedPlan, pending: _MixedPlan) -> List[tuple]:
        """Token patches for ``plan``'s dispatch: every decode entry whose
        host feed is still ``pending``'s placeholder takes its value from
        ``pending``'s token vector on the device. Returns ``(flat position
        in plan's token batch, sample row in pending's token vector)``
        pairs; decode entries sit at flat positions ``0..len(decode_slots)
        - 1`` in dispatch order."""
        fixups = []
        for i, slot in enumerate(plan.decode_slots):
            pf = pending.feed_rows.get(slot)
            if pf is not None and pf[0] is plan.decode_seqs[i]:
                fixups.append((i, pf[1]))
        return fixups

    def _snapshot_row(self, sched, cache, batcher) -> dict:
        """Host state for one speculative plan: scheduler queues (all rows:
        a cancellation can touch any), cache bookkeeping (pools excluded;
        see ``PagedKVCache.snapshot``), batcher seats, and every reachable
        Sequence's mutable fields."""
        seqs = {s.req_id: s for s in batcher.active_sequences()}
        for q in sched.queues.values():
            for s in q:
                seqs[s.req_id] = s
        return {"sched": sched.snapshot(), "cache": cache.snapshot(),
                "batcher": batcher.snapshot(),
                "seqs": [(s, s.snapshot()) for s in seqs.values()]}

    def _restore_row(self, snap: dict, sched, cache, batcher) -> None:
        sched.restore(snap["sched"])
        cache.restore(snap["cache"])
        batcher.restore(snap["batcher"])
        for s, ss in snap["seqs"]:
            s.restore(ss)

    def _commit_apply(self, plan: _MixedPlan, batcher) -> None:
        """Patch the committed iteration's sampled values into host state:
        ``generated`` placeholders and next-token feeds. Idempotent under
        replay after a rollback restored older state: a patch applies only
        where its placeholder still exists (an index past ``generated``
        means the sequence was reset for recompute; a slot holding another
        sequence means it was unwound)."""
        sampled = plan.sampled
        for seq, idx, row in plan.gen_patches:
            if idx < len(seq.generated):
                seq.generated[idx] = int(sampled[row])
        for slot, (seq, row) in plan.feed_rows.items():
            if batcher.slots[slot] is seq and seq.state == "decoding":
                batcher.feed(slot, int(sampled[row]))

    def _commit_iteration(self, pending: _MixedPlan, batcher,
                          metrics: ServingMetrics) -> None:
        """Read the pending iteration's tokens (the pipeline's only wait
        for the card) and commit it: patch the values in, advance the
        committed cancellation cursor, flush the deferred emissions. On the
        card the wait is for the event recorded after the tokens' copy,
        not for the stream, which already holds the next iteration."""
        t_sync0 = metrics.now()
        if pending.ready is not None:
            pending.ready.synchronize()
        pending.sampled = pending.tokens_host.numpy()
        pending.t_sync_end = metrics.now()
        pending.sync_s = pending.t_sync_end - t_sync0
        pending.overlap_s = max(0.0, t_sync0 - pending.t_enqueue)
        c0 = metrics.now()
        self._commit_apply(pending, batcher)
        self._cancel_cursor = max(self._cancel_cursor, pending.cancel_cursor)
        pending.plog.flush()
        pending.commit_s = metrics.now() - c0

    def _validate_speculation(self, plan: _MixedPlan,
                              cache) -> Optional[str]:
        """Did the just-committed iteration invalidate the in-flight
        speculative plan? Returns a rollback reason or None: forced fault
        injection (the test hook), cancellation entries that arrived after
        the plan consumed the log (rolling back applies them one iteration
        sooner), or prefix-hit drift (an admission that would hit more
        cached prompt blocks if probed now; registration is eager at plan
        time, so drift needs an index change outside the planner)."""
        if (self.lookahead_fault is not None
                and self.lookahead_fault(self._iterations)):
            return "fault_injection"
        with self._cancel_lock:
            n = len(self._cancel_list)
        if n > plan.cancel_cursor:
            return "cancellation"
        for seq, hit in plan.admissions:
            if (seq.state == "prefilling"
                    and cache.peek_prefix(seq.request.prompt) > hit):
                return "prefix_drift"
        return None

    def _rollback(self, snap: dict, touched: List[int],
                  pending: Optional[_MixedPlan], sched, cache, batcher,
                  metrics: ServingMetrics, reason: str) -> None:
        """Unwind a lost speculation: restore the pre-plan snapshot, then
        repair what a restore cannot. The pools change in place and the
        abandoned dispatch stays queued, so it writes K/V at positions past
        each restored ``num_tokens`` and into every block its plan
        allocated (``touched``; a copy-on-write's private copy among them):
        those blocks leave the prefix index, and a restored sequence that
        holds one is evicted for recompute (recompute replays the same
        tokens). Every later write is queued behind the abandoned dispatch
        on the same stream. Finally replay the committed iteration's value
        patches, which the restore undid (its emissions already flushed)."""
        self._restore_row(snap, sched, cache, batcher)
        for b in touched:
            cache._unregister_block(b)
        if touched:
            tset = set(touched)
            for slot, seq in enumerate(batcher.slots):
                st = cache.slots[slot]
                if (seq is not None and st is not None
                        and not tset.isdisjoint(st.blocks)):
                    self._evict(seq, sched, cache, batcher, metrics,
                                reason="rollback_recompute")
        if pending is not None:
            self._commit_apply(pending, batcher)
        metrics.on_rollback(reason)
        if self.tracer.enabled:
            self.tracer.instant(
                "rollback", CAT_ITER,
                args={"reason": reason, "iter": self._iterations,
                      "touched": len(touched)})

    def _finalize_iteration(self, row: int, pending: _MixedPlan, sched,
                            cache, metrics: ServingMetrics) -> None:
        """Per-committed-iteration bookkeeping of the pipelined loop: the
        dispatch/host split (``dispatch_s`` is the visible wait only; host
        work that ran under the in-flight dispatch is ``overlap_s``), trace
        spans anchored at the real enqueue and sync times, registry stats,
        the cost-model audit and the watchdog's heartbeat."""
        tr = self.tracer
        metrics.on_iteration_timing(pending.sync_s,
                                    pending.host_s + pending.commit_s,
                                    overlap_s=pending.overlap_s)
        if tr.enabled:
            tr.complete("dispatch", CAT_ITER, pending.t_enqueue,
                        pending.t_sync_end,
                        args={"sample_rows": len(pending.sample_ids),
                              "overlap_s": round(pending.overlap_s, 6)})
            tr.complete("commit", CAT_ITER, pending.t_sync_end,
                        pending.t_sync_end + pending.commit_s,
                        args={"decode": len(pending.decode_slots),
                              "prefill": pending.total_chunk})
        self._iteration_stats(sched, cache, metrics)
        self._iterations += 1
        if self.costaudit is not None:
            # estimated device time: the visible sync wait plus the host
            # work the dispatch ran under
            self.costaudit.observe(
                row,
                self._bucket_tokens(len(pending.decode_slots)
                                    + pending.total_chunk),
                pending.sync_s + pending.overlap_s)
        if self.watchdog is not None:
            self._watchdog_tick(metrics, cache,
                                decoding=bool(pending.decode_slots))

    def _serve_row_pipelined(self, row: int, params, sched, cache, batcher,
                             metrics: ServingMetrics,
                             results: Dict[int, Result]) -> None:
        """The one-iteration-lookahead loop. Each turn plans and queues
        iteration ``i+1`` from speculatively advanced host state while the
        card still runs iteration ``i``, then reads and commits ``i`` and
        validates the speculation:

            plan i+1  ->  dispatch i+1 (fed i's tokens on the device)
                      ->  predicted advance of host state (placeholders)
                      ->  read + commit i  ->  validate i+1
                      ->  [rollback + replan on a lost race]

        Token streams equal the serial loop's: the planner is shared,
        control flow never depends on token values, and the keyed draws
        depend only on (seed, req, purpose, position). Session arrivals
        are drained at commit boundaries only, after validation, so a
        rollback never loses one."""
        tr = self.tracer
        pending: Optional[_MixedPlan] = None
        snap = None
        while True:
            speculating = pending is not None
            if speculating:
                snap = self._snapshot_row(sched, cache, batcher)
                cache.allocator.begin_alloc_log()
                metrics.on_lookahead()
            plog = _DeferredLog(self, metrics, results)
            t0 = metrics.now()
            plan = self._plan_iteration(row, sched, cache, batcher,
                                        metrics, plog)
            if not plan.empty:
                fixups = (self._feed_fixups(plan, pending)
                          if speculating else [])
                self._dispatch_mixed_async(
                    params, cache, batcher, plan,
                    pending.tokens_dev if speculating else None, fixups)
                plan.t_enqueue = metrics.now()
                self._advance_predicted(plan, cache, batcher, metrics)
            plan.host_s = metrics.now() - t0
            if tr.enabled:
                # every "lookahead" span ends in exactly one
                # "lookahead_commit" or "rollback" instant
                tr.complete("lookahead" if speculating else "plan",
                            CAT_ITER, t0, t0 + plan.host_s,
                            args={"decode": len(plan.decode_slots),
                                  "chunks": len(plan.chunks),
                                  "empty": plan.empty})
            if speculating:
                self._commit_iteration(pending, batcher, metrics)
                reason = self._validate_speculation(plan, cache)
                touched = cache.allocator.end_alloc_log()
                if reason is not None:
                    self._rollback(snap, touched, pending, sched, cache,
                                   batcher, metrics, reason)
                elif tr.enabled:
                    tr.instant("lookahead_commit", CAT_ITER,
                               args={"iter": self._iterations})
                self._finalize_iteration(row, pending, sched, cache, metrics)
                pending = None
                if reason is not None:
                    self._drain_intake(sched, metrics)
                    continue                 # replan from committed state
            self._drain_intake(sched, metrics)
            if plan.empty:
                plan.plog.flush()            # cancel/zero-token finishes
                break
            pending = plan

    # ------------------------------------------------ drain batches

    def generate_drain(self, requests: List[Request], *,
                       metrics: Optional[ServingMetrics] = None
                       ) -> List[Result]:
        """Static batching: group the requests by budget row, pad each
        batch of at most ``max_batch`` into fixed slots, and drain it fully
        before the next starts; prefill is one pass over the padded
        prompts. Results come back in submission order. ``metrics``
        (``last_metrics``) records each request's submit, first token
        (read once a batch) and finish."""
        metrics = metrics or ServingMetrics(tracer=self.tracer,
                                            registry=self.registry)
        self.last_metrics = metrics
        for i in range(len(requests)):
            metrics.on_submit(i)
        out: List[Optional[Result]] = [None] * len(requests)
        rows: Dict[int, List[int]] = {}
        for i, r in enumerate(requests):
            rows.setdefault(self._budget_row(r.budget), []).append(i)
        for row, idxs in rows.items():
            params = self._realize(row)
            results = self._serve_batch(params, row,
                                        [requests[i] for i in idxs], idxs,
                                        metrics)
            for i, res in zip(idxs, results):
                out[i] = res
        return out  # type: ignore[return-value]

    def _serve_batch(self, params, row: int, reqs: List[Request],
                     req_ids: List[int], metrics=None) -> List[Result]:
        """Serve ``reqs`` of one budget row in batches of ``max_batch``.

        The reference's contract, kept as it is: samplers keyed by
        submission index (``req_ids``); prompts padded with zeros to the
        batch's longest, so a shorter prompt's first token is drawn after
        its padding and its stream holds that padding; the draw for step
        ``t`` at position ``len(prompt) + t``; every request of a batch
        decodes the batch's largest ``max_new_tokens``, and its Result
        keeps ``len(prompt) + max_new_tokens`` tokens. With device sampling
        the tokens stay on the engine's device from step to step: the loop
        reads them at the batch's end, and after the first token when
        ``metrics`` records it."""
        results = []
        for start in range(0, len(reqs), self.max_batch):
            chunk = reqs[start: start + self.max_batch]
            ids = req_ids[start: start + len(chunk)]
            b = len(chunk)
            samplers = [SamplerState(r.sampling, rid)
                        for r, rid in zip(chunk, ids)]
            if metrics is not None:
                for rid in ids:
                    metrics.on_admit(rid)
            state = tfm.init_decode_state(self.cfg, b, self.max_len,
                                          dtype=torch.float32,
                                          device=self.device)
            lens = [len(r.prompt) for r in chunk]
            max_new = max(r.max_new_tokens for r in chunk)
            padded = np.zeros((b, max(lens)), np.int32)
            for i, r in enumerate(chunk):
                padded[i, : lens[i]] = r.prompt

            def _next(logits_last, step):
                if self.device_sampling:
                    metas = [(sm, DRAW_TARGET, lens[i] + step)
                             for i, sm in enumerate(samplers)]
                    return self._drain_sample(logits_last,
                                              self._pack_sampling(metas, b)
                                              )[:, None]
                rows_np = logits_last.float().cpu().numpy()
                cur = rows_np.argmax(-1).astype(np.int32)[:, None]
                for i, sm in enumerate(samplers):
                    if not sm.greedy:
                        cur[i, 0] = sm.sample(rows_np[i])
                return self._upload(cur)

            tok = self._upload(padded)
            logits, state = tfm.prefill(params, self.cfg, state, tok)
            cur = _next(logits[:, -1], 0)
            outs = [tok, cur]
            if metrics is not None:
                self._sync()
                for r, rid in zip(chunk, ids):
                    if r.max_new_tokens:
                        metrics.on_first_token(rid, len(r.prompt))
            for t in range(max_new - 1):
                logits, state = tfm.decode_step(params, self.cfg, state, cur)
                cur = _next(logits[:, 0], t + 1)
                outs.append(cur)
                if metrics is not None:
                    metrics.on_decode_step(b, b / self.max_batch)
            seq = torch.cat(outs, dim=1).cpu().numpy()
            dp = self.router.deployed_params(row)
            for i, (r, rid) in enumerate(zip(chunk, ids)):
                results.append(Result(
                    tokens=seq[i, : lens[i] + r.max_new_tokens],
                    budget_row=row, deployed_params=dp))
                if metrics is not None:
                    for _ in range(r.max_new_tokens - 1):
                        metrics.on_token(rid)
                    metrics.on_finish(rid)
        return results

    def _drain_sample(self, rows: torch.Tensor, sampling: Dict
                      ) -> torch.Tensor:
        """One draw per batch row from the last position's logits (B, V):
        the JAX engine's ``_drain_sample_jit``. Returns (B,) int32 on the
        logits' device."""
        return dsamp.sample_rows(rows, sampling)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --------------------------------------------------- operand packing

    @staticmethod
    def _pack_flat(entries, width: int, null_slot: int):
        """Flat-token layout: ``entries`` are (slot, tokens, start) runs —
        ``tokens`` land at positions ``start..start+n-1`` of ``slot``'s
        sequence; pads point ``slot_ids`` at ``null_slot`` (a block-table
        row of null blocks) so their reads/writes never touch a live
        sequence."""
        tok = np.zeros(width, np.int32)
        sid = np.full(width, null_slot, np.int32)
        pos = np.zeros(width, np.int32)
        i = 0
        for slot, toks, start in entries:
            n = len(toks)
            tok[i: i + n] = toks
            sid[i: i + n] = slot
            pos[i: i + n] = np.arange(start, start + n, dtype=np.int32)
            i += n
        return tok, sid, pos

    @staticmethod
    def _bucket_rows(n: int) -> int:
        """Sample-row width bucket (power of two, floor 4)."""
        t = 4
        while t < n:
            t *= 2
        return t

    @staticmethod
    def _pack_sample_ids(sample_ids, width: int) -> np.ndarray:
        """Gather indices padded to ``width``; pads score flat token 0 and
        are discarded host-side (keyed draws are stateless)."""
        out = np.zeros(width, np.int32)
        out[: len(sample_ids)] = sample_ids
        return out

    @staticmethod
    def _sampler_fields(sampler, temp, topk, seed, req, i: int) -> None:
        """Write one non-greedy sampler's knobs into row ``i`` of the packed
        operand arrays. The seed keeps its low 32 bits (int32 view)."""
        temp[i] = sampler.params.temperature
        topk[i] = sampler.params.top_k
        seed[i] = np.int64(sampler.seed).astype(np.uint32).view(np.int32)
        req[i] = sampler.req_id

    def _pack_sampling(self, metas, width: int) -> Dict:
        """Device-sampling operands for ``width`` gathered rows, one
        ``(sampler, purpose, position)`` meta per live row. Greedy rows
        carry temperature 0; ``top_k`` is None when no row truncates, which
        skips the threshold sort. The draw's keys stay on the host, where
        hashing them into uniforms costs no kernel launches
        (``device_sampling.keyed_uniform``)."""
        temp = np.zeros(width, np.float32)
        topk = np.zeros(width, np.int32)
        seed = np.zeros(width, np.int32)
        req = np.zeros(width, np.int32)
        purpose = np.zeros(width, np.int32)
        pos = np.zeros(width, np.int32)
        for i, (sampler, pur, p) in enumerate(metas):
            if not sampler.greedy:
                self._sampler_fields(sampler, temp, topk, seed, req, i)
            purpose[i] = pur
            pos[i] = p
        return {
            "temperature": self._upload(temp),
            "top_k": self._upload(topk) if topk.any() else None,
            "seed": torch.from_numpy(seed),
            "req_id": torch.from_numpy(req),
            "purpose": torch.from_numpy(purpose),
            "position": torch.from_numpy(pos),
        }

    def _build_mixed_operands(self, cache, batcher, decode_slots, chunks,
                              sample_ids):
        """The flat token batch (decode tokens then chunks, padded to a
        width bucket), its slot/position maps, block tables, pools, and the
        padded sample-row gather. Returns ``(tok (1, W), caches, rows)``."""
        entries = [(slot, [batcher.next_token(slot)],
                    cache.slots[slot].num_tokens - 1)
                   for slot in decode_slots]
        entries += [(slot, np.asarray(seq.request.prompt[start: start + n],
                                      np.int32), start)
                    for slot, seq, start, n in chunks]
        used = len(decode_slots) + sum(n for _, _, _, n in chunks)
        width = self._bucket_tokens(used)
        tok, sid, pos = self._pack_flat(entries, width, self.max_batch)
        rows = self._bucket_rows(len(sample_ids))
        caches = {
            "slot_ids": self._upload(sid),
            "positions": self._upload(pos),
            "block_tables": cache.device_tables(cache.active_max_blocks(),
                                                null_rows=1),
            "segments": cache.pools,
            "sample_ids": self._upload(self._pack_sample_ids(sample_ids,
                                                             rows)),
        }
        return self._upload(tok[None]), caches, rows

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host operand on the engine's device, queued without waiting
        for the stream: a blocking copy would wait for every iteration
        already queued, and lookahead queues the next one before the last
        is read. A pageable source is staged before the call returns, so
        the array may be reused at once."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, non_blocking=True)

    def _dispatch_mixed(self, params, cache, batcher, decode_slots, chunks,
                        sample_ids, metas=None):
        """Build the flat token batch and run one fused forward over it.

        With ``metas`` (device sampling) the step samples on the device and
        returns the (S_pad,) int32 tokens as a host array. Without it,
        returns the gathered (1, S_pad, V) logits rows for host sampling."""
        tok, caches, rows = self._build_mixed_operands(
            cache, batcher, decode_slots, chunks, sample_ids)
        if metas is not None:
            sampling = self._pack_sampling(metas, rows)
            with profiling.annotate("paged_sample_step"):
                tokens, new_caches = self._sample(params, caches, tok,
                                                  sampling)
            cache.update_pools(new_caches)
            return tokens.cpu().numpy()
        with profiling.annotate("paged_mixed_step"):
            logits, new_caches = tfm.paged_mixed_step(params, self.cfg,
                                                      caches, tok)
        cache.update_pools(new_caches)
        return logits

    def _dispatch_mixed_async(self, params, cache, batcher,
                              plan: _MixedPlan, prev_tokens, fixups) -> None:
        """Pipelined dispatch: queue the planned iteration's fused forward
        and draw without waiting for the card, into ``plan.tokens_dev``.
        Decode entries whose host feed is still the previous iteration's
        placeholder take their tokens from ``prev_tokens`` (its token
        vector, on the device and not yet read) by ``fixups``, an indexed
        write on the device. On the card the tokens are then copied into a
        pinned host tensor of the plan, and an event recorded right after
        the copy marks them ready; the commit waits for that event only,
        not for the iterations queued behind it. On the CPU the tokens are
        already on the host."""
        tok, caches, rows = self._build_mixed_operands(
            cache, batcher, plan.decode_slots, plan.chunks, plan.sample_ids)
        if fixups:
            at = self._upload(np.asarray([i for i, _ in fixups], np.int64))
            src = self._upload(np.asarray([r for _, r in fixups], np.int64))
            tok[0, at] = prev_tokens[src]
        sampling = self._pack_sampling(plan.metas, rows)
        with profiling.annotate("paged_sample_step"):
            tokens, new_caches = self._sample(params, caches, tok, sampling)
        cache.update_pools(new_caches)
        plan.tokens_dev = tokens
        if self.device.type == "cuda":
            plan.tokens_host = torch.empty(tokens.shape, dtype=tokens.dtype,
                                           pin_memory=True)
            plan.tokens_host.copy_(tokens, non_blocking=True)
            plan.ready = torch.cuda.Event()
            plan.ready.record()
        else:
            plan.tokens_host = tokens

    # the fused device steps (the JAX engine's ``_sample_jit``,
    # ``_sample_probs_jit`` and ``_verify_accept_jit``), as plain calls

    def _sample(self, params, caches, tok, sampling):
        return dsamp.paged_sample_step(params, self.cfg, caches, tok,
                                       sampling)

    def _sample_probs(self, params, caches, tok, sampling):
        return dsamp.paged_sample_step(params, self.cfg, caches, tok,
                                       sampling, return_probs=True)

    def _verify_accept(self, params, caches, tok, accept, chunk_sampling):
        return dsamp.paged_verify_accept_step(params, self.cfg, caches, tok,
                                              accept, chunk_sampling)

    def _unstick(self, sched, cache, batcher, metrics, plog=None):
        """No decode token and no chunk could be scheduled: every block is
        pinned by half-prefilled sequences. Evict the youngest block-holding
        sequence so the head of the line can make progress."""
        holders = self._block_holders(cache, batcher)
        if not holders:
            raise RuntimeError("stuck with no block holders")
        if batcher.num_active == 1:
            raise CacheOOM(f"sequence {holders[0].req_id} alone exceeds "
                           "the pool")
        self._evict(Scheduler.pick_victim(holders), sched, cache, batcher,
                    metrics, reason="prefill_pinned", plog=plog)
