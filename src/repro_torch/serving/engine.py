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

This is the synchronous loop of the JAX package's engine, ported plan
for plan: operand layouts, width buckets and event order match it, so the
two engines emit identical token streams. The lookahead pipeline,
streaming sessions, the drain engine and the live telemetry plane are not
ported yet; asking for them raises ``NotImplementedError`` naming the
ROADMAP item.
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
from repro_torch.obs import CAT_ITER, CAT_SCHED, make_tracer
from repro_torch.serving import device_sampling as dsamp
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.kv_cache import CacheOOM, PagedKVCache
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.sampling import DRAW_TARGET
from repro_torch.serving.scheduler import (BudgetRouter, Request, Result,
                                           Scheduler, Sequence)

__all__ = ["ElasticEngine", "Request", "Result", "CacheOOM"]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP: {item})")


class _ImmediateLog:
    """Plan log of the synchronous engine: every emission fires the moment
    planning records it."""

    def __init__(self, engine, metrics, results):
        self.engine = engine
        self.metrics = metrics
        self.results = results

    def emit(self, fn, *args, **kw):
        fn(*args, **kw)

    def finish(self, seq):
        self.engine._finish(seq, self.metrics, self.results)

    def cancel_finish(self, seq):
        self.engine._finish(seq, self.metrics, self.results, cancelled=True)


class _MixedPlan:
    """One mixed iteration's decision record: decode slots, prompt chunks,
    sample rows and their sampler metas."""

    __slots__ = ("plog", "empty", "decode_slots", "decode_seqs", "chunks",
                 "sample_ids", "metas", "finish_rows", "total_chunk")

    def __init__(self, plog):
        self.plog = plog
        self.empty = True
        self.decode_slots: list = []
        self.decode_seqs: list = []
        self.chunks: list = []
        self.sample_ids: list = []
        self.metas: list = []
        self.finish_rows: dict = {}
        self.total_chunk = 0


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
        if lookahead is None:
            lookahead = os.environ.get("REPRO_ASYNC", "0") == "1"
        if lookahead:
            raise _not_ported("the one-iteration lookahead pipeline",
                              "lookahead pipeline")
        for name, value in (("registry", registry), ("watchdog", watchdog),
                            ("costaudit", costaudit)):
            if value is not None:
                raise _not_ported(f"the live telemetry plane ({name}=)",
                                  "live telemetry plane")
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
        # client cancellations: req_ids appended by any thread, applied at
        # the next plan boundary up to ``_cancel_cursor``
        self._cancel_list: List[int] = []
        self._cancel_lock = threading.Lock()
        self._cancel_cursor = 0
        self._seq_index: Dict[int, Sequence] = {}
        self.tracer = tracer if tracer is not None else make_tracer()
        self._deployed: Dict[int, object] = {}
        # seconds each budget row's GAR deploy took (device time included)
        self.deploy_seconds: Dict[int, float] = {}
        self._cost_table = np.asarray(
            [FR.deployed_param_count(cfg, infos, table, k)
             for k in range(table.table.shape[0])], np.int64)
        self.router = BudgetRouter(self._cost_table)
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
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
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
        slot and blocks; it finishes with ``Result.cancelled = True``.
        Thread-safe; unknown or finished ids are ignored."""
        with self._cancel_lock:
            self._cancel_list.append(int(req_id))

    # ----------------------------------------------------------- generate

    def generate(self, requests: List[Request], *, mode: str = "auto",
                 metrics: Optional[ServingMetrics] = None) -> List[Result]:
        """Serve ``requests`` to completion. ``mode``: 'continuous' (paged
        cache + iteration-level batching) or 'auto' (continuous for the
        paged-compatible families, which are all this port serves)."""
        if mode not in ("auto", "continuous", "drain"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "drain" or (mode == "auto"
                               and not tfm.paged_compatible(self.cfg)):
            raise _not_ported("the drain engine (mode='drain')",
                              "drain engine")
        if not tfm.paged_compatible(self.cfg):
            raise ValueError(
                f"{self.cfg.name}: paged continuous batching covers "
                "attn/attn_dense stacks only")
        with torch.no_grad():
            return self._generate_continuous(requests, metrics=metrics)

    def serve_session(self, session, **kw):
        raise _not_ported("streaming sessions (serve_session)",
                          "stream front door")

    def _generate_continuous(self, requests: List[Request], *,
                             metrics: Optional[ServingMetrics] = None
                             ) -> List[Result]:
        metrics = metrics or ServingMetrics(tracer=self.tracer)
        self.last_metrics = metrics
        sched = Scheduler(self.router, tracer=self.tracer)
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
            row = sched.next_row()
            draft_row = self.spec_draft_row(row)
            if draft_row is not None:
                from repro_torch.spec import SpecDecoder
                SpecDecoder(self, row=row, draft_row=draft_row,
                            spec=self.spec, sched=sched, metrics=metrics,
                            results=results).serve()
            else:
                self._serve_row_mixed(row, sched, metrics, results)
        return [results[s.req_id] for s in submitted]

    def _finish(self, seq: Sequence, metrics, results, *,
                cancelled: bool = False) -> None:
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

    def _block_holders(self, cache, batcher):
        """Seated sequences that actually own blocks — the only useful
        victims (evicting a zero-block mid-prefill seat frees nothing)."""
        return [s for s in batcher.active_sequences()
                if cache.slots[batcher.slot_of(s)].blocks]

    def _evict(self, victim, sched, cache, batcher, metrics,
               reason: str = "cache_pressure") -> int:
        """Preempt one sequence: free its slot + blocks, re-queue at the row
        front for recompute. Returns the vacated slot."""
        vslot = batcher.slot_of(victim)
        vstate = victim.state                # requeue resets it to waiting
        batcher.leave(vslot)
        cache.free_slot(vslot)
        sched.requeue_front(victim)
        metrics.on_preempt(victim.req_id)
        if self.tracer.enabled:
            self.tracer.instant(
                "preempt", CAT_SCHED,
                args={"req": victim.req_id, "slot": vslot, "reason": reason,
                      "policy": "youngest_first", "state": vstate})
        return vslot

    def _reserve_or_preempt(self, sched, cache, batcher, metrics):
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
                                    reason="cache_pressure")
                if vslot == slot:
                    break                      # the appender itself was evicted
            seq = batcher.slots[slot]
            if seq is not None and seq.state == "decoding":
                cache.append_token(slot)

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
        """One budget row's chunked-prefill loop over a fresh paged cache."""
        params = self._realize(row)
        cache = PagedKVCache(self.cfg, max_batch=self.max_batch,
                             max_len=self.max_len, block_size=self.block_size,
                             num_blocks=self.num_blocks,
                             prefix_cache=self.prefix_cache,
                             device=self.device)
        cache.tracer = self.tracer
        batcher = ContinuousBatcher(self.max_batch)
        self._serve_row_sync(row, params, sched, cache, batcher, metrics,
                             results)

    def _apply_cancellations(self, sched, cache, batcher, plog) -> None:
        """Apply every not yet applied cancellation entry: a waiting
        request leaves its row queue, a seated one frees its slot and
        blocks; unknown or already finished ids are ignored."""
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
        self._cancel_cursor = n

    def _plan_iteration(self, row: int, sched, cache, batcher,
                        metrics, plog) -> _MixedPlan:
        """One mixed iteration's scheduling half: apply cancellations, seat
        waiting requests (probing the prefix cache), reserve decode room
        (preempting under pressure), plan the FIFO prompt chunks, and pick
        the sample rows. Returns an ``empty`` plan when the row drained."""
        tr = self.tracer
        plan = _MixedPlan(plog)
        while True:
            self._apply_cancellations(sched, cache, batcher, plog)
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
                batcher.seat_prefill(slot, seq)
            if batcher.num_active == 0:
                return plan                  # row drained (all slots free)

            # decode priority: reserve next-token room before any prefill
            self._reserve_or_preempt(sched, cache, batcher, metrics)
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
                self._unstick(sched, cache, batcher, metrics)
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
        dev = self.device
        # queued without waiting for the stream (a pageable copy is staged
        # before the call returns)
        return {
            "temperature": torch.from_numpy(temp).to(dev, non_blocking=True),
            "top_k": (torch.from_numpy(topk).to(dev, non_blocking=True)
                      if topk.any() else None),
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
        dev = self.device
        caches = {
            "slot_ids": torch.from_numpy(sid).to(dev),
            "positions": torch.from_numpy(pos).to(dev),
            "block_tables": cache.device_tables(cache.active_max_blocks(),
                                                null_rows=1),
            "segments": cache.pools,
            "sample_ids": torch.from_numpy(
                self._pack_sample_ids(sample_ids, rows)).to(dev),
        }
        return torch.from_numpy(tok[None]).to(dev), caches, rows

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
            with torch.profiler.record_function("paged_sample_step"):
                tokens, new_caches = self._sample(params, caches, tok,
                                                  sampling)
            cache.update_pools(new_caches)
            return tokens.cpu().numpy()
        with torch.profiler.record_function("paged_mixed_step"):
            logits, new_caches = tfm.paged_mixed_step(params, self.cfg,
                                                      caches, tok)
        cache.update_pools(new_caches)
        return logits

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

    def _unstick(self, sched, cache, batcher, metrics):
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
                    metrics, reason="prefill_pinned")
