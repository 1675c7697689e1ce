"""SpecDecoder: draft/verify rounds for one budget row of the serving engine.

The port of the JAX package's ``spec/decoder.py``, round for round, so the
two engines commit the same tokens in the same rounds. Round anatomy
(greedy acceptance is token-identical to target-only decoding; stochastic
acceptance is distribution-identical):

  1. **plan** - for every decoding sequence, reserve cache room for the
     round. The one mandatory verify token keeps the mixed engine's
     semantics (evict youngest block holders under pressure); everything
     speculative (extra verify positions, draft-slot growth) is
     opportunistic and shrinks instead of evicting. Per-sequence draft
     lengths come from ``SpecConfig.request_spec_len`` and the round's
     extras budget is dealt fairly (``Scheduler.split_spec_extras``).
  2. **draft** - the low-rank prefix row proposes up to ``k`` tokens
     autoregressively through the flat-token paged forward, writing the
     *draft* cache slot. Greedy sequences propose the draft row's argmax;
     stochastic ones sample each proposal from the draft row's warped
     distribution with a position-keyed ``DRAW_DRAFT`` uniform and keep
     that distribution ``q`` for the accept test. The draft cache warms
     lazily: each round's first draft step streams up to ``gap_chunk``
     committed tokens the draft slot lacks.
  3. **verify** - one full-row ``paged_verify_step`` scores every
     sequence's ``k+1`` positions; target prefill chunks of sequences not
     yet decoding ride the same forward.
  4. **accept** - greedy: the longest prefix of drafts matching the full
     row's argmax, then the full row's own token. Stochastic: Leviathan
     accept/reject per position (``stochastic_accept``), a residual
     resample at the first rejection, a bonus draw when all survive. Both
     cache slots then roll back with ``truncate_slot``.

On the device path (``ElasticEngine(device_sampling=True)``, the default)
a round is queued without waiting for the card: the block tables are
uploaded once a round, draft tokens and ``q`` rows stay on the device and
are gathered into the next step's tokens and into the accept operands,
the accept step's keyed uniforms are hashed on the host for every
candidate position, and the round's only synchronisation is the read of
its commit (``_read_commit``).

Replay discipline: every stochastic draw is keyed by (seed, req_id,
purpose, position), so dropping in-flight drafts (rollback, mid-round
preemption) cannot drift a sequence's randomness.

Dual-slot layout: the decoder's ``PagedKVCache`` carries ``2 * max_batch``
slots over one ``BlockAllocator``: seat ``s`` writes target K/V at slot
``s`` and draft K/V at slot ``max_batch + s``. Eviction frees the pair.
With prefix caching on, an empty draft slot aliases its target's full
prompt blocks (``share_prefix``); the pools are updated in place, so the
draft's first write into a shared block goes through copy-on-write
(``PagedKVCache.extend_slot``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import transformer as tfm
from repro_torch.obs import CAT_SCHED, CAT_SPEC, profiling
from repro_torch.serving import device_sampling as dsamp
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.kv_cache import CacheOOM, PagedKVCache
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.sampling import (DRAW_ACCEPT, DRAW_DRAFT,
                                          DRAW_RESIDUAL, DRAW_TARGET,
                                          SamplerState, sample_from,
                                          sample_token)
from repro_torch.serving.scheduler import Scheduler, Sequence
from repro_torch.spec.config import SpecConfig


def stochastic_accept(sampler: SamplerState, committed: int,
                      drafts: List[int], draft_probs: List[np.ndarray],
                      target_rows: np.ndarray) -> Tuple[List[int], int]:
    """Leviathan-style stochastic acceptance for one sequence's round (the
    host oracle).

    ``drafts[j]`` was sampled from the draft row's warped distribution
    ``draft_probs[j]`` for position ``committed + j``; ``target_rows[j]``
    is the full row's logits for that position (row ``len(drafts)`` is the
    all-accepted bonus position). Returns ``(tokens_to_commit,
    num_accepted_drafts)``, always at least one token.

    At each position the committed token is ``x ~ q`` kept with
    probability ``min(1, p(x)/q(x))`` or, failing that, a draw from the
    residual ``(p - min(p, q)) / (1 - sum_v min(p(v), q(v)))``; summed over
    ``x`` that is ``min(p, q) + (1 - sum min(p, q)) * residual = p`` for
    any proposal ``q`` (Leviathan et al. 2023).
    """
    out: List[int] = []
    for j, x in enumerate(drafts):
        p = sampler.probs(target_rows[j])
        q = draft_probs[j]
        pos = committed + j
        # accept with prob min(1, p/q): u*q <= p avoids the q == 0 division
        if sampler.uniform(pos, DRAW_ACCEPT) * q[x] <= p[x]:
            out.append(int(x))
            continue
        residual = np.maximum(p - q, 0.0)
        tot = float(residual.sum())
        # a (numerically) empty residual means p <= q everywhere, where the
        # accept test almost surely passed; fall back to p itself
        r = residual / tot if tot > 1e-12 else p
        out.append(sample_from(r, sampler.uniform(pos, DRAW_RESIDUAL)))
        return out, j
    # every draft survived: bonus token straight from the target's k-th row
    bonus_pos = committed + len(drafts)
    out.append(sampler.sample_at(bonus_pos, target_rows[len(drafts)]))
    return out, len(drafts)


@dataclasses.dataclass
class RoundPlan:
    """One decoding sequence's reservation for the current round."""
    seat: int                    # batcher seat == target slot id
    seq: Sequence
    committed: int               # L: prompt + generated tokens
    gap_fed: int                 # draft-warmup tokens fed this round
    k: int                       # draft proposals this round (may be 0)
    # host path: proposed tokens and their warped float64 q rows
    drafts: List[int] = dataclasses.field(default_factory=list)
    draft_probs: List[np.ndarray] = dataclasses.field(default_factory=list)
    # device path: where proposal j (0-based) sits among the round's draft
    # outputs, as (step index, row in that step's output)
    draft_at: List[Tuple[int, int]] = dataclasses.field(default_factory=list)


class _DraftOutputs:
    """The device path's draft steps: each step's (S_pad,) int32 tokens and
    (S_pad, V) q rows (None when no stochastic sequence drafted in it)."""

    def __init__(self):
        self.tokens: List[torch.Tensor] = []
        self.probs: List[Optional[torch.Tensor]] = []

    def offsets(self, with_probs: bool) -> List[int]:
        """Start row of each step in the concatenation of its outputs."""
        out, at = [], 0
        for t, p in zip(self.tokens, self.probs):
            out.append(at)
            if not with_probs:
                at += t.shape[0]
            elif p is not None:
                at += p.shape[0]
        return out


class SpecDecoder:
    """Drives one budget row's speculative continuous-batching loop.

    Borrows the engine's steps and its finish/metrics plumbing; owns the
    dual-slot cache discipline and the acceptance logic.
    """

    def __init__(self, engine, *, row: int, draft_row: int, spec: SpecConfig,
                 sched: Scheduler, metrics: ServingMetrics, results: Dict):
        self.engine = engine
        self.cfg = engine.cfg
        self.device = engine.device
        self.row = row
        self.draft_row = draft_row
        self.spec = spec
        self.sched = sched
        self.metrics = metrics
        self.results = results
        self.max_batch = engine.max_batch
        self.tracer = engine.tracer
        self.target_params = engine._realize(row)
        self.draft_params = engine._realize(draft_row)
        # 2x slots, one allocator: seat s -> target slot s, draft slot B + s
        self.cache = PagedKVCache(
            self.cfg, max_batch=2 * engine.max_batch, max_len=engine.max_len,
            block_size=engine.block_size, num_blocks=engine.num_blocks,
            prefix_cache=engine.prefix_cache, device=self.device)
        self.cache.tracer = self.tracer
        self.batcher = ContinuousBatcher(engine.max_batch)
        self._upload = engine._upload  # queued uploads, no wait
        self._round_tables = None    # device block tables, valid per round
        self._disp_s = 0.0           # per-round device-dispatch seconds
        self._zero_row = None        # (1, V) zero q row (padding), cached
        chunk = engine.prefill_chunk or engine.max_len
        self.prefill_chunk = chunk
        # verify-token budget per round; prefill chunks take the leftover
        self.token_budget = engine.token_budget or (
            engine.max_batch * (spec.spec_len + 1) + chunk)

    # ------------------------------------------------------------- slots

    def _draft_slot(self, seat: int) -> int:
        return self.max_batch + seat

    def _zero_q(self) -> torch.Tensor:
        """The cached (1, V) zero proposal row: the q of greedy and pad
        plans in the accept operands, gathered, never allocated a round."""
        if self._zero_row is None:
            self._zero_row = torch.zeros((1, self.cfg.vocab_size),
                                         dtype=torch.float32,
                                         device=self.device)
        return self._zero_row

    def _free_pair(self, seat: int) -> None:
        """Free both of a seat's cache slots (a sequence never releases one
        side without the other)."""
        self.cache.free_slot(seat)
        self.cache.free_slot(self._draft_slot(seat))

    def _apply_cancellations(self) -> None:
        """Round-boundary cancellation sweep; a seated victim releases its
        slot pair."""
        eng = self.engine
        with eng._cancel_lock:
            n = len(eng._cancel_list)
            entries = eng._cancel_list[eng._cancel_cursor: n]
        for req_id in entries:
            seq = eng._seq_index.get(req_id)
            if seq is None or seq.state == "finished":
                continue
            if self.sched.remove_waiting(seq):
                eng._finish_cancelled(seq, self.metrics, self.results)
                continue
            for seat, s in enumerate(self.batcher.slots):
                if s is seq:
                    self.batcher.leave(seat)
                    self._free_pair(seat)
                    eng._finish_cancelled(seq, self.metrics, self.results)
                    break
        eng._cancel_cursor = n

    def _stream_commit(self, seq: Sequence, commit) -> None:
        """Stream a round's committed tokens to the session, indexed by
        their positions in ``seq.generated``: call before extending the
        list. The decoder is commit-serial, so the values are final."""
        sess = self.engine._session
        if sess is None:
            return
        base = len(seq.generated)
        for j, tok in enumerate(commit):
            sess.emit(seq.req_id, base + j, int(tok))

    def _block_holders(self) -> List[Sequence]:
        """Seated sequences holding blocks in either slot of their pair."""
        out = []
        for seq in self.batcher.active_sequences():
            seat = self.batcher.slot_of(seq)
            if (self.cache.slots[seat].blocks
                    or self.cache.slots[self._draft_slot(seat)].blocks):
                out.append(seq)
        return out

    def _evict(self, victim: Sequence, *, reason: str = "cache_pressure") -> int:
        """Preempt one sequence: free both slots, drop its in-flight draft
        state, re-queue at the row front for recompute."""
        seat = self.batcher.slot_of(victim)
        vstate = victim.state
        self.batcher.leave(seat)
        self._free_pair(seat)
        self.sched.requeue_front(victim)
        self.metrics.on_preempt(victim.req_id)
        if self.tracer.enabled:
            self.tracer.instant(
                "preempt", CAT_SCHED,
                args={"req": victim.req_id, "slot": seat, "reason": reason,
                      "policy": "youngest_first", "state": vstate})
        return seat

    # -------------------------------------------------------------- loop

    def serve(self) -> None:
        eng, sched, tr = self.engine, self.sched, self.tracer
        eng._live.update(row=self.row, cache=self.cache,
                         batcher=self.batcher, spec=True)
        while True:
            it0 = self.metrics.now()
            self._disp_s = 0.0
            eng._drain_intake(sched, self.metrics)
            self._apply_cancellations()
            # admission: seat waiting requests with a slot pair each
            for seat in self.batcher.free_slots():
                if not sched.has_waiting(self.row):
                    break
                seq = sched.pop(self.row)
                self.metrics.on_admit(seq.req_id)
                if tr.enabled:
                    tr.instant("admit", CAT_SCHED,
                               args={"req": seq.req_id, "row": self.row,
                                     "slot": seat, "reason": "slot_free",
                                     "attempt": seq.admissions})
                if seq.request.max_new_tokens <= 0:
                    eng._finish(seq, self.metrics, self.results)
                    continue
                if seq.prompt_len > eng.max_len:
                    raise CacheOOM(f"sequence of {seq.prompt_len} tokens "
                                   f"exceeds max_len {eng.max_len}")
                self.cache.open_slot(seat)
                self.cache.open_slot(self._draft_slot(seat))
                # prefix-cache probe on the target slot only; the draft
                # slot aliases the target's prompt blocks once the sequence
                # decodes (share_prefix in _plan_round)
                hit = self.cache.probe_prefix(seat, seq.request.prompt)
                if hit:
                    seq.prefill_pos = hit
                    self.metrics.on_prefix_hit(seq.req_id, hit,
                                               self.cache.cached_blocks)
                self.batcher.seat_prefill(seat, seq)
            if self.batcher.num_active == 0:
                break                            # row drained

            plans = self._plan_round()
            chunks = self._plan_prefill(plans)
            if not plans and not chunks:
                if self.batcher.num_active == 0:
                    continue                     # everyone was preempted
                self._unstick()
                continue
            plan_end = self.metrics.now()
            if tr.enabled:
                tr.complete("plan", CAT_SPEC, it0, plan_end,
                            args={"plans": len(plans),
                                  "chunks": len(chunks),
                                  "draft_tokens": sum(p.k for p in plans)})

            # every block the round touches was reserved during planning,
            # so one upload of the tables serves all k+1 dispatches
            if eng.device_sampling:
                out = self._enqueue_round(plans, chunks)
                draft_end = self.metrics.now()
                read = self._read_commit(out)
                self._disp_s = self.metrics.now() - plan_end
                self._apply_commit(plans, chunks, *read)
            else:
                self._round_tables = self._upload(self.cache.host_tables(
                    self.cache.active_max_blocks(), null_rows=1))
                self._draft_phase(plans)
                draft_end = self.metrics.now()
                self._verify_and_commit(plans, chunks)
            self._round_tables = None
            it1 = self.metrics.now()
            if tr.enabled:
                if draft_end > plan_end:
                    tr.complete("draft", CAT_SPEC, plan_end, draft_end,
                                args={"drafters": sum(1 for p in plans
                                                      if p.k > 0)})
                tr.complete("verify", CAT_SPEC, draft_end, it1,
                            args={"plans": len(plans), "chunks": len(chunks)})
            self.metrics.on_iteration_timing(
                self._disp_s, it1 - it0 - self._disp_s)
            eng._iteration_stats(sched, self.cache, self.metrics)
            # live telemetry heartbeat: speculative rounds tick the
            # watchdog like mixed iterations (the cost audit skips them: a
            # round interleaves draft- and verify-row dispatches, so there
            # is no clean per-row attribution; see obs/costaudit.py)
            eng._iterations += 1
            if eng.watchdog is not None:
                eng._watchdog_tick(self.metrics, self.cache,
                                   decoding=bool(self.batcher.decode_slots()))

    # ----------------------------------------------------------- planning

    def _reserve_mandatory(self, seat: int) -> bool:
        """Guarantee the seat's one mandatory verify token, evicting the
        youngest block holder under pressure (mixed-engine semantics).
        Returns False if the seat's own sequence got evicted."""
        while self.cache.extend_slot(seat, 1, clip=True) == 0:
            victim = Scheduler.pick_victim(self._block_holders())
            if (victim is self.batcher.slots[seat]
                    and self.batcher.num_active == 1):
                raise CacheOOM(
                    f"sequence {victim.req_id} alone exceeds the pool")
            if self._evict(victim) == seat:
                return False                     # the seat itself went
        return True

    def _plan_round(self) -> List[RoundPlan]:
        plans: List[RoundPlan] = []
        decode_seats = self.batcher.decode_slots()
        # mandatory verify tokens are the decode reserve; speculative
        # extras take what remains after one prefill chunk's worth is kept
        # for seated prefills
        extras_left = self.token_budget - len(decode_seats)
        if self.batcher.prefill_slots():
            extras_left -= min(self.prefill_chunk, self.engine.max_len)
        # adaptive-k wants are read once a round per sequence (the probe
        # counter advances on read), then granted fairly; a sequence still
        # warming its draft cache wants 0
        wants = []
        for seat in decode_seats:
            seq = self.batcher.slots[seat]
            want = self.spec.request_spec_len(seq)
            dslot = self._draft_slot(seat)
            # draft-KV sharing: an empty draft slot aliases its target's
            # full prompt blocks instead of re-prefilling the prompt at the
            # draft row (the pools are rank-agnostic and acceptance only
            # commits target tokens)
            if (self.cache.prefix_cache
                    and self.spec.request_can_draft(seq)
                    and self.cache.slots[dslot].num_tokens == 0):
                self.cache.share_prefix(seat, dslot, seq.prompt_len)
            gap = (seq.prompt_len + len(seq.generated)
                   - self.cache.slots[dslot].num_tokens)
            wants.append(0 if gap > self.spec.gap_chunk else want)
        grants = dict(zip(decode_seats,
                          Scheduler.split_spec_extras(wants, extras_left)))
        for seat in decode_seats:
            seq = self.batcher.slots[seat]
            if seq is None or seq.state != "decoding":
                continue                         # evicted while reserving
            committed = seq.prompt_len + len(seq.generated)
            tgt = self.cache.slots[seat]
            assert tgt.num_tokens == committed - 1, (tgt.num_tokens, committed)
            if not self._reserve_mandatory(seat):
                continue

            dslot = self._draft_slot(seat)
            gap = committed - self.cache.slots[dslot].num_tokens
            assert gap >= 1, gap
            want_k = grants[seat]                # 0 while warming the draft
            # speculation degrades under pressure, it never evicts: clamp
            # to the round's extras budget and the max_len headroom, then
            # clip to the free list
            want_k = max(0, min(want_k, extras_left))
            want_k = min(want_k,
                         self.engine.max_len - self.cache.slots[seat].num_tokens)
            k = self.cache.extend_slot(seat, want_k, clip=True)
            # draft slot: gap feed + the k-1 proposal writes, clip-only; a
            # sequence that can never draft skips warmup entirely
            fed = (min(gap, self.spec.gap_chunk)
                   if self.spec.request_can_draft(seq) else 0)
            head = self.engine.max_len - self.cache.slots[dslot].num_tokens
            if fed > head:
                fed, k = head, 0
            if k > 0:
                k = min(k, head - fed + 1)
            need = fed + max(0, k - 1)
            got = self.cache.extend_slot(dslot, need, clip=True)
            if got < need:
                if k > 0 and got >= fed:
                    k = got - fed + 1            # fewer proposals fit
                else:
                    fed, k = got, 0              # partial warmup only
            # release verify room we are no longer going to use
            self.cache.truncate_slot(seat, committed + k)
            extras_left -= k
            plans.append(RoundPlan(seat=seat, seq=seq, committed=committed,
                                   gap_fed=fed, k=k))
        # a later seat's mandatory reservation may have evicted an earlier
        # planned sequence; its plan went with it
        return [p for p in plans if self.batcher.slots[p.seat] is p.seq]

    def _plan_prefill(self, plans: List[RoundPlan]):
        """Target-side prefill chunks riding the verify forward, under the
        leftover token budget (verify tokens are reserved first)."""
        spent = sum(p.k + 1 for p in plans)
        budget_left = self.token_budget - spent
        prefilling = [self.batcher.slots[s]
                      for s in self.batcher.prefill_slots()]
        chunks = []
        for seq, want in Scheduler.plan_prefill_chunks(
                prefilling, budget_left, self.prefill_chunk,
                order=self.engine.prefill_order):
            seat = self.batcher.slot_of(seq)
            got = self.cache.extend_slot(seat, want, clip=True)
            if got:
                chunks.append((seat, seq, seq.prefill_pos, got))
        return chunks

    def _unstick(self) -> None:
        holders = self._block_holders()
        assert holders, "stuck with no block holders"
        if self.batcher.num_active == 1:
            raise CacheOOM(f"sequence {holders[0].req_id} alone exceeds "
                           "the pool")
        self._evict(Scheduler.pick_victim(holders), reason="round_stalled")

    def _gap_entry(self, p: RoundPlan):
        """The draft slot's warmup feed of ``p``: (slot, tokens, start).
        Planning extended the draft slot by ``gap_fed`` (+ k-1), so the feed
        starts at its previous write position."""
        committed = list(map(int, p.seq.request.prompt)) + p.seq.generated
        dslot = self._draft_slot(p.seat)
        start = (self.cache.slots[dslot].num_tokens
                 - p.gap_fed - max(0, p.k - 1))
        return dslot, committed[start: start + p.gap_fed], start

    def _bucket(self, used: int) -> int:
        return self.engine._bucket_tokens(used, self.token_budget)

    def _operands(self, entries, sample_ids=None, width: int = 0):
        """Flat-token operands of one forward: (tokens (1, W) on the device,
        caches). ``entries``: (slot, tokens, start) runs, the engine's
        ``_pack_flat`` layout; ``sample_ids`` padded to ``width`` rows."""
        eng = self.engine
        used = sum(len(t) for _, t, _ in entries)
        tok, sid, pos = eng._pack_flat(entries, self._bucket(used),
                                       2 * self.max_batch)
        caches = {"slot_ids": self._upload(sid),
                  "positions": self._upload(pos),
                  "block_tables": self._round_tables,
                  "segments": self.cache.pools}
        if sample_ids is not None:
            caches["sample_ids"] = self._upload(
                eng._pack_sample_ids(sample_ids, width))
        return self._upload(tok[None]), caches

    # --------------------------------------------------- host-oracle path

    def _dispatch(self, fn, params, entries):
        """Run one flat-token forward and read its argmax rows. Returns the
        (T_padded, V) logits on the device and the host argmax."""
        tok, caches = self._operands(entries)
        t0 = self.metrics.now()
        with profiling.annotate(fn.__name__):
            logits, new_caches = fn(params, self.cfg, caches, tok)
            greedy = torch.argmax(logits[0], dim=-1).cpu().numpy()
        self._disp_s += self.metrics.now() - t0
        self.cache.update_pools(new_caches)
        return logits[0], greedy

    def _propose(self, p: RoundPlan, greedy: np.ndarray, logits,
                 flat_idx: int, step: int) -> None:
        """Record draft proposal number ``step`` (1-based) of plan ``p``
        from the draft-row logits at flat position ``flat_idx``."""
        sampler = p.seq.sampler
        if sampler.greedy:
            p.drafts.append(int(greedy[flat_idx]))
            return
        q = sampler.probs(logits[flat_idx].cpu().numpy())
        pos = p.committed + step - 1             # index of the proposed token
        p.drafts.append(sample_from(q, sampler.uniform(pos, DRAW_DRAFT)))
        p.draft_probs.append(q)

    def _draft_phase(self, plans: List[RoundPlan]) -> None:
        """Autoregressive draft proposals (+ lazy draft-cache warmup)."""
        entries, emitters = [], []
        for p in plans:
            if p.gap_fed == 0:
                continue
            entries.append(self._gap_entry(p))
            if p.k > 0:
                emitters.append((p, len(entries) - 1))
        if not entries:
            return
        flat_end = np.cumsum([len(t) for _, t, _ in entries]) - 1
        logits, greedy = self._dispatch(tfm.paged_mixed_step,
                                        self.draft_params, entries)
        for p, ei in emitters:
            self._propose(p, greedy, logits, int(flat_end[ei]), 1)

        # steps 2..k: one proposal per participating sequence per step
        max_k = max((p.k for p in plans), default=0)
        for step in range(2, max_k + 1):
            live = [p for p in plans if p.k >= step]
            entries = [(self._draft_slot(p.seat), [p.drafts[-1]],
                        p.committed + step - 2) for p in live]
            logits, greedy = self._dispatch(tfm.paged_mixed_step,
                                            self.draft_params, entries)
            for i, p in enumerate(live):
                self._propose(p, greedy, logits, i, step)

    def _first_token(self, seq: Sequence, logits_row) -> int:
        """Prefill-completion token. Sequences in stochastic speculation
        draw it position-keyed (``DRAW_TARGET`` at ``prompt_len``);
        verify-only sequences keep the sequential stream."""
        sampler = seq.sampler
        if not sampler.greedy and self.spec.request_can_draft(seq):
            return sampler.sample_at(seq.prompt_len, logits_row)
        return sample_token(seq, logits_row)

    def _verify_and_commit(self, plans: List[RoundPlan], chunks) -> None:
        entries = []
        for p in plans:
            feed = self.batcher.next_token(p.seat)
            entries.append((p.seat, [feed] + p.drafts, p.committed - 1))
        for seat, seq, start, n in chunks:
            toks = list(map(int, seq.request.prompt[start: start + n]))
            entries.append((seat, toks, start))
        logits, greedy = self._dispatch(tfm.paged_verify_step,
                                        self.target_params, entries)

        # acceptance per sequence: greedy longest-accepted-prefix, or
        # Leviathan accept/resample for stochastic drafters
        flat = 0
        m_all, commits = [], []
        for p in plans:
            run = p.k + 1
            sampler = p.seq.sampler
            if sampler.greedy:
                targets = [int(greedy[flat + j]) for j in range(run)]
                m = 0
                while m < p.k and p.drafts[m] == targets[m]:
                    m += 1
                commit = targets[: m + 1]
            elif self.spec.request_can_draft(p.seq):
                rows = logits[flat: flat + run].cpu().numpy()
                commit, m = stochastic_accept(sampler, p.committed,
                                              p.drafts, p.draft_probs, rows)
            else:
                # verify-only fallback (``stochastic=False`` or the
                # ``spec_len=0`` opt-out): one sequential-stream draw,
                # token-identical to the non-speculative engines
                assert p.k == 0, (p.seq.req_id, p.k)
                m = 0
                commit = [sample_token(p.seq, logits[flat].cpu().numpy())]
            flat += run
            m_all.append(m)
            commits.append(commit)
        firsts = []
        for seat, seq, start, n in chunks:
            if start + n == seq.prompt_len:
                firsts.append(self._first_token(
                    seq, logits[flat + n - 1].cpu().numpy()))
            flat += n
        self._apply_commit(plans, chunks, commits, m_all, firsts)

    # ----------------------------------------------------- device path

    def _enqueue_round(self, plans: List[RoundPlan], chunks):
        """Queue the round on the device: the block tables, the draft steps
        and the fused verify/accept step. Waits for nothing; returns the
        step's device outputs and the finishing chunks' sample rows."""
        self._round_tables = self._upload(self.cache.host_tables(
            self.cache.active_max_blocks(), null_rows=1))
        drafts = self._draft_phase_device(plans)
        return self._verify_device(plans, chunks, drafts)

    def _draft_step(self, entries, sample_ids, metas, fill=None):
        """One draft-row dispatch with in-step sampling. ``fill``: (flat
        positions, device tokens) written into the token batch on the
        device (the previous step's proposals). Returns the device tokens
        and, when a stochastic sequence drafts in this step, its q rows."""
        eng = self.engine
        width = eng._bucket_rows(len(sample_ids))
        sampling = eng._pack_sampling(metas, width)
        tok, caches = self._operands(entries, sample_ids, width)
        if fill is not None:
            at, src = fill
            tok[0, self._upload(at)] = src
        want_probs = any(not sampler.greedy for sampler, _, _ in metas)
        step = eng._sample_probs if want_probs else eng._sample
        with profiling.annotate("paged_sample_step"):
            out, new_caches = step(self.draft_params, caches, tok, sampling)
        self.cache.update_pools(new_caches)
        return out if want_probs else (out, None)

    def _draft_phase_device(self, plans: List[RoundPlan]) -> _DraftOutputs:
        """Autoregressive draft proposals with in-step sampling, kept on the
        device: each step's tokens feed the next step's batch by a device
        gather, and ``q`` never leaves the card."""
        out = _DraftOutputs()
        # step 1: gap feeds + first proposal for plans that can draft
        entries, emitters, sample_ids = [], [], []
        for p in plans:
            if p.gap_fed == 0:
                continue
            entries.append(self._gap_entry(p))
            if p.k > 0:
                emitters.append(p)
                sample_ids.append(sum(len(t) for _, t, _ in entries) - 1)
        if not entries:
            return out
        metas = [(p.seq.sampler, DRAW_DRAFT, p.committed) for p in emitters]
        tokens, probs = self._draft_step(entries, sample_ids, metas)
        out.tokens.append(tokens)
        out.probs.append(probs)
        for i, p in enumerate(emitters):
            p.draft_at.append((0, i))

        # steps 2..k: one proposal per participating sequence per step
        max_k = max((p.k for p in plans), default=0)
        for step in range(2, max_k + 1):
            live = [p for p in plans if p.k >= step]
            entries = [(self._draft_slot(p.seat), [0],
                        p.committed + step - 2) for p in live]
            metas = [(p.seq.sampler, DRAW_DRAFT, p.committed + step - 1)
                     for p in live]
            prev = out.tokens[-1][self._upload(np.asarray(
                [p.draft_at[-1][1] for p in live], np.int64))]
            tokens, probs = self._draft_step(
                entries, list(range(len(live))), metas,
                fill=(np.arange(len(live), dtype=np.int64), prev))
            out.tokens.append(tokens)
            out.probs.append(probs)
            for i, p in enumerate(live):
                p.draft_at.append((step - 1, i))
        return out

    def _verify_device(self, plans: List[RoundPlan], chunks,
                       drafts: _DraftOutputs):
        """Queue the fused ``paged_verify_accept_step``: every plan's
        ``k+1`` positions scored, Leviathan accept/resample (or the greedy
        prefix rule) and the finishing chunks' first-token draws."""
        eng = self.engine
        entries = []
        for p in plans:
            feed = self.batcher.next_token(p.seat)
            entries.append((p.seat, [feed] + [0] * p.k, p.committed - 1))
        for seat, seq, start, n in chunks:
            entries.append((seat,
                            list(map(int, seq.request.prompt[start:
                                                             start + n])),
                            start))

        # gathered-row layout: P_pad verify runs of exactly k_cap+1 rows
        # (short runs repeat their first row), then the finishing chunks'
        # final-token rows
        k_cap = max([self.spec.spec_len] + [p.k for p in plans])
        p_pad = 1
        while p_pad < max(len(plans), 1):
            p_pad *= 2
        sample_ids: List[int] = []
        off = 0
        for p in plans:
            ids = list(range(off, off + p.k + 1))
            sample_ids += ids + [off] * (k_cap + 1 - len(ids))
            off += p.k + 1
        sample_ids += [0] * ((p_pad - len(plans)) * (k_cap + 1))
        chunk_meta, finish_rows = [], {}
        flat = off
        for seat, seq, start, n in chunks:
            if start + n == seq.prompt_len:
                finish_rows[seat] = len(chunk_meta)
                sample_ids.append(flat + n - 1)
                chunk_meta.append((seq.sampler, DRAW_TARGET,
                                   seq.prompt_len))
            flat += n
        c_pad = 0
        if chunk_meta:
            c_pad = 1
            while c_pad < len(chunk_meta):
                c_pad *= 2
            sample_ids += [0] * (c_pad - len(chunk_meta))

        # where each proposal sits among the draft steps' outputs; the
        # index one past the end reads a zero (pads, greedy q rows)
        tok_at = drafts.offsets(with_probs=False)
        n_tok = sum(t.shape[0] for t in drafts.tokens)
        src = np.full((p_pad, k_cap), n_tok, np.int64)
        fill_at, fill_src = [], []
        off = 0
        for pi, p in enumerate(plans):
            for j, (s, r) in enumerate(p.draft_at):
                src[pi, j] = tok_at[s] + r
                fill_at.append(off + 1 + j)
                fill_src.append(tok_at[s] + r)
            off += p.k + 1
        all_tok = torch.cat(drafts.tokens + [torch.zeros(
            1, dtype=torch.int32, device=self.device)])

        ks = np.zeros(p_pad, np.int32)
        committed = np.zeros(p_pad, np.int32)
        temp = np.zeros(p_pad, np.float32)
        topk = np.zeros(p_pad, np.int32)
        seed = np.zeros(p_pad, np.int32)
        req = np.zeros(p_pad, np.int32)
        stoch = []
        for pi, p in enumerate(plans):
            ks[pi] = p.k
            committed[pi] = p.committed
            s = p.seq.sampler
            if not s.greedy:
                stoch.append(pi)
                eng._sampler_fields(s, temp, topk, seed, req, pi)
        accept = {"k": self._upload(ks),
                  "drafts": all_tok[self._upload(src)],
                  "temperature": self._upload(temp)}
        if stoch:
            accept["u"] = self._upload(
                dsamp.accept_uniforms(seed, req, committed, k_cap))
            if topk.any():
                accept["top_k"] = self._upload(topk)
            # q rows of stochastic drafters, the cached zero row elsewhere
            q_at = drafts.offsets(with_probs=True)
            rows = [pr for pr in drafts.probs if pr is not None]
            qsrc = np.full((p_pad, k_cap), sum(r.shape[0] for r in rows),
                           np.int64)
            for pi in stoch:
                for j, (s, r) in enumerate(plans[pi].draft_at):
                    qsrc[pi, j] = q_at[s] + r
            all_q = torch.cat(rows + [self._zero_q()])
            accept["q"] = all_q[self._upload(qsrc.reshape(-1))].view(
                p_pad, k_cap, -1)
        chunk_sampling = (eng._pack_sampling(chunk_meta, c_pad)
                          if chunk_meta else None)

        tok, caches = self._operands(entries, sample_ids, len(sample_ids))
        if fill_at:
            tok[0, self._upload(np.asarray(fill_at, np.int64))] = \
                all_tok[self._upload(np.asarray(fill_src, np.int64))]
        with profiling.annotate("paged_verify_accept_step"):
            commit, m, chunk_tok, new_caches = eng._verify_accept(
                self.target_params, caches, tok, accept, chunk_sampling)
        self.cache.update_pools(new_caches)
        return commit, m, chunk_tok, [finish_rows.get(seat)
                                      for seat, _, _, _ in chunks]

    def _read_commit(self, out):
        """The round's one synchronisation: the int32 commit, accepted
        counts and chunk first tokens to the host. Returns the commits and
        accepted counts of every plan row (pads included) and the
        finishing chunks' first tokens."""
        commit_d, m_d, chunk_d, chunk_rows = out
        commit_h, m_h = commit_d.cpu().numpy(), m_d.cpu().numpy()
        chunk_h = None if chunk_d is None else chunk_d.cpu().numpy()
        commits = [[int(x) for x in commit_h[pi, : int(m_h[pi]) + 1]]
                   for pi in range(len(m_h))]
        firsts = [int(chunk_h[r]) for r in chunk_rows if r is not None]
        return commits, [int(x) for x in m_h], firsts

    # ----------------------------------------------------------- commit

    def _apply_commit(self, plans: List[RoundPlan], chunks, commits,
                      m_all, firsts) -> None:
        """Extend sequences by their committed tokens, roll both slots back
        past the rejected tails, and commit the prefill chunks. ``commits``
        and ``m_all`` are read in plan order (rows past the plans are pads);
        ``firsts`` are the finishing chunks' first tokens in chunk order."""
        eng, metrics = self.engine, self.metrics
        drafted = verified = accepted_total = committed_total = 0
        drafting_seqs = sum(1 for p in plans if p.k > 0)
        for p, commit, m in zip(plans, commits, m_all):
            commit = commit[: p.seq.remaining]
            decision = self.spec.observe_round(p.seq, p.k, m)
            if decision is not None and self.tracer.enabled:
                self.tracer.instant("adaptive_k", CAT_SCHED, args=decision)
            drafted += p.k
            verified += p.k + 1
            accepted_total += m
            committed_total += len(commit)
            self._stream_commit(p.seq, commit)
            p.seq.generated.extend(commit)
            for _ in commit:
                metrics.on_token(p.seq.req_id)
            if p.seq.done:
                self.batcher.leave(p.seat)
                self._free_pair(p.seat)
                eng._finish(p.seq, metrics, self.results)
                continue
            # rollback: rejected verify room and rejected draft tail
            self.cache.truncate_slot(p.seat, p.committed + m)
            if p.k > 0:
                self.cache.truncate_slot(
                    self._draft_slot(p.seat),
                    min(p.committed + m, p.committed + p.k - 1))
            self.batcher.feed(p.seat, commit[-1])

        # prefill chunks commit exactly as in the mixed engine
        total_chunk = 0
        firsts = iter(firsts)
        for seat, seq, start, n in chunks:
            seq.prefill_pos = start + n
            total_chunk += n
            metrics.on_prefill_chunk(n)
            self.cache.register_prefix(seat, seq.request.prompt,
                                       seq.prefill_pos)
            if seq.prefill_pos == seq.prompt_len:
                metrics.on_prefill_end(seq.req_id)
                first = next(firsts)
                self._stream_commit(seq, [first])
                seq.generated.append(first)
                metrics.on_first_token(seq.req_id)
                if seq.done:                     # max_new_tokens == 1
                    self.batcher.leave(seat)
                    self._free_pair(seat)
                    eng._finish(seq, metrics, self.results)
                else:
                    self.batcher.to_decoding(seat, first)

        metrics.on_mixed_step(committed_total, total_chunk,
                              self.cache.occupancy())
        if plans:
            metrics.on_spec_round(drafted, verified, accepted_total,
                                  drafting_seqs)
