"""Admission + budget-aware scheduling for the elastic engine.

Routing: ``Request.budget`` (fraction of full deployed params) maps onto a
row of the nested FlexRank profile table via a cost table computed ONCE at
construction (the seed recomputed the whole O(rows) table per request).
Requests are queued FIFO per budget row; the engine serves one GAR-deployed
row at a time (different rows are different realized weights, so they cannot
share a forward), and within the active row new requests join the running
batch at iteration granularity.

Preemption: when the paged cache cannot cover the next token for every
running sequence, the scheduler picks victims youngest-first (latest
admission), frees their blocks, and re-queues them at the FRONT of their row
queue for recompute — greedy decode makes the recomputed tokens identical.
A victim may be *mid-prefill* (chunked-prefill engine): its partial chunk
progress is discarded along with its blocks and it restarts from scratch.

Sequence state machine (chunked-prefill engine)::

    waiting --admit--> prefilling --last chunk--> decoding --max_new--> done
       ^                   |                         |
       +----- preempt -----+------------ preempt ----+

``waiting``: queued in its budget row, holds no slot and no blocks.
``prefilling``: seated in a batch slot; each mixed iteration may push one
chunk of up to ``prefill_chunk`` prompt tokens through the forward, under
the iteration's token budget (decode tokens are reserved first, so a long
prefill can never starve running decodes). ``decoding``: one token per
iteration. Preemption from either seated state frees the blocks and
re-queues at the row front (recompute). The drain/PR-1 continuous paths
collapse prefilling into a single admission-time forward.

``Scheduler.plan_prefill_chunks`` is the per-iteration budget accounting:
FIFO over seated prefilling sequences, each clipped to the chunk knob, the
remaining prompt, and the remaining budget. ``Scheduler.split_spec_extras``
is its speculative sibling: a round-robin fair split of one speculative
round's leftover tokens across the decoding sequences' (possibly
adaptive-k, hence unequal) draft-length wants, so a round's worst-case
``k + 1`` verify tokens per sequence always respect the token budget.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.obs import CAT_SCHED, NULL_TRACER
from repro_torch.serving.sampling import SamplerState, SamplingParams


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # (S_prompt,) int32
    max_new_tokens: int = 16
    budget: float = 1.0         # relative size in (0, 1]
    # per-request sampling (None = greedy argmax, the default)
    sampling: Optional[SamplingParams] = None
    # per-request speculative draft length override: None = engine default,
    # 0 = disable speculation for this request (plain decode)
    spec_len: Optional[int] = None


@dataclasses.dataclass
class Result:
    tokens: np.ndarray
    budget_row: int
    deployed_params: int
    ttft_s: Optional[float] = None
    # client cancelled mid-flight: ``tokens`` holds the prompt plus whatever
    # was generated (and delivered) before the cancellation took effect
    cancelled: bool = False


@dataclasses.dataclass
class Sequence:
    """One admitted request's scheduling state."""
    req_id: int
    request: Request
    row: int
    generated: List[int] = dataclasses.field(default_factory=list)
    admissions: int = 0          # >1 after preemption
    state: str = "waiting"       # waiting | prefilling | decoding
    prefill_pos: int = 0         # prompt tokens already pushed through
    sampler: Optional[SamplerState] = None   # set at submit
    # adaptive-k speculative-decoding controller state (spec/config.py
    # reads and writes these; None/0 until the sequence first drafts):
    spec_k: Optional[int] = None            # current per-sequence draft length
    spec_accept_ewma: Optional[float] = None  # trailing acceptance-rate EWMA
    spec_idle_rounds: int = 0               # rounds parked at k = 0 (probe timer)

    @property
    def prompt_len(self) -> int:
        return len(self.request.prompt)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.request.max_new_tokens

    @property
    def prefill_remaining(self) -> int:
        return self.prompt_len - self.prefill_pos

    @property
    def remaining(self) -> int:
        return self.request.max_new_tokens - len(self.generated)

    def snapshot(self) -> dict:
        """Copy of every mutable scheduling field, for speculative-plan
        rollback (the pipelined engine) and the double-buffered-state test
        harness. ``request``/``req_id``/``row`` are immutable per sequence
        and excluded."""
        return {"generated": list(self.generated),
                "admissions": self.admissions, "state": self.state,
                "prefill_pos": self.prefill_pos, "spec_k": self.spec_k,
                "spec_accept_ewma": self.spec_accept_ewma,
                "spec_idle_rounds": self.spec_idle_rounds,
                "sampler_state": (None if self.sampler is None
                                  else self.sampler.state_snapshot())}

    def restore(self, snap: dict) -> None:
        self.generated[:] = snap["generated"]
        self.admissions = snap["admissions"]
        self.state = snap["state"]
        self.prefill_pos = snap["prefill_pos"]
        self.spec_k = snap["spec_k"]
        self.spec_accept_ewma = snap["spec_accept_ewma"]
        self.spec_idle_rounds = snap["spec_idle_rounds"]
        if self.sampler is not None:
            self.sampler.state_restore(snap["sampler_state"])

    def reset_for_recompute(self) -> None:
        self.generated.clear()
        self.prefill_pos = 0
        self.state = "waiting"
        # adaptive-k controller restarts with the sequence: the recomputed
        # attempt re-derives its draft-length trajectory from scratch, so a
        # run with preemption stays a deterministic function of the workload
        self.spec_k = None
        self.spec_accept_ewma = None
        self.spec_idle_rounds = 0
        if self.sampler is not None:
            # recompute must replay the same stochastic draws token-for-token
            self.sampler.reset()


class BudgetRouter:
    """budget fraction -> profile-table row, from a precomputed cost table."""

    def __init__(self, cost_table: np.ndarray):
        self.cost_table = np.asarray(cost_table, np.int64)
        self._fractions = self.cost_table / float(self.cost_table[-1])

    def route(self, budget: float) -> int:
        # relative float tolerance only: ``budget * total`` computed from a
        # row's own fraction must round-trip back to that row, but a row
        # even 1 param over the requested budget is infeasible (the old
        # ``+ 1`` integer slack admitted such rows on fine-grained tables)
        limit = budget * float(self.cost_table[-1]) * (1.0 + 1e-9)
        feasible = np.flatnonzero(self.cost_table <= limit)
        return int(feasible[-1]) if feasible.size else 0

    def deployed_params(self, row: int) -> int:
        return int(self.cost_table[row])


class Scheduler:
    def __init__(self, router: BudgetRouter, *, tracer=None):
        self.router = router
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.queues: Dict[int, Deque[Sequence]] = {}
        self._next_id = 0
        self._order: Deque[int] = deque()   # row service order (FIFO arrival)

    def submit(self, request: Request) -> Sequence:
        row = self.router.route(request.budget)
        seq = Sequence(req_id=self._next_id, request=request, row=row)
        seq.sampler = SamplerState(request.sampling, seq.req_id)
        self._next_id += 1
        self.queues.setdefault(row, deque()).append(seq)
        if self.tracer.enabled:
            self.tracer.instant(
                "route", CAT_SCHED,
                args={"req": seq.req_id, "budget": request.budget,
                      "row": row, "reason": "largest_feasible_row"})
        return seq

    def requeue_front(self, seq: Sequence) -> None:
        """Preempted sequence: recompute from scratch, ahead of its row queue."""
        seq.reset_for_recompute()
        self.queues.setdefault(seq.row, deque()).appendleft(seq)
        if self.tracer.enabled:
            self.tracer.instant(
                "requeue", CAT_SCHED,
                args={"req": seq.req_id, "row": seq.row,
                      "reason": "preempt_recompute"})

    def pending_rows(self) -> List[int]:
        return [r for r, q in self.queues.items() if q]

    def next_row(self) -> Optional[int]:
        """Row with the oldest waiting request (FIFO across rows)."""
        best, best_id = None, None
        for r, q in self.queues.items():
            if q and (best_id is None or q[0].req_id < best_id):
                best, best_id = r, q[0].req_id
        return best

    def pop(self, row: int) -> Optional[Sequence]:
        q = self.queues.get(row)
        if not q:
            return None
        seq = q.popleft()
        seq.admissions += 1
        return seq

    def has_waiting(self, row: Optional[int] = None) -> bool:
        if row is None:
            return any(q for q in self.queues.values())
        return bool(self.queues.get(row))

    def remove_waiting(self, seq: Sequence) -> bool:
        """Drop a still-queued sequence (client cancellation before
        admission). Returns False if the sequence is not waiting in its
        row queue (already seated, finished, or never submitted here)."""
        q = self.queues.get(seq.row)
        if q is None:
            return False
        try:
            q.remove(seq)
        except ValueError:
            return False
        if self.tracer.enabled:
            self.tracer.instant(
                "cancel_waiting", CAT_SCHED,
                args={"req": seq.req_id, "row": seq.row,
                      "reason": "client_cancel"})
        return True

    def snapshot(self, row: Optional[int] = None) -> dict:
        """Copy of the queue structure (sequence objects by reference; their
        fields snapshot via ``Sequence.snapshot``). With ``row`` set, only
        that row's queue is captured — the pipelined engine speculates
        within one budget row and other queues cannot change under it."""
        if row is not None:
            return {"row": row,
                    "queue": list(self.queues.get(row, ())),
                    "next_id": self._next_id}
        return {"row": None,
                "queues": {r: list(q) for r, q in self.queues.items()},
                "next_id": self._next_id}

    def restore(self, snap: dict) -> None:
        if snap["row"] is not None:
            self.queues[snap["row"]] = deque(snap["queue"])
        else:
            self.queues = {r: deque(q) for r, q in snap["queues"].items()}
        self._next_id = snap["next_id"]

    @staticmethod
    def pick_victim(active: List[Sequence]) -> Sequence:
        """Youngest-first preemption: least sunk work is thrown away. The
        victim pool spans both decoding and mid-prefill sequences — a
        half-prefilled youngster is evicted before any older sequence."""
        return max(active, key=lambda s: s.req_id)

    @staticmethod
    def plan_prefill_chunks(prefilling: List[Sequence], budget: int,
                            chunk: int, order: str = "fifo") -> List[tuple]:
        """Per-iteration prefill budget accounting.

        ``prefilling``: seated sequences in admission (FIFO) order;
        ``budget``: tokens left this iteration after the decode batch took
        one slot each; ``chunk``: the prefill-chunk knob. Returns
        ``[(seq, n), ...]`` with every ``n >= 1``, each clipped to
        ``min(chunk, seq.prefill_remaining, budget_left)``.

        ``order`` picks who gets budgeted first when it spills over:
        ``"fifo"`` (default) budgets admission order, so within a budget row
        prompts finish prefilling in admission order; ``"srpf"``
        (shortest-remaining-prefill-first) budgets the sequence closest to
        finishing its prompt, draining near-done prefills into decoders
        sooner at the cost of FIFO completion (ties break by admission
        order, so equal-remaining sequences never starve each other).
        Cache-capacity clipping happens in the engine (it may shrink ``n``
        further when the free list is low).
        """
        if order not in ("fifo", "srpf"):
            raise ValueError(f"unknown prefill order {order!r}")
        if order == "srpf":
            prefilling = sorted(prefilling,
                                key=lambda s: (s.prefill_remaining, s.req_id))
        plan = []
        for seq in prefilling:
            if budget <= 0:
                break
            n = min(chunk, seq.prefill_remaining, budget)
            if n <= 0:
                continue
            plan.append((seq, n))
            budget -= n
        return plan

    @staticmethod
    def split_spec_extras(wants: List[int], extras: int) -> List[int]:
        """Fair split of one speculative round's extras budget.

        ``wants[i]`` is sequence ``i``'s requested draft length this round
        (the adaptive-k controller's output); ``extras`` is the round's
        token budget left after every decoding sequence reserved its one
        mandatory verify token (and seated prefills their chunk). Grants are
        dealt round-robin, one draft token per sequence per lap, so a tight
        budget shaves every deep drafter evenly instead of letting the
        earliest seats hoard the budget and starve the rest (with adaptive
        k, per-sequence wants diverge — first-come allocation would
        systematically bias which sequences get to speculate). When
        ``extras >= sum(wants)`` the grants are exactly the wants.
        """
        grants = [0] * len(wants)
        left = max(0, extras)
        while left > 0:
            progressed = False
            for i, w in enumerate(wants):
                if left <= 0:
                    break
                if grants[i] < w:
                    grants[i] += 1
                    left -= 1
                    progressed = True
            if not progressed:
                break
        return grants
