"""Iteration-level batching: fixed decode slots that sequences join and
leave *mid-decode*, instead of draining the whole batch before admitting new
work (Orca-style continuous batching).

Two ways into a slot: ``join`` seats an already-prefilled sequence directly
in the ``decoding`` state (the drain/PR-1 continuous path), while
``seat_prefill`` seats a freshly admitted sequence in the ``prefilling``
state — the chunked-prefill engine then pushes its prompt through one chunk
per mixed iteration and flips it to ``decoding`` via ``to_decoding`` when
the last chunk lands. ``prefill_slots()`` iterates prefilling seats in
admission order, which is what makes per-row chunk scheduling FIFO.

The batcher owns only slot state — which sequence sits where, what state it
is in, and what token it feeds next. Block accounting lives in ``kv_cache``;
admission policy in ``scheduler``; the engine composes the three.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.serving.scheduler import Sequence


class ContinuousBatcher:
    def __init__(self, max_batch: int):
        self.max_batch = max_batch
        self.slots: List[Optional[Sequence]] = [None] * max_batch
        self._next_token = np.zeros(max_batch, np.int32)
        self._seated_at = np.zeros(max_batch, np.int64)   # admission order
        self._seat_counter = 0

    # ------------------------------------------------------------- slots

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def decode_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and s.state == "decoding"]

    def prefill_slots(self) -> List[int]:
        """Slots holding mid-prefill sequences, in admission (FIFO) order."""
        slots = [i for i, s in enumerate(self.slots)
                 if s is not None and s.state == "prefilling"]
        return sorted(slots, key=lambda i: self._seated_at[i])

    def active_sequences(self) -> List[Sequence]:
        return [s for s in self.slots if s is not None]

    @property
    def num_active(self) -> int:
        return len(self.active_slots())

    def slot_of(self, seq: Sequence) -> int:
        for i, s in enumerate(self.slots):
            if s is seq:
                return i
        raise KeyError(seq.req_id)

    # -------------------------------------------------------- join/leave

    def _seat(self, slot: int, seq: Sequence) -> None:
        assert self.slots[slot] is None, slot
        self.slots[slot] = seq
        self._seated_at[slot] = self._seat_counter
        self._seat_counter += 1

    def join(self, slot: int, seq: Sequence, first_token: int) -> None:
        """Seat an already-prefilled sequence; it decodes from
        ``first_token`` on the next iteration, alongside whatever is already
        mid-flight."""
        self._seat(slot, seq)
        seq.state = "decoding"
        self._next_token[slot] = first_token

    def seat_prefill(self, slot: int, seq: Sequence) -> None:
        """Seat a freshly admitted sequence for chunked prefill: it owns the
        slot but feeds no decode token until its last chunk lands."""
        self._seat(slot, seq)
        seq.state = "prefilling"
        self._next_token[slot] = 0

    def to_decoding(self, slot: int, first_token: int) -> None:
        """Last prefill chunk landed: the sequence decodes from
        ``first_token`` starting next iteration."""
        seq = self.slots[slot]
        assert seq is not None and seq.state == "prefilling", slot
        seq.state = "decoding"
        self._next_token[slot] = first_token

    def leave(self, slot: int) -> Sequence:
        seq = self.slots[slot]
        assert seq is not None, slot
        self.slots[slot] = None
        self._next_token[slot] = 0
        return seq

    # ------------------------------------------- speculative-plan rollback

    def snapshot(self) -> dict:
        """Copy of the slot assignments and feed state. Sequence *objects*
        are captured by reference — their mutable fields are snapshotted
        separately (``Sequence.snapshot``) by whoever coordinates the
        rollback."""
        return {"slots": list(self.slots),
                "next_token": self._next_token.copy(),
                "seated_at": self._seated_at.copy(),
                "seat_counter": self._seat_counter}

    def restore(self, snap: dict) -> None:
        self.slots = list(snap["slots"])
        self._next_token = snap["next_token"].copy()
        self._seated_at = snap["seated_at"].copy()
        self._seat_counter = snap["seat_counter"]

    # ------------------------------------------------------- device step

    def next_token(self, slot: int) -> int:
        return int(self._next_token[slot])

    def feed(self, slot: int, token: int) -> None:
        """Set the token a decoding slot feeds next iteration directly.
        Speculative rounds commit several tokens at once via the sequence's
        ``generated`` list and only the last one is ever fed, so they bypass
        ``advance`` (which records exactly one token per slot)."""
        seq = self.slots[slot]
        assert seq is not None and seq.state == "decoding", slot
        self._next_token[slot] = token

    def feed_tokens(self) -> np.ndarray:
        """(B, 1) int32 next-token batch (idle slots feed token 0)."""
        return self._next_token[:, None].copy()

    def advance(self, sampled: np.ndarray) -> List[int]:
        """Record one decode iteration's sampled tokens (B,). Only decoding
        slots advance (mid-prefill seats produced no decode token this
        iteration). Returns slots whose sequence just finished."""
        finished = []
        for i, seq in enumerate(self.slots):
            if seq is None or seq.state != "decoding":
                continue
            tok = int(sampled[i])
            seq.generated.append(tok)
            self._next_token[i] = tok
            if seq.done:
                finished.append(i)
        return finished
