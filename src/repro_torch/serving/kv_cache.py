"""Block-paged KV cache: a global pool of fixed-size blocks per attention
layer, a host-side refcounted allocator with automatic prefix caching, and
per-slot block tables.

Memory layout (vLLM-style, adapted to scanned segments): every attention
segment owns K/V pools shaped (count, num_blocks, block_size, Hkv, hd) —
``count`` stacked layers share one *block id space*, so a sequence holds one
block table that addresses the same slots in every layer's pool. Block 0 is
the reserved null block: it backs unused table entries and idle batch slots,
so device-side gathers never index out of bounds.

Prefix caching: blocks carry a refcount, and full blocks of prompt tokens are
indexed by the exact token prefix they hold. A newly admitted request probes
the index block by block; every hit shares the existing block (refcount++)
and skips its prefill entirely. Blocks whose refcount drops to zero while
still indexed stay resurrectable in a warm LRU tier until the pool needs them
back. Writes into a block visible to more than one holder copy-on-write the
block on device first; writes into an indexed block drop its index entry
(the canonical content is about to diverge).

The allocator is deliberately host-side numpy (free list + LIFO reuse):
allocation decisions happen between device steps, at batch-slot
granularity. The pools are torch tensors on the engine's device, updated
in place by the forward's K/V scatter and by copy-on-write.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import math
import os
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.obs import CAT_ALLOC, NULL_TRACER

NULL_BLOCK = 0


class CacheOOM(Exception):
    """Raised when the block pool cannot cover an allocation request."""


class FreeRunTracker:
    """Incrementally maintained id-contiguous runs over the free-block set.

    Replaces the old per-query ``sorted(free_list)`` scan — O(F log F) on the
    host hot path every iteration — with O(log F) amortised updates on each
    alloc/free and an O(1) amortised max-run query (lazy-deletion heap).
    Runs are kept as start->end / end->start maps plus a sorted list of run
    starts so that removing an *interior* block (prefix-hit resurrection
    picks specific ids, not LIFO order) can find its containing run.
    """

    def __init__(self, lo: int, hi: int):
        # one full run [lo, hi] (empty when hi < lo)
        self._heads: Dict[int, int] = {}      # run start -> run end
        self._tails: Dict[int, int] = {}      # run end -> run start
        self._starts: List[int] = []          # sorted run starts
        self._heap: List = []                 # lazy max-heap of (-len, start)
        self.count = 0
        if hi >= lo:
            self._new_run(lo, hi)
            self.count = hi - lo + 1

    def _new_run(self, s: int, e: int) -> None:
        self._heads[s] = e
        self._tails[e] = s
        bisect.insort(self._starts, s)
        heapq.heappush(self._heap, (-(e - s + 1), s))

    def _drop_run(self, s: int) -> int:
        e = self._heads.pop(s)
        del self._tails[e]
        i = bisect.bisect_left(self._starts, s)
        del self._starts[i]
        return e

    def add(self, b: int) -> None:
        """Block ``b`` became free: merge with adjacent runs."""
        left = self._tails.get(b - 1)
        right = self._heads.get(b + 1)
        s = b if left is None else left
        e = b if right is None else right
        if left is not None:
            self._drop_run(left)
        if right is not None:
            self._drop_run(b + 1)
        self._new_run(s, e)
        self.count += 1

    def remove(self, b: int) -> None:
        """Block ``b`` left the free set: split its containing run."""
        i = bisect.bisect_right(self._starts, b) - 1
        assert i >= 0, b
        s = self._starts[i]
        e = self._drop_run(s)
        assert s <= b <= e, (s, b, e)
        if s <= b - 1:
            self._new_run(s, b - 1)
        if b + 1 <= e:
            self._new_run(b + 1, e)
        self.count -= 1

    def max_run(self) -> int:
        while self._heap:
            neg, s = self._heap[0]
            e = self._heads.get(s)
            if e is not None and e - s + 1 == -neg:
                return -neg
            heapq.heappop(self._heap)       # stale entry from a merged run
        return 0

    def snapshot(self) -> tuple:
        """Copy of the full run state, for speculative-plan rollback."""
        return (dict(self._heads), dict(self._tails), list(self._starts),
                list(self._heap), self.count)

    def restore(self, snap: tuple) -> None:
        heads, tails, starts, heap, count = snap
        self._heads = dict(heads)
        self._tails = dict(tails)
        self._starts = list(starts)
        self._heap = list(heap)
        self.count = count


class BlockAllocator:
    """Refcounted block pool; block 0 is never handed out.

    Free blocks live in two tiers: a plain LIFO list (``_free``) for blocks
    with no cached content, and a warm FIFO tier (``_cached``) for blocks the
    prefix index still references — those are only recycled (oldest first,
    via ``evict_hook``) once the plain tier runs dry, so recently shared
    prefixes survive as long as the pool allows. ``free_count`` counts both
    tiers: every block in either is reclaimable on demand.
    """

    def __init__(self, num_blocks: int,
                 evict_hook: Optional[Callable[[int], None]] = None):
        assert num_blocks >= 2, num_blocks
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        self._ref = np.zeros(num_blocks, np.int32)
        self._is_cached = np.zeros(num_blocks, bool)
        self._runs = FreeRunTracker(1, num_blocks - 1)
        self.evict_hook = evict_hook
        self._alloc_log: Optional[List[int]] = None

    @property
    def free_count(self) -> int:
        return len(self._free) + len(self._cached)

    @property
    def cached_free_count(self) -> int:
        return len(self._cached)

    def refcount(self, b: int) -> int:
        return int(self._ref[b])

    def live_blocks(self) -> List[int]:
        return [b for b in range(1, self.num_blocks) if self._ref[b] > 0]

    def alloc(self, n: int) -> List[int]:
        if n > self.free_count:
            raise CacheOOM(f"need {n} blocks, {self.free_count} free")
        out = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:
                # recycle the oldest warm block; the hook (PagedKVCache)
                # drops its prefix-index entry before the id is reused
                b, _ = self._cached.popitem(last=False)
                self._is_cached[b] = False
                if self.evict_hook is not None:
                    self.evict_hook(b)
            self._ref[b] = 1
            self._runs.remove(b)
            if self._alloc_log is not None:
                self._alloc_log.append(b)
            out.append(b)
        return out

    def begin_alloc_log(self) -> None:
        """Record every block id handed out until ``end_alloc_log``. The
        pipelined engine opens a log around each speculative plan: an
        abandoned dispatch has WRITTEN device K/V into the blocks it
        allocated, so after the host rollback those blocks' prefix-index
        entries must drop and any sequence that (post-restore) still holds
        one must recompute."""
        self._alloc_log = []

    def end_alloc_log(self) -> List[int]:
        out = self._alloc_log if self._alloc_log is not None else []
        self._alloc_log = None
        return out

    def incref(self, b: int) -> None:
        assert self._ref[b] >= 1, f"incref of free block {b}"
        self._ref[b] += 1

    def decref(self, b: int) -> bool:
        """Drop one reference; returns True if the block became free."""
        assert self._ref[b] >= 1, f"double free of block {b}"
        self._ref[b] -= 1
        if self._ref[b] > 0:
            return False
        if self._is_cached[b]:
            self._cached[b] = None          # warm tier: resurrectable
        else:
            self._free.append(b)
        self._runs.add(b)
        return True

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            self.decref(b)

    def take(self, b: int) -> None:
        """Resurrect a specific warm free block (prefix hit on a block whose
        last holder already left)."""
        assert self._ref[b] == 0 and b in self._cached, b
        del self._cached[b]
        self._ref[b] = 1
        self._runs.remove(b)

    def set_cached(self, b: int, flag: bool) -> None:
        """Mark/unmark a *live* block as referenced by the prefix index."""
        assert self._ref[b] >= 1, b
        self._is_cached[b] = flag

    def uncache(self, b: int) -> None:
        """Drop the index mark; moves a warm free block to the plain tier."""
        self._is_cached[b] = False
        if self._ref[b] == 0 and b in self._cached:
            del self._cached[b]
            self._free.append(b)

    def fragmentation(self) -> float:
        """Free-list fragmentation in [0, 1]: ``1 - largest contiguous run
        of free block ids / free blocks``. 0 when every free block sits in
        one id-contiguous run (or the list is empty); approaches 1 when the
        free ids are scattered singletons. Id-contiguity is the proxy that
        matters here: contiguous runs are what LIFO reuse hands back to the
        next multi-block allocation as a dense table extent. Served from the
        incremental run tracker — O(1) amortised instead of sorting the free
        list on every engine iteration."""
        n = self._runs.count
        if n == 0:
            return 0.0
        return 1.0 - self._runs.max_run() / n

    def snapshot(self) -> tuple:
        """Copy of every mutable allocator structure (the evict hook is
        configuration, not state). Restoring twice from one snapshot is
        legal — every ``restore`` re-copies."""
        return (list(self._free), list(self._cached), self._ref.copy(),
                self._is_cached.copy(), self._runs.snapshot())

    def restore(self, snap: tuple) -> None:
        free, cached, ref, is_cached, runs = snap
        self._free = list(free)
        self._cached = OrderedDict((b, None) for b in cached)
        self._ref = ref.copy()
        self._is_cached = is_cached.copy()
        self._runs.restore(runs)

    def fragmentation_exact(self) -> float:
        """Reference implementation (full sort) for parity tests."""
        ids = sorted(self._free) + sorted(self._cached)
        ids.sort()
        if not ids:
            return 0.0
        best = run = 1
        for a, b in zip(ids, ids[1:]):
            run = run + 1 if b == a + 1 else 1
            if run > best:
                best = run
        return 1.0 - best / len(ids)


@dataclasses.dataclass
class SlotState:
    """Host bookkeeping for one batch slot."""
    blocks: List[int]
    num_tokens: int = 0          # tokens written (prompt + generated)


@dataclasses.dataclass
class PrefixCacheStats:
    """Cumulative prefix-cache counters for one PagedKVCache."""
    hits: int = 0                # admissions that matched >= 1 block
    misses: int = 0              # admissions that matched nothing
    hit_tokens: int = 0          # prompt tokens skipped via hits
    shared_tokens: int = 0       # draft-slot tokens aliased from targets
    cow_copies: int = 0          # device block copies on shared-block writes
    evictions: int = 0           # warm blocks recycled out of the index


def _env_prefix_cache_default() -> bool:
    return os.environ.get("REPRO_PREFIX_CACHE", "0") == "1"


class PagedKVCache:
    """Device block pools + host allocator + per-slot block tables.

    ``max_batch`` fixed decode slots; each slot's table covers up to
    ``max_blocks_per_seq`` blocks. ``num_blocks`` counts usable blocks
    (the null block is allocated on top). With ``prefix_cache`` on, full
    prompt blocks are indexed by their exact token prefix and shared across
    slots (see module docstring); off, the allocator degenerates to the
    plain refcount-1 free list and every probe is a miss.
    """

    def __init__(self, cfg: ModelConfig, *, max_batch: int, max_len: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 dtype=torch.float32, prefix_cache: Optional[bool] = None,
                 device=None):
        assert block_size >= 1
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.block_size = block_size
        self.max_blocks_per_seq = math.ceil(max_len / block_size)
        # pow2 ceiling of the table width: the widest table a forward may
        # see. active_max_blocks buckets into {1, 2, 4, ..., padded}, the
        # widths the JAX engine compiles for, so operand layouts match it
        # row for row.
        self.padded_max_blocks = 1
        while self.padded_max_blocks < self.max_blocks_per_seq:
            self.padded_max_blocks *= 2
        self._seen_widths: set = set()
        if num_blocks is None:
            num_blocks = max_batch * self.max_blocks_per_seq
        if prefix_cache is None:
            prefix_cache = _env_prefix_cache_default()
        self.prefix_cache = bool(prefix_cache)
        self.device = resolve_device(device)
        self.allocator = BlockAllocator(num_blocks + 1,   # +1: null block
                                        evict_hook=self._on_evict)
        hd = cfg.resolved_head_dim
        self.pools = []
        for seg in cfg.segments:
            shape = (seg.count, num_blocks + 1, block_size,
                     cfg.num_kv_heads, hd)
            self.pools.append(
                {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                 "v": torch.zeros(shape, dtype=dtype, device=self.device)})
        self.slots: List[Optional[SlotState]] = [None] * max_batch
        self._tables = np.full((max_batch, self.max_blocks_per_seq),
                               NULL_BLOCK, np.int32)
        # prefix index: exact token-prefix bytes -> block id holding the
        # final block of that prefix, plus the reverse map for eviction.
        # Keys are the raw int32 token bytes — collision-free by design.
        self._prefix_index: Dict[bytes, int] = {}
        self._block_key: Dict[int, bytes] = {}
        self.stats = PrefixCacheStats()
        # observability: the engine points this at its Tracer; the default
        # null tracer keeps every event site a single attribute check
        self.tracer = NULL_TRACER

    # ------------------------------------------------------------- alloc

    def blocks_needed(self, num_tokens: int) -> int:
        return math.ceil(num_tokens / self.block_size)

    def can_allocate(self, num_tokens: int) -> bool:
        return self.blocks_needed(num_tokens) <= self.allocator.free_count

    def allocate_slot(self, slot: int, num_tokens: int) -> SlotState:
        """Claim a slot and the blocks covering ``num_tokens`` (the prompt)."""
        assert self.slots[slot] is None, f"slot {slot} busy"
        if num_tokens > self.max_len:
            raise CacheOOM(f"sequence of {num_tokens} tokens exceeds "
                           f"max_len {self.max_len}")
        blocks = self.allocator.alloc(self.blocks_needed(num_tokens))
        st = SlotState(blocks=blocks, num_tokens=num_tokens)
        self.slots[slot] = st
        self._tables[slot, :] = NULL_BLOCK
        self._tables[slot, : len(blocks)] = blocks
        if self.tracer.enabled:
            self.tracer.instant(
                "block_alloc", CAT_ALLOC,
                args={"slot": slot, "blocks": len(blocks),
                      "tokens": num_tokens,
                      "free": self.allocator.free_count})
        return st

    def open_slot(self, slot: int) -> SlotState:
        """Claim a slot with no blocks yet (chunked prefill grows it via
        ``extend_slot`` one chunk at a time instead of reserving the whole
        prompt up front)."""
        assert self.slots[slot] is None, f"slot {slot} busy"
        st = SlotState(blocks=[], num_tokens=0)
        self.slots[slot] = st
        self._tables[slot, :] = NULL_BLOCK
        return st

    def extend_slot(self, slot: int, n: int, *, clip: bool = False) -> int:
        """Reserve room for ``n`` more tokens (a prefill chunk), allocating
        blocks on demand. With ``clip=True`` the chunk shrinks to whatever
        the free list can cover right now (possibly 0) instead of raising —
        the mixed-iteration scheduler retries the remainder next iteration.
        Returns the number of tokens actually reserved."""
        st = self.slots[slot]
        assert st is not None, slot
        if st.num_tokens + n > self.max_len:
            raise CacheOOM(f"slot {slot}: {st.num_tokens + n} tokens exceed "
                           f"max_len {self.max_len}")
        slack = len(st.blocks) * self.block_size - st.num_tokens
        free = self.allocator.free_count
        if slack and self._boundary_needs_cow(slot):
            # writing into the partial boundary block requires a private
            # copy first, which consumes one free block before any growth
            cap = 0 if free == 0 else slack + (free - 1) * self.block_size
        else:
            cap = slack + free * self.block_size
        if n > cap:
            if not clip:
                raise CacheOOM(f"need room for {n} tokens, {cap} available")
            n = max(0, cap)
        if n == 0:
            return 0
        self._make_boundary_writable(slot)
        need = self.blocks_needed(st.num_tokens + n) - len(st.blocks)
        if need > 0:
            fresh = self.allocator.alloc(need)
            self._tables[slot, len(st.blocks): len(st.blocks) + need] = fresh
            st.blocks.extend(fresh)
            if self.tracer.enabled:
                self.tracer.instant(
                    "block_alloc", CAT_ALLOC,
                    args={"slot": slot, "blocks": need, "tokens": n,
                          "free": self.allocator.free_count})
        st.num_tokens += n
        return n

    def append_token(self, slot: int) -> None:
        """Reserve room for one more token; grabs a fresh block on boundary."""
        st = self.slots[slot]
        assert st is not None, slot
        if st.num_tokens + 1 > self.max_len:
            raise CacheOOM(f"slot {slot} exceeds max_len {self.max_len}")
        if self.blocks_needed(st.num_tokens + 1) > len(st.blocks):
            (b,) = self.allocator.alloc(1)
            st.blocks.append(b)
            self._tables[slot, len(st.blocks) - 1] = b
            if self.tracer.enabled:
                self.tracer.instant(
                    "block_alloc", CAT_ALLOC,
                    args={"slot": slot, "blocks": 1, "tokens": 1,
                          "free": self.allocator.free_count})
        else:
            self._make_boundary_writable(slot)
        st.num_tokens += 1

    def token_append_needs_block(self, slot: int) -> bool:
        """True when the next ``append_token`` must allocate: either the
        write position sits on a block boundary, or it lands inside a block
        shared with another holder (copy-on-write needs a fresh block)."""
        st = self.slots[slot]
        if st is None:
            return False
        if st.num_tokens % self.block_size == 0:
            return True
        return self._boundary_needs_cow(slot)

    def truncate_slot(self, slot: int, num_tokens: int) -> int:
        """Rollback: rewind the slot's write position to ``num_tokens`` and
        release the blocks past the new boundary (speculative decoding frees
        rejected draft tokens this way — the slot stays seated, only its
        tail is discarded). Stale K/V inside the kept blocks is harmless:
        attention masks by context length and later writes overwrite in
        place. Returns the number of blocks released."""
        st = self.slots[slot]
        assert st is not None, slot
        assert 0 <= num_tokens <= st.num_tokens, (num_tokens, st.num_tokens)
        keep = self.blocks_needed(num_tokens)
        old_tokens = st.num_tokens
        released = len(st.blocks) - keep
        if released > 0:
            self.allocator.free(st.blocks[keep:])
            self._tables[slot, keep: len(st.blocks)] = NULL_BLOCK
            del st.blocks[keep:]
        st.num_tokens = num_tokens
        if self.tracer.enabled:
            self.tracer.instant(
                "block_truncate", CAT_ALLOC,
                args={"slot": slot, "released": max(released, 0),
                      "dropped_tokens": old_tokens - num_tokens,
                      "free": self.allocator.free_count})
        return max(released, 0)

    def free_slot(self, slot: int) -> None:
        st = self.slots[slot]
        assert st is not None, slot
        self.allocator.free(st.blocks)
        if self.tracer.enabled:
            self.tracer.instant(
                "block_free", CAT_ALLOC,
                args={"slot": slot, "blocks": len(st.blocks),
                      "free": self.allocator.free_count})
        self.slots[slot] = None
        self._tables[slot, :] = NULL_BLOCK

    # ------------------------------------------- speculative-plan rollback

    def snapshot(self) -> dict:
        """Copy of the *host* bookkeeping: allocator, slot states, tables,
        prefix index, stats. The device pools are deliberately excluded:
        they change in place, and an abandoned speculative dispatch stays
        queued and writes its K/V all the same. Those writes are harmless
        where they land past a restored slot's ``num_tokens`` (attention
        masks by context length, and every live position is written before
        it is read, by dispatches queued after it on the same stream); the
        blocks the speculative plan allocated, a copy-on-write's private
        copy among them, are repaired by the engine's ``_rollback``. So a
        rollback restores the host view and leaves the pools as the queued
        dispatches leave them."""
        return {
            "allocator": self.allocator.snapshot(),
            "slots": [None if s is None else (list(s.blocks), s.num_tokens)
                      for s in self.slots],
            "tables": self._tables.copy(),
            "prefix_index": dict(self._prefix_index),
            "block_key": dict(self._block_key),
            "stats": dataclasses.replace(self.stats),
        }

    def restore(self, snap: dict) -> None:
        self.allocator.restore(snap["allocator"])
        self.slots = [None if s is None else SlotState(blocks=list(s[0]),
                                                       num_tokens=s[1])
                      for s in snap["slots"]]
        self._tables = snap["tables"].copy()
        self._prefix_index = dict(snap["prefix_index"])
        self._block_key = dict(snap["block_key"])
        self.stats = dataclasses.replace(snap["stats"])

    # ----------------------------------------------------- prefix caching

    def _prefix_key(self, tokens: np.ndarray, nblocks: int) -> bytes:
        return tokens[: nblocks * self.block_size].tobytes()

    def probe_prefix(self, slot: int, tokens) -> int:
        """Probe the prefix index for the longest full-block hit on
        ``tokens`` and map the matched blocks into the (freshly opened,
        empty) slot. Returns the number of prompt tokens covered — the
        caller skips that many tokens of prefill. The match is capped one
        token short of the prompt so the finishing chunk always has at
        least one position to run (it produces the first sampled token).
        """
        if not self.prefix_cache:
            return 0
        st = self.slots[slot]
        assert st is not None and not st.blocks and st.num_tokens == 0, slot
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
        limit = (len(toks) - 1) // self.block_size
        blocks: List[int] = []
        for i in range(limit):
            b = self._prefix_index.get(self._prefix_key(toks, i + 1))
            if b is None:
                break
            blocks.append(b)
        if not blocks:
            self.stats.misses += 1
            if self.tracer.enabled:
                self.tracer.instant("prefix_miss", CAT_ALLOC,
                                    args={"slot": slot, "tokens": len(toks)})
            return 0
        for b in blocks:
            if self.allocator.refcount(b) == 0:
                self.allocator.take(b)      # resurrect from the warm tier
            else:
                self.allocator.incref(b)
        st.blocks.extend(blocks)
        self._tables[slot, : len(blocks)] = blocks
        st.num_tokens = len(blocks) * self.block_size
        self.stats.hits += 1
        self.stats.hit_tokens += st.num_tokens
        if self.tracer.enabled:
            self.tracer.instant(
                "prefix_hit", CAT_ALLOC,
                args={"slot": slot, "blocks": len(blocks),
                      "tokens": st.num_tokens,
                      "cached": len(self._prefix_index)})
        return st.num_tokens

    def peek_prefix(self, tokens) -> int:
        """Read-only variant of ``probe_prefix``: the prompt tokens a probe
        *would* cover right now, without touching any state. The pipelined
        engine uses it at commit time to detect prefix-hit drift — a
        speculated admission that probed before iteration ``i``'s chunks
        were indexed and would hit more blocks if re-admitted."""
        if not self.prefix_cache:
            return 0
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
        limit = (len(toks) - 1) // self.block_size
        n = 0
        for i in range(limit):
            if self._prefix_key(toks, i + 1) not in self._prefix_index:
                break
            n += 1
        return n * self.block_size

    def register_prefix(self, slot: int, tokens, upto: int) -> int:
        """Index the slot's blocks that are fully covered by the first
        ``upto`` written prompt tokens. Insert-if-absent: the first writer
        of a prefix stays canonical, concurrent identical prefills keep
        their private copies. Returns the number of newly indexed blocks."""
        if not self.prefix_cache:
            return 0
        st = self.slots[slot]
        assert st is not None, slot
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
        nfull = min(upto, len(toks), st.num_tokens) // self.block_size
        new = 0
        for i in range(nfull):
            b = st.blocks[i]
            if b in self._block_key:
                continue                    # already canonical (shared hit)
            key = self._prefix_key(toks, i + 1)
            if key in self._prefix_index:
                continue                    # another block owns this prefix
            self._prefix_index[key] = b
            self._block_key[b] = key
            self.allocator.set_cached(b, True)
            new += 1
        return new

    def share_prefix(self, src_slot: int, dst_slot: int, plen: int) -> int:
        """Alias the first full prompt blocks of ``src_slot`` into the empty
        ``dst_slot`` (spec decoding: the draft slot reuses its target's
        prompt K/V instead of re-prefilling it at low rank — sound because
        the pools are rank-agnostic and acceptance only ever commits
        target-model tokens). Returns the number of tokens shared."""
        if not self.prefix_cache:
            return 0
        src, dst = self.slots[src_slot], self.slots[dst_slot]
        assert src is not None and dst is not None, (src_slot, dst_slot)
        assert not dst.blocks and dst.num_tokens == 0, dst_slot
        nfull = min(plen, src.num_tokens) // self.block_size
        if nfull <= 0:
            return 0
        shared = src.blocks[:nfull]
        for b in shared:
            self.allocator.incref(b)
        dst.blocks.extend(shared)
        self._tables[dst_slot, :nfull] = shared
        dst.num_tokens = nfull * self.block_size
        self.stats.shared_tokens += dst.num_tokens
        if self.tracer.enabled:
            self.tracer.instant(
                "prefix_share", CAT_ALLOC,
                args={"src": src_slot, "dst": dst_slot, "blocks": nfull,
                      "tokens": dst.num_tokens})
        return dst.num_tokens

    @property
    def cached_blocks(self) -> int:
        return len(self._prefix_index)

    def _on_evict(self, b: int) -> None:
        """Allocator recycled a warm block: drop its index entry."""
        key = self._block_key.pop(b)
        del self._prefix_index[key]
        self.stats.evictions += 1
        if self.tracer.enabled:
            self.tracer.instant(
                "prefix_evict", CAT_ALLOC,
                args={"block": b, "cached": len(self._prefix_index)})

    def _unregister_block(self, b: int) -> None:
        key = self._block_key.pop(b, None)
        if key is None:
            return
        del self._prefix_index[key]
        self.allocator.uncache(b)

    def _boundary_needs_cow(self, slot: int) -> bool:
        st = self.slots[slot]
        if st.num_tokens % self.block_size == 0 or not st.blocks:
            return False
        return self.allocator.refcount(
            st.blocks[st.num_tokens // self.block_size]) > 1

    def _make_boundary_writable(self, slot: int) -> None:
        """The next write lands at ``num_tokens``. If that position sits
        inside an existing block (truncate can rewind mid-block), the block
        must be exclusively ours — copy-on-write if shared — and must leave
        the prefix index: its content is about to diverge from its key."""
        st = self.slots[slot]
        if st.num_tokens % self.block_size == 0 or not st.blocks:
            return
        bi = st.num_tokens // self.block_size
        if self.allocator.refcount(st.blocks[bi]) > 1:
            self._cow_block(slot, bi)
        self._unregister_block(st.blocks[bi])

    def _cow_block(self, slot: int, bi: int) -> None:
        """Device-side copy of one shared block into a private one (one
        indexed copy per pool, in place), plus the table patch. The old
        block keeps its refcount minus ours and (if indexed) stays canonical
        for its prefix — only our copy diverges."""
        st = self.slots[slot]
        old = st.blocks[bi]
        (new,) = self.allocator.alloc(1)
        for pool in self.pools:
            for name in ("k", "v"):
                pool[name][:, new] = pool[name][:, old]
        st.blocks[bi] = new
        self._tables[slot, bi] = new
        self.allocator.decref(old)
        self.stats.cow_copies += 1
        if self.tracer.enabled:
            self.tracer.instant(
                "cow_copy", CAT_ALLOC,
                args={"slot": slot, "block_index": bi, "src": old,
                      "dst": new, "free": self.allocator.free_count})

    # ------------------------------------------------------------ device

    def host_tables(self, max_blocks: Optional[int] = None, *,
                    null_rows: int = 0) -> np.ndarray:
        """Host-side copy of the block tables (see ``device_tables``) — for
        callers that dispatch several forwards against one table snapshot
        (each dispatch uploads its own copy)."""
        if max_blocks is None:
            t = self._tables
        elif max_blocks <= self._tables.shape[1]:
            t = self._tables[:, :max_blocks]
        else:
            # pow2-padded width past the physical table: pad with null
            # blocks (positions never reach them — they exist only so the
            # widest table is a bucketing fixed point)
            pad = np.full((self.max_batch, max_blocks - self._tables.shape[1]),
                          NULL_BLOCK, np.int32)
            t = np.concatenate([self._tables, pad], axis=1)
        if null_rows:
            t = np.concatenate(
                [t, np.full((null_rows, t.shape[1]), NULL_BLOCK, np.int32)])
        return t

    def device_tables(self, max_blocks: Optional[int] = None, *,
                      null_rows: int = 0) -> torch.Tensor:
        """Block tables, optionally truncated to ``max_blocks`` columns —
        attention cost then scales with the longest *live* context instead
        of ``max_len`` (the whole point of paging). ``null_rows`` appends
        rows of null blocks: the mixed-iteration path points pad tokens at
        such a row so their reads/writes never touch a live sequence."""
        # queued without waiting for the stream (a pageable copy is staged
        # before the call returns)
        return torch.from_numpy(
            self.host_tables(max_blocks, null_rows=null_rows)).to(
                self.device, non_blocking=True)

    def device_positions(self) -> torch.Tensor:
        """(B,) 0-based index of the token being decoded this step per slot.

        Call after ``append_token``: the current token is the last reserved
        one, i.e. ``num_tokens - 1``. Idle slots sit at position 0 — they
        read/write only the null block and their output is discarded (and
        stays finite, so no NaNs enter the batch).
        """
        pos = [0 if s is None else max(0, s.num_tokens - 1)
               for s in self.slots]
        return torch.from_numpy(np.asarray(pos, np.int32)).to(
            self.device, non_blocking=True)

    def model_caches(self, max_blocks: Optional[int] = None) -> Dict:
        """Cache pytree consumed by ``transformer.paged_decode_step``."""
        return {"positions": self.device_positions(),
                "block_tables": self.device_tables(max_blocks),
                "segments": self.pools}

    def active_max_blocks(self) -> int:
        """Smallest power-of-two table width covering every live sequence
        (so a forward sees O(log max_blocks_per_seq) distinct shapes).
        Clamped to the pow2-*padded* table width, never the raw
        ``max_blocks_per_seq``."""
        used = max((len(s.blocks) for s in self.slots if s is not None),
                   default=1)
        mb = 1
        while mb < used:
            mb *= 2
        mb = min(mb, self.padded_max_blocks)
        self._seen_widths.add(mb)
        # every observed width must be a fixed point of the bucketing —
        # i.e. a pow2 no larger than the padded cap — or the shape count
        # stops being O(log max_blocks_per_seq)
        assert all(w == min(1 << (w - 1).bit_length(), self.padded_max_blocks)
                   for w in self._seen_widths), self._seen_widths
        return mb

    def update_pools(self, new_caches: Dict) -> None:
        """Adopt the pools a forward returned (the same tensors, which the
        forward updated in place)."""
        self.pools = [dict(p) for p in new_caches["segments"]]

    def write_prefill(self, slot: int, seg_caches: List[Dict]) -> None:
        """Scatter a contiguous prefill cache into the slot's blocks.

        ``seg_caches``: per segment {'k': (count, 1, S_pad, Hkv, hd), ...}
        from a batch-1 ``transformer.prefill``; S_pad must be a multiple of
        ``block_size`` covering exactly this slot's blocks.
        """
        st = self.slots[slot]
        assert st is not None, slot
        # legacy whole-prompt path: blind overwrite, so the slot must own
        # every block exclusively
        assert all(self.allocator.refcount(b) == 1 for b in st.blocks), slot
        idx = torch.tensor(st.blocks, dtype=torch.int64, device=self.device)
        for si, c in enumerate(seg_caches):
            if c is None:
                continue
            for name in ("k", "v"):
                src = c[name][:, 0]                       # (count, S_pad, H, D)
                count, s_pad = src.shape[0], src.shape[1]
                nb = s_pad // self.block_size
                assert nb == len(st.blocks), (nb, len(st.blocks))
                src = src.reshape(count, nb, self.block_size, *src.shape[2:])
                self.pools[si][name][:, idx] = src.to(
                    self.pools[si][name].dtype)

    # ----------------------------------------------------------- metrics

    def occupancy(self) -> float:
        used = self.allocator.num_blocks - 1 - self.allocator.free_count
        return used / (self.allocator.num_blocks - 1)

    def statusz(self) -> dict:
        """JSON-able live snapshot for the ``/statusz`` endpoint: block
        occupancy/fragmentation, prefix-cache counters + hit rate, and
        per-slot block holdings. Read-only and cheap — safe to call from
        the status server thread while the engine mutates the cache (a
        torn read can misreport a count for one scrape, never corrupt)."""
        alloc = self.allocator
        st = self.stats
        probes = st.hits + st.misses
        return {
            "num_blocks": alloc.num_blocks - 1,          # usable (non-null)
            "block_size": self.block_size,
            "free_blocks": alloc.free_count,
            "occupancy": self.occupancy(),
            "fragmentation": alloc.fragmentation(),
            "prefix_cache": {
                "enabled": self.prefix_cache,
                "cached_blocks": self.cached_blocks,
                "hit_rate": st.hits / probes if probes else None,
                **dataclasses.asdict(st),
            },
            "slots": {
                i: {"tokens": s.num_tokens, "blocks": len(s.blocks)}
                for i, s in enumerate(self.slots) if s is not None
            },
        }
