"""Bounded ring-buffer flight recorder: a drop-oldest ``Tracer`` variant
cheap enough to leave on for the lifetime of a production serve.

The post-hoc ``Tracer`` grows without bound — fine for a benchmark run,
fatal for a server that stays up for days. ``RingTracer`` keeps the same
emit API (so every engine call site works unchanged) but stores events in
a ``collections.deque(maxlen=capacity)``: once full, each new event
evicts the oldest and bumps ``dropped``, so memory stays O(capacity)
forever and the recorder always holds the most recent window of engine
history — exactly what a postmortem needs.

Dumping is on-demand (``dump(last_s=...)`` → Chrome trace dict): the
status server's ``GET /debug/trace`` and the watchdog's postmortem bundle
both call it on a *live* tracer, so the dump must be valid mid-run. Two
kinds of orphans can appear in a bounded window: an ``E`` whose ``B`` was
evicted (or fell outside the requested window), and a ``B`` still open at
dump time. ``chrome_events`` drops both at render time — the buffer keeps
the raw tuples — so every dump passes ``validate_chrome_trace`` no matter
when it is taken. Drop accounting rides along in the top-level ``ring``
object of the dump (Perfetto ignores unknown top-level keys).
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

from repro_torch.obs.tracer import ENGINE_TID, REQUEST_TID_BASE, Tracer

__all__ = ["RingTracer", "DEFAULT_RING_CAPACITY"]

# ~64k events ≈ a few MB of tuples — hours of engine history at smoke
# rates, minutes under heavy traffic; always bounded
DEFAULT_RING_CAPACITY = 65536


class RingTracer(Tracer):
    """Drop-oldest flight recorder; see module docstring."""

    def __init__(self, capacity: int = DEFAULT_RING_CAPACITY, **kw):
        assert capacity > 0, f"ring capacity must be positive: {capacity}"
        super().__init__(**kw)
        self.capacity = capacity
        self.dropped = 0
        self._last_dump_dropped = 0
        # replace the unbounded list; Tracer only touches it via _push
        # (emit, under lock) and _snapshot (export, under lock)
        self._events = deque()

    def _push(self, ev: Tuple) -> None:
        # caller (Tracer emit methods) holds self._lock
        if len(self._events) >= self.capacity:
            self._events.popleft()
            self.dropped += 1
        self._events.append(ev)

    # ------------------------------------------------------------ export

    def chrome_events(self, *, last_s: Optional[float] = None) -> List[dict]:
        """Render the buffered window; always B/E-balanced (see module
        docstring). ``last_s`` keeps only events newer than that many
        seconds before the most recent buffered event."""
        with self._lock:
            events = list(self._events)
            dropped = self.dropped
        if last_s is not None and events:
            horizon = events[-1][3] - last_s
            events = [ev for ev in events if ev[3] >= horizon]
        events = _balance(events)
        out = []
        for ph, name, cat, ts, dur, tid, args in events:
            ev = {"name": name, "ph": ph, "ts": round(ts * 1e6, 3),
                  "pid": 1, "tid": tid}
            if cat:
                ev["cat"] = cat
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            if args:
                ev["args"] = args
            out.append(ev)
        tids = sorted({e[5] for e in events})
        meta = []
        for tid in tids:
            label = ("engine" if tid == ENGINE_TID
                     else f"req {tid - REQUEST_TID_BASE}"
                     if tid >= REQUEST_TID_BASE else f"tid {tid}")
            meta.append({"name": "thread_name", "ph": "M", "pid": 1,
                         "tid": tid, "ts": 0,
                         "args": {"name": label}})
        self._last_dump_dropped = dropped
        return meta + out

    def dump(self, last_s: Optional[float] = None) -> dict:
        """Chrome trace dict of the last ``last_s`` seconds (everything
        buffered when None), plus ring accounting under ``"ring"``."""
        events = self.chrome_events(last_s=last_s)
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "ring": {"capacity": self.capacity,
                         "dropped": self._last_dump_dropped,
                         "events": len(events),
                         "window_s": last_s}}

    def to_chrome(self) -> dict:
        return self.dump()


def _balance(events: List[Tuple]) -> List[Tuple]:
    """Drop orphaned E (begin evicted/out of window) and still-open B
    events so the rendered window nests cleanly per tid."""
    keep = [True] * len(events)
    open_b = {}                      # tid -> stack of indices into events
    for i, ev in enumerate(events):
        ph, tid = ev[0], ev[5]
        if ph == "B":
            open_b.setdefault(tid, []).append(i)
        elif ph == "E":
            stack = open_b.get(tid)
            if stack:
                stack.pop()
            else:
                keep[i] = False
    for stack in open_b.values():
        for i in stack:
            keep[i] = False
    if all(keep):
        return events
    return [ev for i, ev in enumerate(events) if keep[i]]
