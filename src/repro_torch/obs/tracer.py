"""Structured event tracing for the elastic serving stack.

One ``Tracer`` collects typed events host-side while the engine runs and
exports them afterwards as Chrome trace-event JSON (loads directly in
Perfetto / ``chrome://tracing``) or as JSONL (one event object per line,
greppable). The taxonomy the serving stack emits:

  * ``request`` — per-request lifecycle: ``submit``/``admit``/
    ``prefill_end``/``first_token``/``finish`` instants while the run is
    live, plus synthesized ``queue``/``prefill``/``decode``/``request``
    duration spans per request at finish time (one Perfetto track per
    request id).
  * ``iteration`` — the engine loop's per-iteration anatomy: ``plan``
    (admission + chunk planning), ``dispatch`` (the jitted forward incl.
    sync — the device leg of ``serving/metrics.py`` timing split), and
    ``commit`` (host-side token/cache bookkeeping).
  * ``spec`` — speculative rounds: ``draft``/``verify`` spans and a
    ``spec_round`` instant carrying draft/verify/accepted counts.
  * ``alloc`` — block allocator traffic: ``alloc``/``free``/``truncate``
    instants with block counts and the free-list level.
  * ``sched`` — scheduler decisions **with reasons**: ``route``,
    ``admit``, ``preempt`` (victim + why), ``requeue``, ``adaptive_k``
    (grow/shrink/probe decisions).

Overhead discipline: the disabled path must cost ~nothing in the engine
hot loop. ``NULL_TRACER`` (a ``NullTracer``) is the shared disabled
instance — every emit method is a no-op ``return`` and ``enabled`` is
False, so call sites guard argument construction with
``if tracer.enabled:`` and the disabled path reduces to one attribute
check (see the zero-allocation test in ``tests/test_obs.py``). Events are
appended as plain tuples and only rendered to dicts at export time.

Timestamps are ``time.perf_counter()`` seconds, rebased to the tracer's
construction time and exported as integer microseconds (the Chrome
format's unit). ``complete()`` accepts caller-measured ``(t0, t1)`` pairs
so code that already times a phase (the metrics timing split) emits spans
without a second clock read.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "make_tracer",
           "validate_chrome_trace",
           "CAT_REQUEST", "CAT_ITER", "CAT_SPEC", "CAT_ALLOC", "CAT_SCHED"]

CAT_REQUEST = "request"
CAT_ITER = "iteration"
CAT_SPEC = "spec"
CAT_ALLOC = "alloc"
CAT_SCHED = "sched"

# Chrome trace-event phases this tracer emits (the validator accepts
# exactly these): X = complete span, B/E = begin/end span, i = instant,
# C = counter, M = metadata
_PHASES = frozenset("XBEiCM")

# reserved tid for the engine loop; request tracks start above it so the
# two never collide in the Perfetto track list
ENGINE_TID = 0
REQUEST_TID_BASE = 1000


def request_tid(req_id: int) -> int:
    """Perfetto track for one request's lifecycle spans."""
    return REQUEST_TID_BASE + req_id


class Tracer:
    """Collects trace events; export via ``to_chrome``/``export_*``."""

    enabled = True

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        # (ph, name, cat, ts_s, dur_s, tid, args) — dur_s only for X
        self._events: List[Tuple] = []
        self._open: Dict[int, List[str]] = {}     # tid -> begin-name stack

    # ------------------------------------------------------------- clock

    def now(self) -> float:
        return self._clock()

    def _rel(self, t: float) -> float:
        return t - self._t0

    # -------------------------------------------------------------- emit
    #
    # Every emit takes ``self._lock``: the status server (obs/statusz.py)
    # scrapes a live tracer from its own thread, so emit and export must
    # not race on ``self._events``/``self._open``. The lock is uncontended
    # in the single-threaded engine loop — one futex-free acquire per
    # event on the enabled path, nothing at all on the NULL_TRACER path.

    def _push(self, ev: Tuple) -> None:
        """Append one event tuple; caller holds ``self._lock``. The ring
        recorder (``obs/ringtrace.py``) overrides this to bound the
        buffer and count drops."""
        self._events.append(ev)

    def instant(self, name: str, cat: str = "", tid: int = ENGINE_TID,
                args: Optional[dict] = None) -> None:
        ev = ("i", name, cat, self._rel(self.now()), 0.0, tid, args)
        with self._lock:
            self._push(ev)

    def begin(self, name: str, cat: str = "", tid: int = ENGINE_TID,
              args: Optional[dict] = None) -> None:
        ev = ("B", name, cat, self._rel(self.now()), 0.0, tid, args)
        with self._lock:
            self._open.setdefault(tid, []).append(name)
            self._push(ev)

    def end(self, name: str, tid: int = ENGINE_TID,
            args: Optional[dict] = None) -> None:
        ev = ("E", name, "", self._rel(self.now()), 0.0, tid, args)
        with self._lock:
            stack = self._open.get(tid, [])
            assert stack and stack[-1] == name, (
                f"span end {name!r} does not match open span "
                f"{stack[-1] if stack else None!r} on tid {tid}")
            stack.pop()
            self._push(ev)

    def span(self, name: str, cat: str = "", tid: int = ENGINE_TID,
             args: Optional[dict] = None):
        """Context manager: ``with tracer.span("plan", CAT_ITER): ...``."""
        return _Span(self, name, cat, tid, args)

    def complete(self, name: str, cat: str, t0: float, t1: float,
                 tid: int = ENGINE_TID, args: Optional[dict] = None) -> None:
        """One finished span from caller-measured clock times (absolute
        ``self._clock`` readings) — lets code that already timed a phase
        emit it without extra clock reads."""
        ev = ("X", name, cat, self._rel(t0), max(t1 - t0, 0.0), tid, args)
        with self._lock:
            self._push(ev)

    def counter(self, name: str, value: float, cat: str = "") -> None:
        """Counter-track sample (Perfetto renders these as line charts)."""
        ev = ("C", name, cat, self._rel(self.now()), 0.0,
              ENGINE_TID, {"value": value})
        with self._lock:
            self._push(ev)

    # ------------------------------------------------------------ export

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def _snapshot(self) -> List[Tuple]:
        """Consistent copy of the event buffer for export paths."""
        with self._lock:
            return list(self._events)

    def chrome_events(self) -> List[dict]:
        events = self._snapshot()
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
        # name the request tracks so Perfetto shows "req 3" instead of a
        # bare tid; metadata events sort first by convention
        tids = sorted({e[5] for e in events})
        meta = []
        for tid in tids:
            label = ("engine" if tid == ENGINE_TID
                     else f"req {tid - REQUEST_TID_BASE}"
                     if tid >= REQUEST_TID_BASE else f"tid {tid}")
            meta.append({"name": "thread_name", "ph": "M", "pid": 1,
                         "tid": tid, "ts": 0,
                         "args": {"name": label}})
        return meta + out

    def to_chrome(self) -> dict:
        return {"traceEvents": self.chrome_events(),
                "displayTimeUnit": "ms"}

    def export_chrome(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
            f.write("\n")

    def export_jsonl(self, path) -> None:
        with open(path, "w") as f:
            for ev in self.chrome_events():
                f.write(json.dumps(ev) + "\n")


class _Span:
    __slots__ = ("_tr", "_name", "_cat", "_tid", "_args")

    def __init__(self, tr, name, cat, tid, args):
        self._tr, self._name, self._cat = tr, name, cat
        self._tid, self._args = tid, args

    def __enter__(self):
        self._tr.begin(self._name, self._cat, self._tid, self._args)
        return self

    def __exit__(self, *exc):
        self._tr.end(self._name, self._tid)
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every method is a no-op; ``enabled`` is False so
    hot-loop call sites can skip building event arguments entirely."""

    enabled = False

    def now(self) -> float:                       # parity with Tracer
        return time.perf_counter()

    def instant(self, *a, **k) -> None:
        return None

    def begin(self, *a, **k) -> None:
        return None

    def end(self, *a, **k) -> None:
        return None

    def span(self, *a, **k):
        return _NULL_SPAN

    def complete(self, *a, **k) -> None:
        return None

    def counter(self, *a, **k) -> None:
        return None

    def __len__(self) -> int:
        return 0

    def chrome_events(self) -> List[dict]:
        return []

    def to_chrome(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}


NULL_TRACER = NullTracer()


def make_tracer(enabled: Optional[bool] = None):
    """Tracer factory honoring the ``REPRO_TRACE`` env knob: explicit
    ``enabled`` wins; otherwise ``REPRO_TRACE=1`` turns tracing on
    suite-wide (the CI obs matrix) and the default is off (the no-op
    fast path)."""
    if enabled is None:
        import os
        enabled = os.environ.get("REPRO_TRACE") == "1"
    return Tracer() if enabled else NULL_TRACER


# ------------------------------------------------------------- validation

def validate_chrome_trace(obj) -> List[str]:
    """Stdlib-only Chrome trace-event JSON validator. Returns a list of
    problems (empty = valid): top-level shape, required per-event fields,
    known phases, non-negative timestamps/durations (including on ``M``
    metadata events), and B/E nesting balance per (pid, tid) with the
    ``E`` name checked against the matching ``B``. Used by the schema
    tests and the CI smoke
    serve — NOT a full spec implementation, but strict enough that
    anything passing loads in Perfetto."""
    problems: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with a 'traceEvents' array"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be an array"]
    stacks: Dict[Tuple, List[str]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            problems.append(f"event {i}: bad phase {ph!r}")
            continue
        for field in ("name", "pid", "tid"):
            if field not in ev:
                problems.append(f"event {i}: missing {field!r}")
        # the ts check deliberately covers every phase, M metadata events
        # included — Perfetto sorts metadata by ts, so a negative stamp
        # there corrupts track naming just as badly as on a span
        ts = ev.get("ts", 0)
        if isinstance(ts, bool) or not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: X event needs dur >= 0")
        if "args" in ev and not isinstance(ev["args"], dict):
            problems.append(f"event {i}: args must be an object")
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            stacks.setdefault(key, []).append(ev.get("name", ""))
        elif ph == "E":
            stack = stacks.get(key, [])
            if not stack:
                problems.append(f"event {i}: E without open B on {key}")
            else:
                opened = stack.pop()
                if ev.get("name", opened) != opened:
                    problems.append(
                        f"event {i}: E name {ev.get('name')!r} does not "
                        f"match open B {opened!r} on {key}")
    for key, stack in stacks.items():
        if stack:
            problems.append(f"unclosed B events on {key}: {stack}")
    return problems
