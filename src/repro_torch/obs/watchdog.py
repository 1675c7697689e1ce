"""Anomaly watchdog: rule-based detectors over the live engine loop, with
postmortem capture on trigger.

The engine calls ``Watchdog.tick(...)`` once per iteration (mixed
prefill/decode iterations and speculative rounds alike) with its cheap
heartbeat signals; each rule is a few float compares, so the per-tick
cost is negligible next to a step's dispatch. When a rule fires the
watchdog

  1. emits a ``watchdog`` trace instant (category ``sched``) carrying
     the rule name and a human-readable reason,
  2. bumps ``repro_watchdog_fired_total{rule=...}``, and
  3. writes a **postmortem bundle** under ``postmortem_dir`` (when set):
     ``reason.json`` (rule, reason, tick clock), ``trace.json`` (flight-
     recorder dump — a valid Chrome trace), ``metrics.prom`` + a flat
     ``metrics.json`` snapshot, and ``state.json`` (the same live-state
     snapshot ``/statusz`` serves: scheduler queues, allocator occupancy,
     per-request lifecycle).

Rules (thresholds are constructor kwargs; defaults in parentheses):

  * ``stall``                — no token committed (prefill or decode) for
    ``stall_s`` (10 s) while the loop is ticking.
  * ``ttft_slo``             — some admitted-or-queued request has waited
    ``ttft_slo_s`` (30 s) without its first token.
  * ``intertoken_slo``       — sequences are decoding but no decode token
    committed for ``intertoken_slo_s`` (10 s).
  * ``fragmentation``        — allocator fragmentation above
    ``frag_threshold`` (0.9) with at least ``frag_min_free`` (8) free
    blocks (an empty free list is full, not fragmented).
  * ``spec_accept_collapse`` — speculative acceptance EWMA below
    ``accept_floor`` (0.1) after ``accept_min_rounds`` (20) rounds.
  * ``prefix_hit_collapse``  — prefix-cache hit rate below
    ``prefix_hit_floor`` (0.02) after ``prefix_min_probes`` (64)
    admission probes.

Each rule re-arms after ``refire_s`` (60 s) so a persistent condition
produces a bounded bundle stream instead of one per iteration. The clock
is injectable (and must share a timebase with the engine's
``ServingMetrics`` clock for the SLO rules) — tests drive stalls without
sleeping.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional

from repro_torch.obs.tracer import CAT_SCHED

__all__ = ["Watchdog", "WATCHDOG_RULES"]

WATCHDOG_RULES = ("stall", "ttft_slo", "intertoken_slo", "fragmentation",
                  "spec_accept_collapse", "prefix_hit_collapse")


class Watchdog:
    """Rule-based anomaly detector; see module docstring."""

    def __init__(self, *,
                 postmortem_dir: Optional[str] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 stall_s: float = 10.0,
                 ttft_slo_s: Optional[float] = 30.0,
                 intertoken_slo_s: Optional[float] = 10.0,
                 frag_threshold: float = 0.9,
                 frag_min_free: int = 8,
                 accept_floor: float = 0.1,
                 accept_min_rounds: int = 20,
                 prefix_hit_floor: float = 0.02,
                 prefix_min_probes: int = 64,
                 refire_s: float = 60.0):
        self.postmortem_dir = postmortem_dir
        self._clock = clock
        self.stall_s = stall_s
        self.ttft_slo_s = ttft_slo_s
        self.intertoken_slo_s = intertoken_slo_s
        self.frag_threshold = frag_threshold
        self.frag_min_free = frag_min_free
        self.accept_floor = accept_floor
        self.accept_min_rounds = accept_min_rounds
        self.prefix_hit_floor = prefix_hit_floor
        self.prefix_min_probes = prefix_min_probes
        self.refire_s = refire_s
        # postmortem sources, bound by the engine at serve start
        self._tracer = None
        self._trace_fn: Optional[Callable[[], dict]] = None
        self._state_fn: Optional[Callable[[], dict]] = None
        self._registry = None
        # progress trackers
        self._last_progress: Optional[tuple] = None   # (tokens, t)
        self._last_decode: Optional[tuple] = None     # (decode_tokens, t)
        self._last_fired: Dict[str, float] = {}       # rule -> fire time
        self.fired: List[dict] = []                   # fire log (statusz)
        self._bundles = 0

    def bind(self, *, tracer=None, trace_fn=None, state_fn=None,
             registry=None) -> None:
        """Attach postmortem sources: the live tracer (for the firing
        instant), a flight-recorder dump callable, a ``/statusz``-style
        state snapshot callable, and the metrics registry."""
        if tracer is not None:
            self._tracer = tracer
        if trace_fn is not None:
            self._trace_fn = trace_fn
        if state_fn is not None:
            self._state_fn = state_fn
        if registry is not None:
            self._registry = registry

    # -------------------------------------------------------------- tick

    def tick(self, *,
             progress_tokens: int,
             decode_tokens: int = 0,
             decoding: bool = False,
             metrics=None,
             fragmentation: float = 0.0,
             free_blocks: int = 0,
             spec_accept_ewma: Optional[float] = None,
             spec_rounds: int = 0,
             prefix_stats=None) -> List[str]:
        """Evaluate every rule against this iteration's heartbeat.
        ``progress_tokens`` is the cumulative committed-token count
        (prefill + decode); ``decode_tokens`` counts generated tokens
        only. Returns the rule names that fired this tick."""
        now = self._clock()
        fired: List[str] = []

        if self._last_progress is None or progress_tokens > self._last_progress[0]:
            self._last_progress = (progress_tokens, now)
        elif now - self._last_progress[1] > self.stall_s:
            age = now - self._last_progress[1]
            fired.append(self._fire(
                "stall", f"no committed token for {age:.2f}s "
                f"(threshold {self.stall_s}s, "
                f"stuck at {progress_tokens} tokens)", now))

        if self._last_decode is None or decode_tokens > self._last_decode[0]:
            self._last_decode = (decode_tokens, now)
        elif (self.intertoken_slo_s is not None and decoding
              and now - self._last_decode[1] > self.intertoken_slo_s):
            age = now - self._last_decode[1]
            fired.append(self._fire(
                "intertoken_slo",
                f"decoding sequences got no token for {age:.2f}s "
                f"(SLO {self.intertoken_slo_s}s)", now))

        if self.ttft_slo_s is not None and metrics is not None:
            worst_id, worst_age = None, self.ttft_slo_s
            for req_id, tr in list(metrics.traces.items()):
                if tr.first_token_t is None and tr.finish_t is None:
                    age = now - tr.submit_t
                    if age > worst_age:
                        worst_id, worst_age = req_id, age
            if worst_id is not None:
                fired.append(self._fire(
                    "ttft_slo",
                    f"request {worst_id} waited {worst_age:.2f}s without "
                    f"a first token (SLO {self.ttft_slo_s}s)", now))

        if fragmentation > self.frag_threshold and free_blocks >= self.frag_min_free:
            fired.append(self._fire(
                "fragmentation",
                f"free-list fragmentation {fragmentation:.3f} > "
                f"{self.frag_threshold} with {free_blocks} free blocks",
                now))

        if (spec_accept_ewma is not None
                and spec_rounds >= self.accept_min_rounds
                and spec_accept_ewma < self.accept_floor):
            fired.append(self._fire(
                "spec_accept_collapse",
                f"speculative acceptance EWMA {spec_accept_ewma:.3f} < "
                f"{self.accept_floor} after {spec_rounds} rounds", now))

        if prefix_stats is not None:
            probes = prefix_stats.hits + prefix_stats.misses
            if probes >= self.prefix_min_probes:
                rate = prefix_stats.hits / probes
                if rate < self.prefix_hit_floor:
                    fired.append(self._fire(
                        "prefix_hit_collapse",
                        f"prefix-cache hit rate {rate:.3f} < "
                        f"{self.prefix_hit_floor} after {probes} probes",
                        now))

        return [f for f in fired if f is not None]

    # -------------------------------------------------------------- fire

    def _fire(self, rule: str, reason: str, now: float) -> Optional[str]:
        last = self._last_fired.get(rule)
        if last is not None and now - last < self.refire_s:
            return None
        self._last_fired[rule] = now
        record = {"rule": rule, "reason": reason, "fired_at_s": now,
                  "bundle": None}
        if self._tracer is not None and self._tracer.enabled:
            self._tracer.instant("watchdog", CAT_SCHED,
                                 args={"rule": rule, "reason": reason})
        if self._registry is not None:
            self._registry.counter(
                "repro_watchdog_fired_total",
                "watchdog rule firings (label rule)").labels(rule=rule).inc()
        if self.postmortem_dir:
            record["bundle"] = self._write_bundle(rule, record)
        self.fired.append(record)
        return rule

    def _write_bundle(self, rule: str, record: dict) -> str:
        """Write one postmortem bundle directory; returns its path."""
        self._bundles += 1
        path = os.path.join(self.postmortem_dir,
                            f"postmortem-{self._bundles:03d}-{rule}")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "reason.json"), "w") as f:
            json.dump({k: v for k, v in record.items() if k != "bundle"},
                      f, indent=1)
            f.write("\n")
        if self._trace_fn is not None:
            with open(os.path.join(path, "trace.json"), "w") as f:
                json.dump(self._trace_fn(), f)
                f.write("\n")
        if self._registry is not None:
            self._registry.write_prometheus(
                os.path.join(path, "metrics.prom"))
            with open(os.path.join(path, "metrics.json"), "w") as f:
                json.dump(self._registry.snapshot(), f, indent=1)
                f.write("\n")
        if self._state_fn is not None:
            with open(os.path.join(path, "state.json"), "w") as f:
                json.dump(self._state_fn(), f, indent=1, default=str)
                f.write("\n")
        return path

    # ------------------------------------------------------------ status

    def statusz(self) -> dict:
        """Watchdog panel for ``/statusz``: configured thresholds plus
        the fire log."""
        return {
            "rules": {
                "stall": {"stall_s": self.stall_s},
                "ttft_slo": {"ttft_slo_s": self.ttft_slo_s},
                "intertoken_slo": {"intertoken_slo_s": self.intertoken_slo_s},
                "fragmentation": {"frag_threshold": self.frag_threshold,
                                  "frag_min_free": self.frag_min_free},
                "spec_accept_collapse": {
                    "accept_floor": self.accept_floor,
                    "accept_min_rounds": self.accept_min_rounds},
                "prefix_hit_collapse": {
                    "prefix_hit_floor": self.prefix_hit_floor,
                    "prefix_min_probes": self.prefix_min_probes},
            },
            "refire_s": self.refire_s,
            "postmortem_dir": self.postmortem_dir,
            "fired": self.fired,
        }
