"""Observability for the elastic serving stack: structured event tracing
(Chrome trace-event / JSONL export), a Prometheus-style metrics registry,
``torch.profiler`` hooks, and the live telemetry plane: the ring-buffer
flight recorder, the ``/statusz`` status server, the anomaly watchdog with
postmortem capture, and the cost-model audit."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.tracer import (CAT_ALLOC, CAT_ITER, CAT_REQUEST,
                                    CAT_SCHED, CAT_SPEC, NULL_TRACER,
                                    NullTracer, Tracer, make_tracer,
                                    request_tid, validate_chrome_trace)
from repro_torch.obs.ringtrace import DEFAULT_RING_CAPACITY, RingTracer
from repro_torch.obs.statusz import StatusServer
from repro_torch.obs.watchdog import WATCHDOG_RULES, Watchdog
from repro_torch.obs.costaudit import CostModelAudit
from repro_torch.obs import profiling

__all__ = [
    "CAT_ALLOC", "CAT_ITER", "CAT_REQUEST", "CAT_SCHED", "CAT_SPEC",
    "CostModelAudit", "Counter", "DEFAULT_RING_CAPACITY", "Gauge",
    "Histogram", "MetricsRegistry", "NULL_TRACER", "NullTracer",
    "RingTracer", "StatusServer", "Tracer", "WATCHDOG_RULES", "Watchdog",
    "make_tracer", "profiling", "request_tid", "validate_chrome_trace",
]
