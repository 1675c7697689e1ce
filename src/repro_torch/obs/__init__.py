"""Structured event tracing for the serving stack (Chrome trace-event /
JSONL export). The registry, watchdog, status server, ring recorder and
cost-model audit of the JAX package are not ported yet."""
from repro_torch.obs.tracer import (CAT_ALLOC, CAT_ITER, CAT_REQUEST,
                                    CAT_SCHED, CAT_SPEC, NULL_TRACER,
                                    NullTracer, Tracer, make_tracer,
                                    request_tid, validate_chrome_trace)

__all__ = [
    "CAT_ALLOC", "CAT_ITER", "CAT_REQUEST", "CAT_SCHED", "CAT_SPEC",
    "NULL_TRACER", "NullTracer", "Tracer", "make_tracer", "request_tid",
    "validate_chrome_trace",
]
