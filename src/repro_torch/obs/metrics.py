"""Metrics registry: counters, gauges, and histograms with Prometheus text
exposition and periodic JSONL snapshots.

The serving stack publishes engine-level series here (tokens generated,
TTFT parts, KV occupancy + free-list fragmentation, speculative acceptance,
per-row queue depth) so a long-running serve can be scraped or tailed while
``serving/metrics.py``'s ``ServingMetrics`` keeps its post-hoc per-run
summary role. Host-side and allocation-light: metric children are found by
a dict lookup on a label tuple and update a couple of floats — cheap enough
to stay on in the hot loop.

Exposition follows the Prometheus text format (``# HELP``/``# TYPE``
comment lines, ``name{label="v"} value`` samples; histograms expose
cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``). Snapshots
are one flat JSON object per line (``snapshot_jsonl``), stamped with
wall-clock time, so a periodic snapshotter yields a greppable time series.
"""
from __future__ import annotations

import json
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_TIME_BUCKETS"]

# seconds-scale latency buckets (TTFT, iteration phases): 100us .. 30s
DEFAULT_TIME_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1,
                        1.0, 3.0, 10.0, 30.0)


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote, and line feed must be escaped inside the quoted value."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels)
    return "{" + inner + "}"


class Counter:
    """Monotonically increasing value."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        assert n >= 0, f"counter decrement: {n}"
        self.value += n


class Gauge:
    """Point-in-time value."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics): ``observe``
    increments every bucket whose upper bound covers the value, plus
    ``sum``/``count``. Quantiles come out via ``quantile`` by linear
    interpolation inside the covering bucket — coarse but monitorable."""
    __slots__ = ("bounds", "bucket_counts", "sum", "count")

    def __init__(self, buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        self.bounds = tuple(sorted(buckets))
        assert self.bounds, "histogram needs at least one bucket"
        self.bucket_counts = [0] * (len(self.bounds) + 1)   # +Inf last
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    def quantile(self, q: float) -> float:
        """Approximate q-quantile from bucket counts (0 when empty)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        acc = 0
        lo = 0.0
        for i, b in enumerate(self.bounds):
            c = self.bucket_counts[i]
            if acc + c >= target and c > 0:
                frac = (target - acc) / c
                return lo + (b - lo) * min(max(frac, 0.0), 1.0)
            acc += c
            lo = b
        return self.bounds[-1]


class _Family:
    """One named metric family: children keyed by label tuples. The family
    itself proxies the unlabeled child so ``registry.counter("x").inc()``
    works without a ``labels()`` hop."""

    def __init__(self, name: str, help_: str, factory, kind: str):
        self.name = name
        self.help = help_
        self.kind = kind          # 'counter' | 'gauge' | 'histogram'
        self._factory = factory
        self._children: Dict[Tuple[Tuple[str, str], ...], object] = {}

    def labels(self, **labels):
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = self._factory()
        return child

    # unlabeled-child proxies
    def inc(self, n: float = 1.0):
        return self.labels().inc(n)

    def dec(self, n: float = 1.0):
        return self.labels().dec(n)

    def set(self, v: float):
        return self.labels().set(v)

    def observe(self, v: float):
        return self.labels().observe(v)

    def children(self):
        return sorted(self._children.items())


class MetricsRegistry:
    """Named metric families; the engine's scrape/snapshot surface."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}

    def _family(self, name: str, help_: str, factory, kind: str) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = _Family(name, help_, factory, kind)
        return fam

    def counter(self, name: str, help_: str = "") -> _Family:
        return self._family(name, help_, Counter, "counter")

    def gauge(self, name: str, help_: str = "") -> _Family:
        return self._family(name, help_, Gauge, "gauge")

    def histogram(self, name: str, help_: str = "",
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS) -> _Family:
        return self._family(name, help_, lambda: Histogram(buckets),
                            "histogram")

    # ---------------------------------------------------------- exposition

    def prometheus_text(self) -> str:
        """Prometheus text exposition of every family."""
        lines: List[str] = []
        for name in sorted(self._families):
            fam = self._families[name]
            if not fam._children:
                continue
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for labels, child in fam.children():
                if isinstance(child, Histogram):
                    acc = 0
                    for i, b in enumerate(child.bounds):
                        acc += child.bucket_counts[i]
                        ls = _label_str(labels + (("le", _fmt(b)),))
                        lines.append(f"{name}_bucket{ls} {acc}")
                    ls = _label_str(labels + (("le", "+Inf"),))
                    lines.append(f"{name}_bucket{ls} {child.count}")
                    base = _label_str(labels)
                    lines.append(f"{name}_sum{base} {child.sum}")
                    lines.append(f"{name}_count{base} {child.count}")
                else:
                    lines.append(
                        f"{name}{_label_str(labels)} {child.value}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, float]:
        """Flat name{labels} -> value dict (histograms flatten to
        ``_sum``/``_count`` plus p50/p99 estimates)."""
        out: Dict[str, float] = {}
        for name in sorted(self._families):
            for labels, child in self._families[name].children():
                key = name + _label_str(labels)
                if isinstance(child, Histogram):
                    out[key + "_count"] = child.count
                    out[key + "_sum"] = child.sum
                    out[key + "_p50"] = child.quantile(0.5)
                    out[key + "_p99"] = child.quantile(0.99)
                else:
                    out[key] = child.value
        return out

    def snapshot_jsonl(self, path, *, clock=time.time) -> None:
        """Append one timestamped snapshot line to ``path``."""
        snap = {"time": clock()}
        snap.update(self.snapshot())
        with open(path, "a") as f:
            f.write(json.dumps(snap) + "\n")

    def write_prometheus(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.prometheus_text())
