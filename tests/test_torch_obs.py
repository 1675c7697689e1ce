"""The port's live telemetry plane against the JAX package's, on the CPU:
the host modules, each driven by the same script on both sides.

``MetricsRegistry``: the same counter, gauge and histogram operations,
with labels, give the same Prometheus text, the same snapshot and the same
JSONL line. ``RingTracer``: drop-oldest under overflow, windowed dumps and
open or orphaned spans balanced, with the same events and the same dump
under one injected clock; emit and export from threads. ``Watchdog``: the
same tick sequence under an injected clock fires the same rules in the
same order with the same reasons, honours the refire cooldown, and writes
the same postmortem bundle, whose ring dump validates. ``StatusServer``
on port 0: the three routes give the same answers on both sides, an
unbound source gives 404, a failing callback 500, a bad window 400.
``memory_traffic``: every component equals the reference's exactly for
all 11 configs at their full published sizes (decode on one device at a
few width buckets): it is arithmetic on shapes, the port's decode state
built on ``meta``. ``CostModelAudit``: the same
``observe`` sequence gives the same cells and predicted bytes (exactly),
and the bandwidth and error ratios within 1e-12 relative (the same float
operations in the same order; the bound leaves room for nothing but a
last-bit difference).

Everything here is host code; nothing runs a model.
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro import obs as jobs
from repro.configs import get_config as jget
from repro.configs import list_archs
from repro.configs.base import ShapeConfig as JShape
from repro.launch.costmodel import memory_traffic as jtraffic
from repro.serving.kv_cache import PrefixCacheStats as JPrefixStats
from repro_torch import obs as tobs
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_archs as tlist_archs
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.launch.costmodel import memory_traffic as ttraffic
from repro_torch.serving.kv_cache import PrefixCacheStats as TPrefixStats

SIDES = {"jax": jobs, "torch": tobs}
TOL_AUDIT = 1e-12


def _both(fn):
    """``fn(obs module)`` on the reference's obs package and the port's."""
    return fn(jobs), fn(tobs)


def _clock(script):
    it = iter(map(float, script))
    return it.__next__


# ------------------------------------------------------------- registry

def _registry_script(obs):
    reg = obs.MetricsRegistry()
    reg.counter("req_total", "requests served").inc(3)
    reg.counter("req_total").inc()
    tok = reg.counter("tokens_total", "tokens by row")
    tok.labels(row=0).inc(5)
    tok.labels(row=1).inc(7.5)
    g = reg.gauge("occupancy", "cache occupancy")
    g.set(0.25)
    g.inc(0.5)
    g.dec(0.125)
    reg.gauge("queue_depth", "waiting").labels(row=2).set(4)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 3.0, 100.0):
        h.labels(part="queue").observe(v)
    h.labels(part="prefill").observe(0.01)
    reg.histogram("ttft_seconds", "default buckets").observe(0.0123)
    reg.counter("odd_total", "escaped labels").labels(
        path='a"b\\c\nd').inc()
    reg.counter("never_touched", "no child: not exposed")
    return reg


def test_registry_text_and_snapshot_match_reference(tmp_path):
    jreg, treg = _both(_registry_script)
    assert treg.prometheus_text() == jreg.prometheus_text()
    assert treg.snapshot() == jreg.snapshot()
    for name, reg in (("j", jreg), ("t", treg)):
        reg.snapshot_jsonl(tmp_path / f"{name}.jsonl", clock=lambda: 10.0)
        reg.write_prometheus(tmp_path / f"{name}.prom")
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()
    assert (tmp_path / "t.prom").read_text() == \
        (tmp_path / "j.prom").read_text()
    text = treg.prometheus_text()
    assert 'lat_seconds_bucket{part="queue",le="+Inf"} 5' in text
    assert 'odd_total{path="a\\"b\\\\c\\nd"} 1' in text
    assert "never_touched" not in text


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 0.99, 1.0])
def test_histogram_quantiles_match_reference(q):
    def run(obs):
        h = obs.MetricsRegistry().histogram(
            "h", buckets=(1.0, 2.0, 4.0)).labels()
        out = [h.quantile(q)]
        for v in (0.5, 1.5, 3.0, 3.5, 100.0):
            h.observe(v)
            out.append(h.quantile(q))
        return out
    j, t = _both(run)
    assert t == j


def test_counter_decrement_asserts():
    with pytest.raises(AssertionError):
        tobs.MetricsRegistry().counter("c").inc(-1)


def test_serving_metrics_registry_series_match_reference():
    """The port's ``ServingMetrics`` publishes the reference's series into
    this registry: the same callbacks at the same clock give the same
    text."""
    from repro.serving.metrics import ServingMetrics as JMetrics
    from repro_torch.serving.metrics import ServingMetrics as TMetrics

    def run(cls, obs):
        reg = obs.MetricsRegistry()
        m = cls(registry=reg, clock=_clock(np.arange(0, 100, 0.5)))
        for r in (0, 1):
            m.on_submit(r)
            m.on_admit(r)
        m.on_prefill_chunk(8)
        m.on_prefill_end(0)
        m.on_first_token(0)
        m.on_token(0)
        m.on_preempt(1)
        m.on_cache_stats(12, 0.25, prefix=None)
        m.on_queue_depths({0: 2, 6: 1})
        m.on_iteration_timing(0.01, 0.002, overlap_s=0.001)
        m.on_finish(0)
        return reg.prometheus_text()
    assert run(TMetrics, tobs) == run(JMetrics, jobs)


# ---------------------------------------------------- ring flight recorder

def _ring_ops(obs, ops, capacity, clock):
    tr = obs.RingTracer(capacity=capacity, clock=_clock(clock))
    for op, name in ops:
        getattr(tr, op)(name)
    return tr


RING_CASES = {
    # 9 instants into 4: the oldest five go
    "overflow": ([("instant", f"e{i}") for i in range(9)], 4, range(20),
                 [None]),
    # events at 1..6 s: a 2.5 s window keeps the last three
    "window": ([("instant", f"e{i}") for i in range(6)], 64, range(7),
               [2.5, None]),
    # a B evicted under its E, a B still open at the dump
    "orphans": ([("begin", "span_a"), ("instant", "x1"), ("instant", "x2"),
                 ("instant", "x3"), ("end", "span_a"),
                 ("begin", "span_b")], 4, range(20), [None, 1.5]),
}


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_dumps_match_reference(case):
    ops, cap, clock, windows = RING_CASES[case]
    jt, tt = _both(lambda obs: _ring_ops(obs, ops, cap, clock))
    assert (len(tt), tt.dropped) == (len(jt), jt.dropped)
    for w in windows:
        dj, dt = jt.dump(last_s=w), tt.dump(last_s=w)
        assert dt == dj
        assert tobs.validate_chrome_trace(dt) == []
    phases = {e["ph"] for e in tt.dump()["traceEvents"]}
    if case == "orphans":
        assert "B" not in phases and "E" not in phases
        assert len(tt) == 4 and tt.dropped == 2
    if case == "overflow":
        names = [e["name"] for e in tt.dump()["traceEvents"]
                 if e["ph"] == "i"]
        assert names == ["e5", "e6", "e7", "e8"] and tt.dropped == 5


def test_ring_export_is_dump_and_rejects_no_capacity(tmp_path):
    tr = tobs.RingTracer(capacity=8)
    tr.instant("a")
    assert tr.to_chrome()["ring"]["capacity"] == 8
    tr.export_chrome(tmp_path / "ring.json")
    d = json.loads((tmp_path / "ring.json").read_text())
    assert tobs.validate_chrome_trace(d) == [] and d["ring"]["events"] >= 1
    with pytest.raises(AssertionError):
        tobs.RingTracer(capacity=0)


@pytest.mark.parametrize("ring", [False, True], ids=["tracer", "ring"])
def test_concurrent_emit_and_export(ring):
    """Emitters on four threads while another exports: no torn reads, no
    lost events (the ring: none lost from its accounting)."""
    tr = tobs.RingTracer(capacity=512) if ring else tobs.Tracer()
    errors, stop = [], threading.Event()

    def emitter(t):
        try:
            for i in range(200):
                tr.instant(f"t{t}e{i}", tid=t + 1)
                t0 = tr.now()
                tr.complete(f"t{t}x{i}", "cat", t0, t0 + 1e-3, tid=t + 1)
        except Exception as e:                       # pragma: no cover
            errors.append(e)

    def exporter():
        try:
            while not stop.is_set():
                assert isinstance(tr.chrome_events(), list)
        except Exception as e:                       # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=emitter, args=(t,)) for t in range(4)]
    exp = threading.Thread(target=exporter)
    exp.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    stop.set()
    exp.join(timeout=30)
    assert not errors and not exp.is_alive()
    total = 4 * 200 * 2
    assert (len(tr) + tr.dropped if ring else len(tr)) == total
    assert tobs.validate_chrome_trace(tr.to_chrome()) == []


# ------------------------------------------------------------- watchdog

class _Trace:
    def __init__(self, submit_t, first=None):
        self.submit_t = submit_t
        self.first_token_t = first
        self.finish_t = None


class _Metrics:
    """The part of ``ServingMetrics`` the TTFT rule reads."""

    def __init__(self, traces):
        self.traces = traces


def _watch_script(obs, stats_cls, name):
    """One tick sequence through every rule; returns the fired lists, the
    fire log and the status panel."""
    cases = {
        "stall": (dict(stall_s=5.0, ttft_slo_s=None, intertoken_slo_s=None),
                  [0, 3, 6, 7, 70],
                  [dict(progress_tokens=10)] * 5),
        "rearm": (dict(stall_s=5.0, ttft_slo_s=None, intertoken_slo_s=None),
                  [0, 6, 7],
                  [dict(progress_tokens=1), dict(progress_tokens=2),
                   dict(progress_tokens=2)]),
        "intertoken": (dict(stall_s=100.0, ttft_slo_s=None,
                            intertoken_slo_s=2.0), [0, 3, 6],
                       [dict(progress_tokens=5, decode_tokens=5,
                             decoding=True),
                        dict(progress_tokens=8, decode_tokens=5,
                             decoding=True),
                        dict(progress_tokens=9, decode_tokens=5,
                             decoding=False)]),
        "ttft": (dict(stall_s=100.0, ttft_slo_s=2.0, intertoken_slo_s=None),
                 [5.0],
                 [dict(progress_tokens=1, metrics=_Metrics(
                     {3: _Trace(1.0), 7: _Trace(0.0), 9: _Trace(0.5, 1.0)}))]),
        "fragmentation": (dict(frag_threshold=0.5, frag_min_free=4,
                               stall_s=100.0, ttft_slo_s=None),
                          [0, 1, 2],
                          [dict(progress_tokens=0),
                           dict(progress_tokens=1, fragmentation=0.9,
                                free_blocks=2),
                           dict(progress_tokens=2, fragmentation=0.9,
                                free_blocks=8)]),
        "collapse": (dict(accept_floor=0.2, accept_min_rounds=3,
                          prefix_hit_floor=0.5, prefix_min_probes=4,
                          stall_s=100.0, ttft_slo_s=None), [0, 1, 2],
                     [dict(progress_tokens=0),
                      dict(progress_tokens=1, spec_accept_ewma=0.05,
                           spec_rounds=2,
                           prefix_stats=stats_cls(hits=0, misses=3)),
                      dict(progress_tokens=2, spec_accept_ewma=0.05,
                           spec_rounds=5,
                           prefix_stats=stats_cls(hits=1, misses=9))]),
        "cooldown": (dict(stall_s=1.0, ttft_slo_s=None, intertoken_slo_s=None,
                          refire_s=10.0), [0, 2, 4, 13],
                     [dict(progress_tokens=0)] * 4),
    }
    kw, clock, ticks = cases[name]
    wd = obs.Watchdog(clock=_clock(clock), **kw)
    fired = [wd.tick(**t) for t in ticks]
    return fired, wd.fired, wd.statusz()


WATCH_EXPECT = {
    "stall": [[], [], ["stall"], [], ["stall"]],
    "rearm": [[], [], []],
    "intertoken": [[], ["intertoken_slo"], []],
    "ttft": [["ttft_slo"]],
    "fragmentation": [[], [], ["fragmentation"]],
    "collapse": [[], [], ["spec_accept_collapse", "prefix_hit_collapse"]],
    "cooldown": [[], ["stall"], [], ["stall"]],
}


@pytest.mark.parametrize("name", sorted(WATCH_EXPECT))
def test_watchdog_rules_match_reference(name):
    j = _watch_script(jobs, JPrefixStats, name)
    t = _watch_script(tobs, TPrefixStats, name)
    assert t[0] == j[0] == WATCH_EXPECT[name]
    assert t[1] == j[1]                 # rules, reasons, times, no bundles
    assert t[2] == j[2]
    assert tobs.WATCHDOG_RULES == jobs.WATCHDOG_RULES
    if name == "ttft":
        assert "request 7 waited 5.00s" in t[1][0]["reason"]


def test_watchdog_postmortem_bundle_matches_reference(tmp_path):
    """An injected-clock stall writes the reference's bundle: the same
    files, reason and state, the same metrics, a ring dump that validates
    and equals the reference's, and the firing's own trace instant."""
    out = {}
    for side, obs in SIDES.items():
        ring = obs.RingTracer(capacity=64, clock=_clock(range(100)))
        ring.begin("iteration")          # open: the dump must still validate
        ring.instant("plan")
        reg = obs.MetricsRegistry()
        reg.counter("repro_generated_tokens_total", "tokens").inc(42)
        wd = obs.Watchdog(stall_s=5.0, ttft_slo_s=None,
                          intertoken_slo_s=None,
                          postmortem_dir=str(tmp_path / side),
                          clock=_clock([0.0, 6.0]))
        wd.bind(tracer=ring, trace_fn=ring.dump,
                state_fn=lambda: {"queues": {0: 3}, "iterations": 17},
                registry=reg)
        wd.tick(progress_tokens=4)
        assert wd.tick(progress_tokens=4) == ["stall"]
        (rec,) = wd.fired
        bundle = tmp_path / side / "postmortem-001-stall"
        assert rec["bundle"] == str(bundle)
        out[side] = {f.name: f.read_text() for f in sorted(bundle.iterdir())}
        assert "watchdog" in {e["name"] for e in ring.dump()["traceEvents"]}
    assert out["torch"] == out["jax"]
    assert sorted(out["torch"]) == ["metrics.json", "metrics.prom",
                                    "reason.json", "state.json",
                                    "trace.json"]
    trace = json.loads(out["torch"]["trace.json"])
    assert tobs.validate_chrome_trace(trace) == []
    assert json.loads(out["torch"]["reason.json"])["rule"] == "stall"
    assert json.loads(out["torch"]["state.json"])["iterations"] == 17
    assert "repro_generated_tokens_total 42" in out["torch"]["metrics.prom"]


def test_watchdog_without_postmortem_dir_still_records():
    wd = tobs.Watchdog(stall_s=1.0, ttft_slo_s=None, clock=_clock([0, 2]))
    wd.tick(progress_tokens=0)
    assert wd.tick(progress_tokens=0) == ["stall"]
    assert wd.fired[0]["bundle"] is None
    assert json.dumps(wd.statusz())


# -------------------------------------------------------- status server

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _server(obs, bound=True):
    reg = obs.MetricsRegistry()
    reg.counter("demo_total", "a demo counter").inc(3)
    ring = obs.RingTracer(capacity=16, clock=_clock(range(100)))
    ring.instant("hello")
    ring.instant("world")
    if not bound:
        return obs.StatusServer()
    return obs.StatusServer(registry=reg, status_fn=lambda: {"alive": True},
                            trace_fn=ring.dump)


ROUTES = ("/", "/metrics", "/statusz", "/debug/trace",
          "/debug/trace?last_s=10", "/debug/trace?last_s=0",
          "/debug/trace?last_s=bogus", "/nope")


def test_status_server_routes_match_reference():
    answers = {}
    for side, obs in SIDES.items():
        with _server(obs) as srv:
            assert srv.port != 0 and srv.url.startswith("http://127.0.0.1:")
            answers[side] = [_get(srv.url + r) for r in ROUTES]
    assert answers["torch"] == answers["jax"]
    got = dict(zip(ROUTES, answers["torch"]))
    assert [got[r][0] for r in ROUTES] == [200, 200, 200, 200, 200, 200,
                                           400, 404]
    assert "demo_total 3" in got["/metrics"][1]
    assert json.loads(got["/statusz"][1]) == {"alive": True}
    for r in ROUTES[3:6]:
        assert tobs.validate_chrome_trace(json.loads(got[r][1])) == []
    names = [e["name"] for e in json.loads(
        got["/debug/trace?last_s=0"][1])["traceEvents"] if e["ph"] == "i"]
    assert names == ["world"]


def test_status_server_unbound_sources_404():
    with _server(tobs, bound=False) as srv:
        for path in ("/metrics", "/statusz", "/debug/trace"):
            assert _get(srv.url + path)[0] == 404


def test_status_server_callback_error_is_500():
    def boom():
        raise RuntimeError("scrape raced the engine")
    with tobs.StatusServer(status_fn=boom) as srv:
        code, body = _get(srv.url + "/statusz")
    assert code == 500 and "scrape raced the engine" in body


def test_status_server_that_cannot_bind_raises():
    with tobs.StatusServer() as srv:
        with pytest.raises(OSError):
            tobs.StatusServer(port=srv.port)


# --------------------------------------------------------- memory_traffic

DECODE_SHAPES = ((256, 1), (256, 8), (256, 32), (4096, 16))


@pytest.mark.parametrize("arch", list_archs())
def test_memory_traffic_matches_reference_at_full_size(arch):
    """Every decode component on one device (the reference at an empty
    mesh, the audit's call), exactly, at a few buckets; and a train and
    a prefill step there (``tests/test_torch_dist.py`` holds the mesh
    divisors)."""
    assert arch in tlist_archs()
    jcfg, tcfg = jget(arch), tget(arch)
    for seq, batch in DECODE_SHAPES:
        j = jtraffic(jcfg, JShape("x", seq, batch, "decode"), mesh_shape={})
        t = ttraffic(tcfg, TShape("x", seq, batch, "decode"))
        assert t == j and list(t) == list(j), (seq, batch)
    for kind in ("train", "prefill"):
        j = jtraffic(jcfg, JShape("x", 128, 2, kind), mesh_shape={})
        t = ttraffic(tcfg, TShape("x", 128, 2, kind))
        assert t == j and list(t) == list(j), kind


# ---------------------------------------------------------- cost audit

def _audit_script(obs, cfg, rows, registry: bool):
    reg = obs.MetricsRegistry() if registry else None
    audit = obs.CostModelAudit(cfg, np.array(rows), max_len=64,
                               registry=reg)
    rng = np.random.default_rng(5)
    cells = [(r, b) for r in range(len(rows)) for b in (8, 16, 32)]
    for i in range(70):
        row, bucket = cells[int(rng.integers(len(cells)))]
        audit.observe(row, bucket, float(rng.uniform(1e-3, 3e-2)))
    return audit, reg


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_costaudit_matches_reference(smoke):
    jcfg, tcfg = jget("gpt2-small", smoke=smoke), tget("gpt2-small",
                                                      smoke=smoke)
    rows = [50_000, 75_000, 100_000]
    ja, jreg = _audit_script(jobs, jcfg, rows, True)
    ta, treg = _audit_script(tobs, tcfg, rows, True)
    for row in range(3):
        for bucket in (1, 8, 16, 32, 64):
            assert ta.predicted_bytes(row, bucket) == \
                ja.predicted_bytes(row, bucket)
    assert ta._cells() == ja._cells()
    assert abs(ta.bandwidth() - ja.bandwidth()) <= \
        TOL_AUDIT * ja.bandwidth()
    rj, rt = ja.error_ratios(), ta.error_ratios()
    assert rt.keys() == rj.keys() and len(rt) == 9
    for k in rj:
        assert abs(rt[k] - rj[k]) <= TOL_AUDIT * abs(rj[k])
    sj, st = ja.statusz(), ta.statusz()
    assert [(c["row"], c["bucket"], c["count"], c["predicted_mb"])
            for c in st["cells"]] == \
        [(c["row"], c["bucket"], c["count"], c["predicted_mb"])
         for c in sj["cells"]]
    assert json.dumps(st)
    snap_j, snap_t = jreg.snapshot(), treg.snapshot()
    assert snap_t.keys() == snap_j.keys()
    for k in snap_j:
        assert abs(snap_t[k] - snap_j[k]) <= TOL_AUDIT * abs(snap_j[k]), k
    assert "repro_costmodel_error_ratio" in treg.prometheus_text()


def test_costaudit_orders_and_empty():
    cfg = tget("gpt2-small", smoke=True)
    audit = tobs.CostModelAudit(cfg, np.array([50_000, 100_000]),
                                max_len=64, registry=tobs.MetricsRegistry())
    assert audit.bandwidth() is None and audit.error_ratios() == {}
    assert audit.statusz() == {"bandwidth_gb_per_s": None, "cells": []}
    # a full-rank row predicts more bytes than a half-rank row, and wider
    # buckets cost more
    assert audit.predicted_bytes(1, 8) > audit.predicted_bytes(0, 8)
    assert audit.predicted_bytes(0, 32) > audit.predicted_bytes(0, 8)
    audit.observe(0, 8, 0.010)
    audit.observe(0, 8, 0.012)
    audit.observe(1, 8, 0.030)
    ratios = audit.error_ratios()
    assert ratios[(1, 8)] > 1.0 > ratios[(0, 8)]
    assert 'row="1"' in audit.registry.prometheus_text()


# ------------------------------------------------------------ profiling

def test_profiling_annotates_only_while_a_profile_runs(tmp_path):
    """``annotate`` is the shared null context until ``start``; the trace
    written at ``stop`` is a Chrome trace that names the annotation, and
    ``profile(None)`` is a no-op."""
    import torch
    from repro_torch.obs import profiling
    assert not profiling.active()
    assert profiling.annotate("x") is profiling.annotate("y")
    with profiling.profile(None):
        assert not profiling.active()
    with profiling.profile(str(tmp_path)):
        assert profiling.active()
        with profiling.annotate("paged_mixed_step"):
            torch.ones(8).sum()
    assert not profiling.active()
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert "paged_mixed_step" in names
    profiling.stop()                     # no profile running: a no-op
