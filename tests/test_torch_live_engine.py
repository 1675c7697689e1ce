"""The live telemetry plane in the port's engine and launcher, against the
JAX package's, on the CPU, at gpt2-small's smoke config (the reference's
``smoke_state``, bridged into the port).

With the full plane on (``RingTracer(256)``, a ``MetricsRegistry``, a
quiet ``Watchdog``, ``costaudit=True``) the engine serves synchronously,
with lookahead, speculatively (draft rank 0.9, spec length 4: on the
smoke table lower fractions resolve no prefix row) and under a pool tight
enough to preempt. In each, the streams equal those of the plane off and
those of the reference engine with its plane on; the registry's token,
prefill, finish and preemption counters equal the reference's;
``statusz()`` has the reference's keys and, timings left out, its values;
the audit's (row, bucket, count) cells equal the reference's (speculative
rounds are not audited on either side); and the watchdog ticks once an
iteration. A TTFT SLO of 1e-6 s fires on both engines, names the same
request and writes a bundle that validates. The status server answers a
scraping thread while the engine generates. The serving launchers, given
one argv with every new flag (the state builder of each patched to the
reference's smoke state, so that both serve the same weights), print the
same stream lines and watchdog rules, write metrics of the same names
and a trace that validates, and the port's ``--jax-profile`` a
``torch.profiler`` trace (the reference is run without that flag: its
``jax.profiler`` trace of a cold process costs some 12 s here).
"""
import functools
import json
import re
import threading
import time
import urllib.request
import warnings

import numpy as np
import pytest

from repro import obs as jobs
from repro_torch import obs as tobs
from repro_torch.serving import Request, SamplingParams
from repro_torch.spec import SpecConfig
from test_torch_async_engine import (MATRIX, _built_states, _jax_template,
                                     jax_engine, port_engine, requests,
                                     streams)

# two budget rows, and the launcher's shapes (max_batch 2, max_len 64,
# blocks of 8, chunks of 8), so that the reference engines compile few
MIX = [(9, 6, 1.0, False), (7, 5, 0.4, True), (12, 4, 1.0, False),
       (10, 6, 0.4, True)]
SPEC = dict(draft_rank=0.9, spec_len=4, gap_chunk=8)
MODES = {
    "sync": (dict(prefill_chunk=8), MIX),
    "lookahead": (dict(prefill_chunk=8, lookahead=True), MIX),
    "spec": (dict(prefill_chunk=8, spec=True), MIX),
    "tight": MATRIX["tight_blocks"],
}
COUNTERS = ("repro_generated_tokens_total", "repro_prefill_tokens_total",
            "repro_requests_finished_total", "repro_preemptions_total")
# statusz values that are clock readings or derived from them
TIMED = {"ttft_s", "measured_mean_ms", "error_ratio", "bandwidth_gb_per_s"}


@pytest.fixture(scope="module")
def states():
    return _built_states()


def _quiet(obs, **kw):
    kw.setdefault("stall_s", 1e9)
    kw.setdefault("ttft_slo_s", None)
    kw.setdefault("intertoken_slo_s", None)
    return obs.Watchdog(**kw)


class _Counting:
    """Counts a watchdog's ticks."""

    def __init__(self, wd):
        self.wd, self.ticks = wd, 0
        orig = wd.tick

        def tick(**kw):
            self.ticks += 1
            return orig(**kw)
        wd.tick = tick


def _engine_kw(side, kw):
    kw = dict(kw)
    if kw.pop("spec", False):
        if side == "jax":
            from repro.serving import SpecConfig as JaxSpec
            kw["spec"] = JaxSpec(**SPEC)
        else:
            kw["spec"] = SpecConfig(**SPEC)
    return kw


def _serve(side, states, kw, mix, plane: bool):
    """(engine, streams, counting watchdog) of one run."""
    obs = jobs if side == "jax" else tobs
    tel = {}
    wd = None
    if plane:
        wd = _Counting(_quiet(obs))
        tel = dict(tracer=obs.RingTracer(256), registry=obs.MetricsRegistry(),
                   watchdog=wd.wd, costaudit=True)
    kw = _engine_kw(side, kw)
    if side == "jax":
        from repro.serving import Request as JaxRequest
        from repro.serving import SamplingParams as JaxSampling
        lookahead = kw.pop("lookahead", False)
        eng = jax_engine(**kw, **tel)
        eng.lookahead = lookahead
        reqs = requests(states[0][0], mix, JaxRequest, JaxSampling)
    else:
        eng = port_engine(states, **kw, **tel)
        reqs = requests(states[1][0], mix, Request, SamplingParams)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        out = eng.generate(reqs, mode="continuous")
    return eng, streams(reqs, out), wd


def _untimed(d):
    if isinstance(d, dict):
        return {k: _untimed(v) for k, v in d.items() if k not in TIMED}
    if isinstance(d, list):
        return [_untimed(v) for v in d]
    return d


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plane_on_serves_the_reference_streams(states, mode):
    kw, mix = MODES[mode]
    _, off, _ = _serve("torch", states, kw, mix, plane=False)
    teng, on, twd = _serve("torch", states, kw, mix, plane=True)
    jeng, ref, _ = _serve("jax", states, kw, mix, plane=True)
    assert on == off == ref
    snap_t, snap_j = teng.registry.snapshot(), jeng.registry.snapshot()
    for name in COUNTERS:
        assert snap_t.get(name, 0) == snap_j.get(name, 0), name
    assert set(snap_t) == set(snap_j)
    # every series the registry holds, ServingMetrics counted alike
    m = teng.last_metrics
    assert snap_t["repro_generated_tokens_total"] == m.generated_tokens
    assert snap_t["repro_prefill_tokens_total"] == m.prefill_tokens
    assert snap_t.get("repro_preemptions_total", 0) == m.preemptions
    if mode == "tight":
        assert m.preemptions > 0
    if mode == "spec":
        assert m.spec_rounds > 0
    st_t, st_j = teng.statusz(), jeng.statusz()
    assert _untimed(st_t) == _untimed(st_j)
    assert json.dumps(st_t)
    cells = lambda s: [(c["row"], c["bucket"], c["count"])
                       for c in s["costaudit"]["cells"]]
    assert cells(st_t) == cells(st_j)
    if mode != "spec":
        assert cells(st_t)
        assert "repro_costmodel_error_ratio" in teng.registry.prometheus_text()
    assert twd.ticks == teng._iterations == jeng._iterations > 0
    assert teng.watchdog.fired == []
    assert tobs.validate_chrome_trace(teng.tracer.dump()) == []


def test_ttft_slo_fires_on_both_engines(states, tmp_path):
    """An impossible TTFT SLO fires at the first tick on both engines and
    names the same request; the bundle's ring dump validates and its
    ``state.json`` holds the engine's ``statusz`` keys."""
    named = {}
    for side, obs in (("jax", jobs), ("torch", tobs)):
        wd = _quiet(obs, ttft_slo_s=1e-6,
                    postmortem_dir=str(tmp_path / side))
        kw = dict(prefill_chunk=8, tracer=obs.RingTracer(4096),
                  registry=obs.MetricsRegistry(), watchdog=wd)
        if side == "jax":
            from repro.serving import Request as JaxRequest
            from repro.serving import SamplingParams as JaxSampling
            eng = jax_engine(**kw)
            reqs = requests(states[0][0], MIX, JaxRequest, JaxSampling)
        else:
            eng = port_engine(states, **kw)
            reqs = requests(states[1][0], MIX, Request, SamplingParams)
        eng.generate(reqs, mode="continuous")
        (rec,) = wd.fired
        assert rec["rule"] == "ttft_slo"
        named[side] = re.search(r"request (\d+)", rec["reason"]).group(1)
        trace = json.loads(open(f"{rec['bundle']}/trace.json").read())
        assert obs.validate_chrome_trace(trace) == []
        state = json.loads(open(f"{rec['bundle']}/state.json").read())
        assert set(state) == set(eng.statusz())
        prom = open(f"{rec['bundle']}/metrics.prom").read()
        assert 'repro_watchdog_fired_total{rule="ttft_slo"} 1' in prom
    assert named["torch"] == named["jax"]


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def test_live_scrape_during_generation(states):
    """``/metrics``, ``/statusz`` and ``/debug/trace`` answer from a thread
    while the engine generates; the token counter never goes back, every
    trace dump validates, no snapshot is ``partial``, one taken while a
    request is admitted and unfinished holds ``requests``, ``queues`` and
    ``kv``, and the final snapshot holds the run."""
    ring, reg = tobs.RingTracer(4096), tobs.MetricsRegistry()
    eng = port_engine(states, prefill_chunk=8, tracer=ring, registry=reg,
                      costaudit=True)
    reqs = requests(states[1][0], MIX * 2, Request, SamplingParams)
    box = {}
    worker = threading.Thread(
        target=lambda: box.update(res=eng.generate(reqs, mode="continuous")))
    seen, scrapes = [], 0
    with tobs.StatusServer(registry=reg, status_fn=eng.statusz,
                           trace_fn=ring.dump) as srv:
        worker.start()
        while True:
            alive = worker.is_alive()
            code, prom = _get(srv.url + "/metrics")
            assert code == 200
            for line in prom.splitlines():
                if line.startswith("repro_generated_tokens_total "):
                    seen.append(float(line.split()[1]))
            status = json.loads(_get(srv.url + "/statusz")[1])
            assert status["engine"]["arch"] == eng.cfg.name
            assert "partial" not in status, status["partial"]
            if any(r["state"] in ("prefilling", "decoding")
                   for r in status.get("requests", {}).values()):
                assert {"requests", "queues", "kv"} <= status.keys()
            trace = json.loads(_get(srv.url + "/debug/trace?last_s=30")[1])
            assert tobs.validate_chrome_trace(trace) == []
            scrapes += 1
            if not alive:
                break
            time.sleep(0.02)
        worker.join(timeout=60)
    assert not worker.is_alive() and scrapes >= 1
    assert seen == sorted(seen)
    final = eng.statusz()
    assert {r["state"] for r in final["requests"].values()} == {"finished"}
    assert final["progress"]["generated_tokens"] == sum(
        len(r.tokens) - len(q.prompt) for r, q in zip(box["res"], reqs))
    assert final["costaudit"]["cells"]


# ------------------------------------------------------------- launcher

def _argv(tmp, suffix):
    return ["--smoke", "--requests", "3", "--budgets", "0.4,1.0",
            "--max-new", "4", "--prefill-chunk", "8", "--max-batch", "2",
            "--max-len", "64", "--block-size", "8",
            "--trace-ring", "4096", "--trace-out", str(tmp / "trace.json"),
            "--metrics-out", str(tmp / f"metrics{suffix}"),
            "--statusz-port", "0", "--status-linger", "0.05",
            "--watchdog", "--postmortem-dir", str(tmp / "pm")]


@pytest.mark.parametrize("suffix", [".prom", ".jsonl"])
def test_launchers_agree_with_every_new_flag(states, tmp_path, monkeypatch,
                                             capsys, suffix):
    from repro.launch import serve as jserve
    from repro.serving import ElasticEngine as JaxEngine
    from repro_torch.launch import serve as tserve
    (cfg, pf, table, infos), (_, tpf, ttable, tinfos) = states
    tpl = _jax_template()

    def jax_engine_borrowing(*a, **kw):
        eng = JaxEngine(*a, **kw)
        for name, value in vars(tpl).items():
            if name.endswith("_jit"):
                setattr(eng, name, value)
        eng._deployed = tpl._deployed
        return eng

    def port_state(cfg_, dense, seed, *, timings=None):
        timings.update(calibrate=0.0, decompose=0.0, dp=0.0, plain_svd=0)
        return tpf, ttable, tinfos

    # both launchers serve the reference's smoke state (the reference's
    # own launcher builds exactly it), and the watchdog's TTFT SLO is
    # impossible, so that it fires
    monkeypatch.setattr(jserve, "build_flexrank_state",
                        lambda *a, **k: (pf, table, infos))
    monkeypatch.setattr(jserve, "ElasticEngine", jax_engine_borrowing)
    monkeypatch.setattr(tserve, "serving_state", port_state)
    for obs in (jobs, tobs):
        monkeypatch.setattr(obs, "Watchdog", functools.partial(
            obs.Watchdog, ttft_slo_s=1e-6))
    out = {}
    for side, mod in (("jax", jserve), ("torch", tserve)):
        tmp = tmp_path / side
        tmp.mkdir()
        argv = _argv(tmp, suffix)
        if side == "torch":
            argv += ["--device", "cpu", "--jax-profile", str(tmp / "profile")]
        mod.main(argv)
        lines = capsys.readouterr().out.splitlines()
        metrics = (tmp / f"metrics{suffix}").read_text()
        names = (set(json.loads(metrics.splitlines()[-1]))
                 if suffix == ".jsonl" else
                 {l.split()[2] for l in metrics.splitlines()
                  if l.startswith("# TYPE")})
        out[side] = dict(
            reqs=[l for l in lines if l.startswith("req ")],
            statusz=[l for l in lines if l.startswith("# statusz: http")],
            fired=[re.sub(r"waited [0-9.]+s", "", l.split(" -> ")[0])
                   for l in lines if l.startswith("# watchdog fired:")],
            names=names,
            trace=json.loads((tmp / "trace.json").read_text()))
        assert (tmp / "pm").is_dir()
    t, j = out["torch"], out["jax"]
    assert t["reqs"] == j["reqs"] and len(t["reqs"]) == 3
    assert len(t["statusz"]) == len(j["statusz"]) == 1
    assert t["fired"] == j["fired"] and t["fired"]
    assert "ttft_slo" in t["fired"][0]
    assert t["names"] == j["names"]
    assert "repro_costmodel_error_ratio" in " ".join(t["names"])
    assert tobs.validate_chrome_trace(t["trace"]) == []
    assert list((tmp_path / "torch" / "profile").glob("*.pt.trace.json"))
