"""The port's serving stack against the JAX package's, on the CPU.

``keyed_uniform`` must be bit-exact to the JAX threefry chain; the fused
sampling step must draw the same tokens; and the port's ``ElasticEngine``
must emit token streams identical to the JAX engine's on the smoke
fixture (weights bridged from the JAX side), across chunked prefill,
preemption under a tight pool, prefix caching, device and host sampling,
and greedy and temperature/top-k requests.
"""
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config
from repro.serving import ElasticEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro.serving import device_sampling as jds
from repro_torch import bridge
from repro_torch.serving import ElasticEngine, Request, SamplingParams
from repro_torch.serving import device_sampling as tds

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def states():
    return build_states()


def build_states():
    """The JAX suite's smoke fixture (tests/test_chunked_prefill.py), and
    the same state bridged into the port (also ``test_torch_spec.py``'s)."""
    from repro.data import make_source
    from repro.launch.train import build_flexrank_state
    from repro.models import common as jcm
    from repro.models import transformer as jtfm
    cfg = get_config("gpt2-small", smoke=True)
    source = make_source(cfg.vocab_size, 64, 4, seed=0)
    dense = jcm.instantiate(jtfm.model_spec(cfg), jax.random.PRNGKey(0))
    params_fact, table, infos = build_flexrank_state(cfg, dense, source)
    jax_state = (cfg, params_fact, table, infos)
    from repro_torch.configs import get_config as tget
    torch_state = (tget("gpt2-small", smoke=True),
                   bridge.params_to_torch(params_fact),
                   bridge.profile_table(table), bridge.group_infos(infos))
    return jax_state, torch_state


# ------------------------------------------------------------ keyed draws

def test_keyed_uniform_bit_exact():
    rng = np.random.default_rng(3)
    n = 512
    seeds = np.concatenate([rng.integers(-2**31, 2**31, n - 4),
                            [0, -1, 2**31 - 1, -2**31]]).astype(np.int32)
    reqs = rng.integers(0, 2**31, n).astype(np.int32)
    purpose = rng.integers(0, 4, n).astype(np.int32)
    position = rng.integers(0, 1 << 20, n).astype(np.int32)
    args = (seeds, reqs, purpose, position)
    ref = np.asarray(jds.keyed_uniform(*[jnp.asarray(a) for a in args]))
    got = tds.keyed_uniform(*[torch.as_tensor(a) for a in args]).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    assert ((got >= 0) & (got < 1)).all()


def test_keyed_uniform_known_key():
    """``fold_in(PRNGKey(3), 5)`` in the chain, checked on one value."""
    one = [torch.tensor([x], dtype=torch.int32) for x in (3, 5, 0, 0)]
    ref = jds.keyed_uniform(*[jnp.asarray(t.numpy()) for t in one])
    assert tds.keyed_uniform(*one).numpy().view(np.int32)[0] == \
        np.asarray(ref).view(np.int32)[0]


@pytest.mark.parametrize("with_topk", [False, True])
def test_sample_rows_tokens_identical(with_topk):
    rng = np.random.default_rng(11)
    s, v = 12, 300
    logits = (rng.standard_normal((s, v)) * 3).astype(np.float32)
    temp = np.where(rng.random(s) < 0.3, 0.0,
                    rng.uniform(0.3, 2.0, s)).astype(np.float32)
    topk = np.where(rng.random(s) < 0.5, 0,
                    rng.integers(1, 50, s)).astype(np.int32)
    ints = {k: rng.integers(0, 1000, s).astype(np.int32)
            for k in ("seed", "req_id", "purpose", "position")}
    jsamp = {"temperature": jnp.asarray(temp),
             "top_k": jnp.asarray(topk) if with_topk else None,
             **{k: jnp.asarray(a) for k, a in ints.items()}}
    tsamp = {"temperature": torch.as_tensor(temp),
             "top_k": torch.as_tensor(topk) if with_topk else None,
             **{k: torch.as_tensor(a) for k, a in ints.items()}}
    ref = np.asarray(jds.sample_rows(jnp.asarray(logits), jsamp))
    got = tds.sample_rows(torch.as_tensor(logits), tsamp).numpy()
    np.testing.assert_array_equal(got, ref)


def test_paged_sample_step_tokens_identical(states):
    """One fused mixed iteration on both sides, from the same pools and
    flat batch: identical sampled tokens."""
    from repro.models import transformer as jtfm  # noqa: F401
    (cfg, pf, table, infos), (tcfg, tpf, ttable, tinfos) = states
    from repro.core import flexrank as JFR
    from repro_torch.core import flexrank as TFR
    jparams = JFR.gar_deploy(pf, cfg, infos, table, 0)
    tparams = TFR.gar_deploy(tpf, tcfg, tinfos, ttable, 0)
    rng = np.random.default_rng(5)
    nb, bs, t = 9, 4, 8
    hd = cfg.resolved_head_dim
    pools = [{"k": rng.standard_normal((1, nb, bs, cfg.num_kv_heads, hd)),
              "v": rng.standard_normal((1, nb, bs, cfg.num_kv_heads, hd))}
             for _ in cfg.segments]
    pools = [{k: a.astype(np.float32) for k, a in p.items()} for p in pools]
    tables = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    ops_np = {"slot_ids": np.asarray([0, 1, 1, 1, 1, 2, 2, 2], np.int32),
              "positions": np.asarray([9, 0, 1, 2, 3, 0, 0, 0], np.int32),
              "block_tables": tables,
              "sample_ids": np.asarray([0, 4, 0, 0], np.int32)}
    tok = rng.integers(0, cfg.vocab_size, (1, t)).astype(np.int32)
    temp = np.asarray([0.0, 0.8, 0.0, 0.0], np.float32)
    ints = {"seed": np.asarray([0, 7, 0, 0], np.int32),
            "req_id": np.asarray([0, 1, 0, 0], np.int32),
            "purpose": np.zeros(4, np.int32),
            "position": np.asarray([10, 4, 0, 0], np.int32)}
    jcaches = {**{k: jnp.asarray(a) for k, a in ops_np.items()},
               "segments": [{k: jnp.asarray(a) for k, a in p.items()}
                            for p in pools]}
    tcaches = {**{k: torch.as_tensor(a) for k, a in ops_np.items()},
               "segments": [{k: torch.as_tensor(a.copy())
                             for k, a in p.items()} for p in pools]}
    topk = np.asarray([0, 40, 0, 0], np.int32)
    jt, _ = jds.paged_sample_step(
        jparams, cfg, jcaches, jnp.asarray(tok),
        {"temperature": jnp.asarray(temp), "top_k": jnp.asarray(topk),
         **{k: jnp.asarray(a) for k, a in ints.items()}})
    tt, _ = tds.paged_sample_step(
        tparams, tcfg, tcaches, torch.as_tensor(tok),
        {"temperature": torch.as_tensor(temp),
         "top_k": torch.as_tensor(topk),
         **{k: torch.as_tensor(a) for k, a in ints.items()}})
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


# ------------------------------------------------------ engine identity

GREEDY_MIX = [(7, 4, 1.0), (8, 3, 0.4), (9, 5, 1.0), (17, 2, 0.7),
              (4, 1, 1.0), (12, 9, 0.4)]

CASES = {
    # name: (engine kwargs, request spec, sampled requests, shared prefix)
    "chunk8_device": (dict(prefill_chunk=8, prefix_cache=False), GREEDY_MIX,
                      True, False),
    "chunk3_host": (dict(prefill_chunk=3, device_sampling=False),
                    GREEDY_MIX, True, False),
    "preempt_tight_pool": (dict(max_len=32, block_size=4, num_blocks=5,
                                prefill_chunk=4),
                           [(12, 6, 1.0), (12, 6, 1.0)], False, False),
    "preempt_sampled": (dict(max_len=32, block_size=4, num_blocks=5,
                             prefill_chunk=4),
                        [(12, 6, 1.0), (12, 6, 1.0), (6, 4, 1.0)], True,
                        False),
    "prefix_cache_on": (dict(prefill_chunk=8, prefix_cache=True),
                        [(20, 3, 1.0), (21, 4, 1.0), (19, 3, 1.0),
                         (20, 2, 0.4)], True, True),
}


def _requests(cfg, spec, sampled, shared_prefix, req_cls, samp_cls):
    rng = np.random.default_rng(7)
    base = rng.integers(0, cfg.vocab_size, 64).astype(np.int32)
    out = []
    for i, (pl, mn, b) in enumerate(spec):
        prompt = (base[:pl].copy() if shared_prefix
                  else rng.integers(0, cfg.vocab_size, pl).astype(np.int32))
        if shared_prefix:
            prompt[-1] = i                 # share all but the last token
        samp = (samp_cls(temperature=0.8, top_k=40, seed=3 + i)
                if sampled and i % 2 else None)
        out.append(req_cls(prompt=prompt, max_new_tokens=mn, budget=b,
                           sampling=samp))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_token_streams_identical(states, case):
    kw, spec, sampled, shared = CASES[case]
    (cfg, pf, table, infos), (tcfg, tpf, ttable, tinfos) = states
    base = dict(max_batch=2, max_len=64, block_size=8)
    base.update(kw)
    jeng = JaxEngine(cfg, pf, table, infos, lookahead=False, **base)
    teng = ElasticEngine(tcfg, tpf, ttable, tinfos, device="cpu", **base)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jres = jeng.generate(_requests(cfg, spec, sampled, shared,
                                       JaxRequest, JaxSampling),
                             mode="continuous")
        tres = teng.generate(_requests(tcfg, spec, sampled, shared,
                                       Request, SamplingParams),
                             mode="continuous")
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert t.budget_row == j.budget_row
        assert t.deployed_params == j.deployed_params
    jm, tm = jeng.last_metrics.summary(), teng.last_metrics.summary()
    for key in ("preemptions", "mixed_iterations", "generated_tokens",
                "prefix_hits", "prefix_hit_tokens"):
        assert tm[key] == jm[key], key
    if case.startswith("preempt"):
        assert tm["preemptions"] >= 1
    if case == "prefix_cache_on":
        assert tm["prefix_hits"] >= 1


def test_cancellation_mid_flight_identical(states):
    """A request cancelled after its second token (and one cancelled while
    still waiting) finishes the same way on both engines: same delivered
    tokens, ``cancelled`` set, the other requests unchanged."""
    from repro.serving.metrics import ServingMetrics as JaxMetrics
    from repro_torch.serving.metrics import ServingMetrics as TorchMetrics
    (cfg, pf, table, infos), (tcfg, tpf, ttable, tinfos) = states

    def cancelling(base):
        class Metrics(base):
            engine = None

            def on_token(self, req_id):
                super().on_token(req_id)
                if req_id == 0 and self.traces[0].new_tokens == 2:
                    self.engine.cancel(0)
                    self.engine.cancel(3)
        return Metrics()

    kw = dict(max_batch=2, max_len=64, block_size=8, prefill_chunk=8)
    spec = [(9, 6, 1.0), (7, 5, 1.0), (12, 4, 1.0), (5, 4, 1.0)]
    out = []
    for eng, req_cls, samp_cls, mcls, c in (
            (JaxEngine(cfg, pf, table, infos, lookahead=False, **kw),
             JaxRequest, JaxSampling, JaxMetrics, cfg),
            (ElasticEngine(tcfg, tpf, ttable, tinfos, device="cpu", **kw),
             Request, SamplingParams, TorchMetrics, tcfg)):
        metrics = cancelling(mcls)
        metrics.engine = eng
        out.append(eng.generate(_requests(c, spec, True, False, req_cls,
                                          samp_cls), metrics=metrics))
    for j, t in zip(*out):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert t.cancelled == j.cancelled
    assert [r.cancelled for r in out[1]] == [True, False, False, True]


# --------------------------------------------------- device resolution

def test_engine_and_launcher_default_to_cuda(states, monkeypatch):
    """``device=None`` means the card: without CUDA both entry points
    raise instead of running on the CPU."""
    from repro_torch import resolve_device
    from repro_torch.launch import serve
    _, (tcfg, tpf, ttable, tinfos) = states
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        ElasticEngine(tcfg, tpf, ttable, tinfos)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke", "--requests", "1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")


def test_unported_engine_features_raise(states):
    """Engine features that were once refused, now ported (the name
    predates them; nothing here raises any more): the live telemetry
    plane takes a metrics registry and serves with it, its counters
    holding the stream's tokens; the drain engine serves one greedy
    request alone (no padding) with the continuous engine's stream."""
    from repro_torch.obs import MetricsRegistry
    _, (tcfg, tpf, ttable, tinfos) = states
    reg = MetricsRegistry()
    eng = ElasticEngine(tcfg, tpf, ttable, tinfos, device="cpu",
                        prefill_chunk=8, registry=reg)
    prompt = np.arange(3, 14, dtype=np.int32)
    reqs = [Request(prompt=prompt, max_new_tokens=5, budget=1.0)]
    cont = eng.generate(reqs, mode="continuous")[0]
    snap = reg.snapshot()
    assert snap["repro_generated_tokens_total"] == 5
    assert snap["repro_prefill_tokens_total"] == 11
    assert snap["repro_requests_finished_total"] == 1
    drain = eng.generate(reqs, mode="drain")[0]
    np.testing.assert_array_equal(drain.tokens, cont.tokens)
    assert len(drain.tokens) == 16


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    res = serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                      "--budgets", "0.4,1.0", "--max-new", "3",
                      "--prefill-chunk", "8", "--temperature", "0.8",
                      "--top-k", "20"])
    assert [len(r.tokens) for r in res] == [11, 11, 11]
    out = capsys.readouterr().out
    assert "# serving:" in out and "DataSVD" in out


def test_launcher_spec_decode_on_cpu(capsys):
    from repro_torch.launch import serve
    res = serve.main(["--device", "cpu", "--smoke", "--spec-draft-rank",
                      "0.9", "--spec-len", "3"])
    assert [len(r.tokens) for r in res] == [16] * 6
    out = capsys.readouterr().out
    assert "# spec decode (greedy): draft_rank=0.9, k=3" in out
