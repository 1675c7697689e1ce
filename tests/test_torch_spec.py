"""The port's nested self-speculative decoding against the JAX package's,
on the CPU, and its fused accept step on the card.

On the CPU (weights bridged from the JAX smoke fixture): ``device_accept``
commits the same tokens and accepted counts as the JAX function on random
rows (greedy, stochastic with and without top-k, mixed plans, ``k = 0``,
all accepted, first rejection); ``paged_verify_accept_step`` with riding
prefill chunks and the host oracle ``stochastic_accept`` agree with theirs;
``paged_verify_step`` is the mixed step; the port's engine with ``spec``
emits the JAX engine's token streams and per-round accepted counts on the
host sampling path (the device path's in ``test_torch_spec_engine.py``);
preemption mid-round replays; the opt-out and the
verify-only fallback equal the plain engine; paired slots conserve blocks
as the JAX cache does; and the draft slot's alias of the prompt blocks
leaves the target's K/V and streams unchanged. Token streams and accepted
counts are compared exactly (tolerance 0); logits rows, where compared,
exactly too.

The tests marked ``cuda`` run on a machine with a card (which has no JAX;
the JAX-backed tests skip there):

    PYTHONPATH=src python -m pytest -q tests/test_torch_spec.py -m cuda
"""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as tget
from repro_torch.models import transformer as ttfm
from repro_torch.serving import ElasticEngine, PagedKVCache, Request, \
    SamplingParams
from repro_torch.serving import device_sampling as tds
from repro_torch.serving.sampling import DRAW_DRAFT, DRAW_RESIDUAL, \
    DRAW_TARGET, SamplerState, sample_from
from repro_torch.spec import SpecConfig, stochastic_accept

try:
    import jax
    import jax.numpy as jnp
except ImportError:             # the card's machine has no JAX
    jax = jnp = None

torch.set_num_threads(1)


def _need_jax():
    if jnp is None:
        pytest.skip("JAX is not installed here")


@pytest.fixture(scope="module")
def states():
    """The JAX smoke state and its bridge into the port, as
    ``test_torch_serving.py`` builds them."""
    _need_jax()
    from test_torch_serving import build_states
    return build_states()


# ---------------------------------------------------------- device_accept

P, K, V = 6, 3, 300


def _accept_operands(case, seed):
    """Random verify rows and accept operands for one case: (rows (P, K+1,
    V), host operand dict of numpy arrays with q where any plan samples)."""
    rng = np.random.default_rng(seed)
    rows = (rng.standard_normal((P, K + 1, V)) * 2).astype(np.float32)
    greedy = {"greedy": np.ones(P, bool), "mixed": np.arange(P) % 2 == 0,
              "k0": np.arange(P) % 2 == 0}.get(case, np.zeros(P, bool))
    temp = np.where(greedy, 0.0, rng.uniform(0.5, 1.5, P)).astype(np.float32)
    topk = (np.where(rng.random(P) < 0.7, rng.integers(1, 40, P), 0)
            if case in ("stochastic_topk", "mixed") else np.zeros(P))
    ks = {"k0": np.zeros(P), "mixed": rng.integers(0, K + 1, P)}.get(
        case, np.full(P, K)).astype(np.int32)
    ops = {"k": ks, "temperature": temp, "top_k": topk.astype(np.int32),
           "committed": rng.integers(5, 500, P).astype(np.int32),
           "seed": rng.integers(-2**31, 2**31, P).astype(np.int32),
           "req_id": rng.integers(0, 1000, P).astype(np.int32)}
    # the target's own warp (float64 here: the q rows only need to be
    # valid distributions, not bit-equal to anything)
    z = rows / np.maximum(temp, 1e-30)[:, None, None]
    p = np.exp(z - z.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    if case == "all_accepted":
        q = p[:, :K]                            # q == p: every draft stays
    elif case == "first_rejection":
        # q all on the token p gives least: the first draft is rejected
        q = np.zeros((P, K, V))
        q[np.arange(P)[:, None], np.arange(K)[None, :],
          p[:, :K].argmin(-1)] = 1.0
    else:
        q = rng.dirichlet(np.full(V, 0.3), (P, K))
    drafts = np.zeros((P, K), np.int32)
    for i in range(P):
        for j in range(K):
            if greedy[i]:
                # greedy: drafts match the target argmax on all but the
                # first-rejection case, and half the time elsewhere
                hit = case == "all_accepted" or (
                    case != "first_rejection" and rng.random() < 0.5)
                drafts[i, j] = (rows[i, j].argmax() if hit
                                else (rows[i, j].argmax() + 1) % V)
            else:
                drafts[i, j] = sample_from(q[i, j], rng.random())
    ops["drafts"] = drafts
    if not greedy.all():
        ops["q"] = q.astype(np.float32)
    return rows, ops


_JITTED = {}


def _jitted(name, fn):
    """One jitted JAX function per name, kept for the module (compiled once
    per operand structure)."""
    if name not in _JITTED:
        _JITTED[name] = jax.jit(fn)
    return _JITTED[name]


def _jax_accept(rows, ops):
    from repro.serving import device_sampling as jds
    acc = {k: jnp.asarray(v) for k, v in ops.items()}
    if not ops["top_k"].any():
        acc.pop("top_k")
    commit, m = _jitted("accept", jds.device_accept)(jnp.asarray(rows), acc)
    return np.asarray(commit), np.asarray(m)


def _torch_accept(rows, ops, dev="cpu"):
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    acc = {"k": t(ops["k"]), "drafts": t(ops["drafts"]),
           "temperature": t(ops["temperature"])}
    if "q" in ops:
        acc["q"] = t(ops["q"])
        acc["u"] = t(tds.accept_uniforms(ops["seed"], ops["req_id"],
                                         ops["committed"], K))
        if ops["top_k"].any():
            acc["top_k"] = t(ops["top_k"])
    commit, m = tds.device_accept(t(rows), acc)
    return commit.cpu().numpy(), m.cpu().numpy()


ACCEPT_CASES = ["greedy", "stochastic", "stochastic_topk", "mixed", "k0",
                "all_accepted", "first_rejection"]


@pytest.mark.parametrize("case", ACCEPT_CASES)
def test_device_accept_bit_exact(case):
    _need_jax()
    for seed in range(3):
        rows, ops = _accept_operands(case, seed)
        jc, jm = _jax_accept(rows, ops)
        tc, tm = _torch_accept(rows, ops)
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(tc, jc)
        assert tc.dtype == np.int32 and tm.dtype == np.int32
        if case == "all_accepted":
            assert (tm == ops["k"]).all()
        if case == "first_rejection":
            assert (tm == 0).all()
        if case == "k0":
            assert (tm == 0).all()


def test_accept_uniforms_are_the_keyed_draws():
    """Column ``K + m`` and ``2K + 1 + m`` of ``accept_uniforms`` are the
    keyed ``DRAW_RESIDUAL`` and ``DRAW_TARGET`` uniforms at
    ``committed + m``."""
    _need_jax()
    from repro.serving import device_sampling as jds
    rng = np.random.default_rng(4)
    seed = rng.integers(-2**31, 2**31, 5).astype(np.int32)
    req = rng.integers(0, 100, 5).astype(np.int32)
    com = rng.integers(0, 4000, 5).astype(np.int32)
    u = tds.accept_uniforms(seed, req, com, 4)
    for m in range(5):
        for purpose, col in ((DRAW_RESIDUAL, 4 + m), (DRAW_TARGET, 9 + m)):
            ref = np.asarray(jds.keyed_uniform(
                jnp.asarray(seed), jnp.asarray(req),
                jnp.full(5, purpose, jnp.int32), jnp.asarray(com + m)))
            np.testing.assert_array_equal(u[:, col].view(np.int32),
                                          ref.view(np.int32))


# ------------------------------------------------- the fused verify step

def _deployed(states, row):
    (cfg, pf, table, infos), (tcfg, tpf, ttable, tinfos) = states
    from repro.core import flexrank as JFR
    from repro_torch.core import flexrank as TFR
    return (JFR.gar_deploy(pf, cfg, infos, table, row),
            TFR.gar_deploy(tpf, tcfg, tinfos, ttable, row))


def test_paged_verify_accept_step_identical(states):
    """Two verify runs of k_cap + 1 = 3 (one greedy, one sampled with q
    rows) and a riding chunk that finishes its prompt, through both fused
    steps from the same pools: identical commits, accepted counts and the
    chunk's first token; identical pools after."""
    from repro.serving import device_sampling as jds
    (cfg, *_), _ = states
    jparams, tparams = _deployed(states, 6)
    rng = np.random.default_rng(8)
    nb, bs = 12, 4
    hd = cfg.resolved_head_dim
    pools = [{k: (rng.standard_normal((1, nb, bs, cfg.num_kv_heads, hd))
                  ).astype(np.float32) for k in ("k", "v")}
             for _ in cfg.segments]
    tables = np.asarray([[1, 2, 3, 0], [4, 5, 6, 7], [8, 9, 0, 0],
                         [0, 0, 0, 0]], np.int32)
    # plan 0: slot 0 committed 9 (run at 8..10); plan 1: slot 1 committed
    # 13 (run at 12..14); chunk: slot 2, prompt tokens 4..6 of 7
    sid = np.asarray([0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3],
                     np.int32)
    pos = np.asarray([8, 9, 10, 12, 13, 14, 4, 5, 6] + [0] * 7, np.int32)
    sample_ids = np.asarray([0, 1, 2, 3, 4, 5, 8, 0], np.int32)
    tok = rng.integers(0, cfg.vocab_size, (1, 16)).astype(np.int32)
    ops = {"k": np.asarray([2, 2], np.int32),
           "drafts": tok[0, [1, 2, 4, 5]].reshape(2, 2),
           "committed": np.asarray([9, 13], np.int32),
           "temperature": np.asarray([0.0, 0.9], np.float32),
           "top_k": np.asarray([0, 30], np.int32),
           "seed": np.asarray([0, 77], np.int32),
           "req_id": np.asarray([0, 3], np.int32),
           "q": rng.dirichlet(np.full(cfg.vocab_size, 0.5),
                              (2, 2)).astype(np.float32)}
    chunk = {"temperature": np.asarray([0.7], np.float32),
             "top_k": np.asarray([20], np.int32),
             "seed": np.asarray([5], np.int32),
             "req_id": np.asarray([2], np.int32),
             "purpose": np.asarray([DRAW_TARGET], np.int32),
             "position": np.asarray([7], np.int32)}
    jcaches = {"slot_ids": jnp.asarray(sid), "positions": jnp.asarray(pos),
               "block_tables": jnp.asarray(tables),
               "sample_ids": jnp.asarray(sample_ids),
               "segments": [{k: jnp.asarray(a) for k, a in p.items()}
                            for p in pools]}
    jacc = {k: jnp.asarray(v) for k, v in ops.items()}
    jc, jm, jchunk, jnew = jax.jit(
        lambda *a: jds.paged_verify_accept_step(jparams, cfg, *a))(
        jcaches, jnp.asarray(tok), jacc,
        {k: jnp.asarray(v) for k, v in chunk.items()})

    tcaches = {"slot_ids": torch.as_tensor(sid),
               "positions": torch.as_tensor(pos),
               "block_tables": torch.as_tensor(tables),
               "sample_ids": torch.as_tensor(sample_ids),
               "segments": [{k: torch.as_tensor(a.copy())
                             for k, a in p.items()} for p in pools]}
    tacc = {"k": torch.as_tensor(ops["k"]),
            "drafts": torch.as_tensor(ops["drafts"]),
            "temperature": torch.as_tensor(ops["temperature"]),
            "top_k": torch.as_tensor(ops["top_k"]),
            "q": torch.as_tensor(ops["q"]),
            "u": torch.as_tensor(tds.accept_uniforms(
                ops["seed"], ops["req_id"], ops["committed"], 2))}
    tc, tm, tchunk, tnew = tds.paged_verify_accept_step(
        tparams, states[1][0], tcaches, torch.as_tensor(tok), tacc,
        {k: torch.as_tensor(v) for k, v in chunk.items()})
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tchunk.numpy(), np.asarray(jchunk))
    # the K/V written (block 0, the null block, takes the pads' writes)
    for jp, tp in zip(jnew["segments"], tnew["segments"]):
        for k in ("k", "v"):
            np.testing.assert_allclose(tp[k].numpy()[:, 1:],
                                       np.asarray(jp[k])[:, 1:],
                                       rtol=1e-5, atol=1e-5)


def test_paged_verify_step_is_the_mixed_step(states):
    """``paged_verify_step`` over a 6-token verify run gives the mixed
    step's logits bit for bit."""
    _, tparams = _deployed(states, 6)
    tcfg = states[1][0]
    cache = PagedKVCache(tcfg, max_batch=2, max_len=16, block_size=4,
                         device="cpu")
    cache.open_slot(0)
    cache.extend_slot(0, 6)
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (1, 8)).astype(np.int32))

    def mk():
        sid = np.full(8, 2, np.int32)
        sid[:6] = 0
        pos = np.zeros(8, np.int32)
        pos[:6] = np.arange(6)
        return {"slot_ids": torch.as_tensor(sid),
                "positions": torch.as_tensor(pos),
                "block_tables": cache.device_tables(null_rows=1),
                "segments": cache.pools}

    lv, _ = ttfm.paged_verify_step(tparams, tcfg, mk(), tok)
    lm, _ = ttfm.paged_mixed_step(tparams, tcfg, mk(), tok)
    assert torch.equal(lv, lm)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stochastic_accept_identical(seed):
    """The host oracle on the same samplers, drafts and rows: the same
    committed tokens and accepted count as the JAX package's."""
    _need_jax()
    from repro.serving.sampling import SamplerState as JSampler
    from repro.serving.sampling import SamplingParams as JParams
    from repro.spec import stochastic_accept as jaccept
    rng = np.random.default_rng(seed)
    v, k = 64, 4
    rows = (rng.standard_normal((k + 1, v)) * 2).astype(np.float32)
    knobs = dict(temperature=float(rng.uniform(0.5, 1.5)),
                 top_k=int(rng.integers(0, 20)), seed=seed + 10)
    ts = SamplerState(SamplingParams(**knobs), req_id=seed)
    js = JSampler(JParams(**knobs), req_id=seed)
    # draft proposals from a blend of the target's own warp and noise, so
    # both the accept and the residual branches fire across seeds
    drafts, qs = [], []
    for j in range(k):
        q = 0.5 * ts.probs(rows[j]) + 0.5 * rng.dirichlet(np.ones(v))
        drafts.append(sample_from(q, ts.uniform(20 + j, DRAW_DRAFT)))
        qs.append(q)
    got = stochastic_accept(ts, 20, drafts, qs, rows)
    want = jaccept(js, 20, drafts, qs, rows)
    assert got == want


# ------------------------------------------------------------ the engine

def make_requests(cfg, spec, req_cls, samp_cls, seed=7, sampled=True, **kw):
    rng = np.random.default_rng(seed)
    return [req_cls(prompt=rng.integers(0, cfg.vocab_size, pl).astype(
                        np.int32),
                    max_new_tokens=mn, budget=b,
                    sampling=(samp_cls(temperature=0.8, top_k=40, seed=3 + i)
                              if sampled and i % 2 else None), **kw)
            for i, (pl, mn, b) in enumerate(spec)]


# all at the top row, which drafts with the row draft_rank 0.9 resolves
# and serves without speculation at 0.5 (no prefix row fits)
IDENTITY_SPEC = [(7, 6, 1.0), (9, 7, 1.0), (17, 4, 1.0), (4, 1, 1.0),
                 (12, 11, 1.0)]
# 8-token prompt chunks ride the verify forwards; a token budget of 18
# leaves room for two runs of spec_len 4 beside a chunk. With draft-cache
# warmup in feeds of 8 (``gap_chunk``) the flat widths stay at 8 and 16,
# so the JAX engine compiles few shapes (it compiles every new one; the
# device path's engine tests sit in ``test_torch_spec_engine.py`` so that
# each file runs in under a minute). 10 blocks of 16 hold this workload's
# two slot pairs; two 44-token sequences overflow them.
BASE_KW = dict(max_batch=2, max_len=64, block_size=16, num_blocks=10,
               prefill_chunk=8, token_budget=18)


def make_engines(states, device_sampling: bool):
    """A JAX and a port engine on one sampling path, reused across specs
    (the JAX engine keeps its compiled steps per instance)."""
    from repro.serving import ElasticEngine as JaxEngine
    (cfg, pf, table, infos), (tcfg, tpf, ttable, tinfos) = states
    return (JaxEngine(cfg, pf, table, infos, lookahead=False,
                      device_sampling=device_sampling, **BASE_KW),
            ElasticEngine(tcfg, tpf, ttable, tinfos, device="cpu",
                          device_sampling=device_sampling, **BASE_KW))


@pytest.fixture(scope="module")
def host_engines(states):
    return make_engines(states, False)


def run_both(states, jeng, teng, jspec, tspec, reqs_spec, **kw):
    from repro.serving import Request as JaxRequest
    from repro.serving import SamplingParams as JaxSampling
    (cfg, *_), (tcfg, *_) = states
    jeng.spec, teng.spec = jspec, tspec
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jres = jeng.generate(make_requests(cfg, reqs_spec, JaxRequest,
                                       JaxSampling, **kw), mode="continuous")
        tres = teng.generate(make_requests(tcfg, reqs_spec, Request,
                                       SamplingParams, **kw),
                             mode="continuous")
    return jres, tres


def check_streams_identical(states, jeng, teng, spec_len, draft_rank):
    """Half the requests greedy, half temperature 0.8 / top-k 40: the same
    token streams, the same rounds and accepted counts as the JAX engine
    (draft rank 0.5 resolves no prefix row on the smoke table and serves
    without speculation)."""
    from repro.serving import SpecConfig as JaxSpec
    jres, tres = run_both(
        states, jeng, teng,
        JaxSpec(draft_rank=draft_rank, spec_len=spec_len, gap_chunk=8),
        SpecConfig(draft_rank=draft_rank, spec_len=spec_len, gap_chunk=8),
        IDENTITY_SPEC)
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert t.budget_row == j.budget_row
    jm, tm = jeng.last_metrics, teng.last_metrics
    assert tm.spec_round_log == jm.spec_round_log
    assert (len(tm.spec_round_log) > 0) == (draft_rank == 0.9)
    for key in ("generated_tokens", "mixed_iterations", "preemptions"):
        assert tm.summary()[key] == jm.summary()[key], key
    for r in range(states[1][2].table.shape[0]):
        assert teng.spec_draft_row(r) == jeng.spec_draft_row(r)


@pytest.mark.parametrize("draft_rank", [0.5, 0.9])
@pytest.mark.parametrize("spec_len", [2, 4])
def test_spec_engine_streams_identical_host_sampling(states, host_engines,
                                                     spec_len, draft_rank):
    check_streams_identical(states, *host_engines, spec_len, draft_rank)


def test_spec_preemption_mid_round_identical(states, host_engines):
    """Two sequences of 44 tokens, each holding a draft and a target slot,
    overflow the 10-block pool: preemption drops the in-flight drafts and
    recomputes. The port preempts where the JAX engine does and emits its
    streams; a second run replays them; the greedy stream equals the plain
    engine's."""
    from repro.serving import SpecConfig as JaxSpec
    _, (tcfg, *_) = states
    jeng, teng = host_engines
    spec = [(24, 20, 1.0), (24, 20, 1.0)]
    jres, tres = run_both(
        states, jeng, teng,
        JaxSpec(draft_rank=0.9, spec_len=3, gap_chunk=8),
        SpecConfig(draft_rank=0.9, spec_len=3, gap_chunk=8), spec)
    assert teng.last_metrics.preemptions >= 1
    assert teng.last_metrics.preemptions == jeng.last_metrics.preemptions
    assert teng.last_metrics.spec_round_log == jeng.last_metrics.spec_round_log
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, j.tokens)
    again = teng.generate(make_requests(tcfg, spec, Request, SamplingParams))
    for a, b in zip(tres, again):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    teng.spec = None
    ref = teng.generate(make_requests(tcfg, spec, Request, SamplingParams))
    np.testing.assert_array_equal(tres[0].tokens, ref[0].tokens)


@pytest.mark.parametrize("device_sampling", [True, False],
                         ids=["device", "host"])
def test_spec_opt_out_and_verify_only_match_plain(states, device_sampling):
    """``Request.spec_len = 0`` and ``SpecConfig(stochastic=False)``: no
    sequence drafts, and the streams equal the non-speculative engine's
    (the sampled ones included)."""
    _, (tcfg, tpf, ttable, tinfos) = states
    spec = [(9, 5, 1.0), (7, 5, 1.0), (11, 6, 1.0), (6, 4, 1.0)]
    reqs = make_requests(tcfg, spec, Request, SamplingParams, seed=9)
    reqs[0].spec_len = 0
    eng = ElasticEngine(tcfg, tpf, ttable, tinfos, device="cpu",
                        device_sampling=device_sampling,
                        spec=SpecConfig(draft_rank=0.9, spec_len=3,
                                        stochastic=False), **BASE_KW)
    res = eng.generate(reqs)
    base = ElasticEngine(tcfg, tpf, ttable, tinfos, device="cpu",
                         device_sampling=device_sampling, **BASE_KW)
    ref = base.generate(make_requests(tcfg, spec, Request, SamplingParams,
                                  seed=9))
    for a, b in zip(res, ref):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    s = eng.last_metrics.summary()
    assert s["spec_rounds"] > 0
    # only the greedy request without the opt-out drafts
    assert s["spec_draft_tokens"] > 0
    reqs = make_requests(tcfg, spec, Request, SamplingParams, seed=9)
    for r in reqs:
        r.spec_len = 0 if r.sampling is None else None
    eng.generate(reqs)
    assert eng.last_metrics.summary()["spec_draft_tokens"] == 0


@pytest.mark.parametrize("device_sampling", [True, False],
                         ids=["device", "host"])
def test_self_draft_accepts_every_draft(states, device_sampling,
                                        monkeypatch):
    """The top row drafting for itself: every draft is accepted (greedy
    drafts are the target's own argmax, stochastic ones have q = p), and
    the greedy streams stay the plain engine's. A fault in the draft path
    (a proposal fed at the wrong place) would show here, where random
    weights keep the prefix rows' acceptance near 0."""
    _, (tcfg, tpf, ttable, tinfos) = states
    top = ttable.table.shape[0] - 1
    eng = ElasticEngine(tcfg, tpf, ttable, tinfos, device="cpu",
                        device_sampling=device_sampling,
                        spec=SpecConfig(draft_rank=0.9, spec_len=4,
                                        gap_chunk=8), **BASE_KW)
    monkeypatch.setattr(eng, "spec_draft_row",
                        lambda r: r if r == top else None)
    spec = [(9, 12, 1.0), (13, 12, 1.0), (17, 12, 1.0), (21, 12, 1.0)]
    res = eng.generate(make_requests(tcfg, spec, Request, SamplingParams,
                                     seed=3))
    s = eng.last_metrics.summary()
    assert s["spec_draft_tokens"] > 0
    assert s["spec_accepted_tokens"] == s["spec_draft_tokens"]
    monkeypatch.undo()
    eng.spec = None
    ref = eng.generate(make_requests(tcfg, spec, Request, SamplingParams,
                                     seed=3))
    for i in (0, 2):                            # the greedy requests
        np.testing.assert_array_equal(res[i].tokens, ref[i].tokens)


def test_draft_alias_leaves_target_streams_unchanged(states, host_engines,
                                                     monkeypatch):
    """Prefix caching on: each draft slot aliases its target's prompt
    blocks. The greedy and sampled streams stay the plain engine's and the
    JAX spec engine's, with prompt tokens really shared."""
    from repro.serving import SpecConfig as JaxSpec
    _, (tcfg, tpf, ttable, tinfos) = states
    shared = []
    real = PagedKVCache.share_prefix

    def spy(self, src, dst, plen):
        shared.append(real(self, src, dst, plen))
        return shared[-1]
    monkeypatch.setattr(PagedKVCache, "share_prefix", spy)
    spec = [(20, 6, 1.0), (17, 5, 1.0), (18, 7, 1.0)]
    # the module's engines, with prefix caching on for this run
    jeng, teng = host_engines
    for e in (jeng, teng):
        monkeypatch.setattr(e, "prefix_cache", True)
    jres, tres = run_both(states, jeng, teng,
                          JaxSpec(draft_rank=0.9, spec_len=3, gap_chunk=8),
                          SpecConfig(draft_rank=0.9, spec_len=3,
                                     gap_chunk=8), spec)
    assert sum(shared) == 48                 # a 16-token block each
    plain = ElasticEngine(tcfg, tpf, ttable, tinfos, device="cpu",
                          prefix_cache=True, **BASE_KW)
    ref = plain.generate(make_requests(tcfg, spec, Request, SamplingParams))
    for i, (j, t, r) in enumerate(zip(jres, tres, ref)):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        if i % 2 == 0:                          # the greedy requests
            np.testing.assert_array_equal(t.tokens, r.tokens)


def test_draft_write_into_shared_block_copies_it(states):
    """The pools change in place: a draft slot rewound into a block it
    shares with its target must copy the block before the next forward
    writes it, leaving the target's K/V bit-unchanged."""
    _, tparams = _deployed(states, 0)
    tcfg = states[1][0]
    cache = PagedKVCache(tcfg, max_batch=4, max_len=32, block_size=4,
                         prefix_cache=True, device="cpu")
    rng = np.random.default_rng(1)
    for pool in cache.pools:
        for a in pool.values():
            a.copy_(torch.as_tensor(rng.standard_normal(a.shape).astype(
                np.float32)))
    cache.open_slot(0)
    cache.extend_slot(0, 10)
    cache.open_slot(2)                          # seat 0's draft slot
    assert cache.share_prefix(0, 2, 10) == 8
    target_blocks = list(cache.slots[0].blocks)
    before = [{k: a[:, target_blocks].clone() for k, a in p.items()}
              for p in cache.pools]
    cache.truncate_slot(2, 6)                   # mid-block of a shared block
    cache.extend_slot(2, 2)                     # copy-on-write
    assert cache.stats.cow_copies == 1
    assert cache.slots[2].blocks[1] != target_blocks[1]
    assert cache.slots[2].blocks[0] == target_blocks[0]
    sid = torch.as_tensor(np.asarray([2, 2, 4, 4, 4, 4, 4, 4], np.int32))
    pos = torch.as_tensor(np.asarray([6, 7, 0, 0, 0, 0, 0, 0], np.int32))
    tok = torch.as_tensor(rng.integers(0, tcfg.vocab_size, (1, 8)).astype(
        np.int32))
    ttfm.paged_mixed_step(tparams, tcfg, {
        "slot_ids": sid, "positions": pos,
        "block_tables": cache.device_tables(null_rows=1),
        "segments": cache.pools}, tok)
    for p, b in zip(cache.pools, before):
        for k in ("k", "v"):
            assert torch.equal(p[k][:, target_blocks], b[k])
    # the draft's private copy kept the shared positions 4 and 5
    own = cache.slots[2].blocks[1]
    for p, b in zip(cache.pools, before):
        for k in ("k", "v"):
            assert torch.equal(p[k][:, own, :2], b[k][:, 1, :2])


def _walk(cache_cls, cfg, seed, steps=300):
    """The JAX suite's paired-slot walk (seat s owns slots s and PAIRS + s):
    alloc, extend, truncate, append, draft-KV sharing and paired frees.
    Returns every step's tables and free count, and the final free count."""
    from repro.serving.kv_cache import CacheOOM as JaxOOM
    from repro_torch.serving.kv_cache import CacheOOM as TorchOOM
    rng = np.random.default_rng(seed)
    pairs = 2
    cache = cache_cls(cfg, max_batch=4, max_len=16, block_size=2,
                      num_blocks=12, prefix_cache=True)
    trail = []
    for _ in range(steps):
        op = rng.integers(0, 6)
        seat = int(rng.integers(0, pairs))
        tgt, drf = seat, pairs + seat
        try:
            if op == 0 and cache.slots[tgt] is None:
                cache.open_slot(tgt)
                cache.open_slot(drf)
            elif cache.slots[tgt] is None:
                continue
            elif op == 1:
                cache.extend_slot(int(rng.choice([tgt, drf])),
                                  int(rng.integers(1, 5)),
                                  clip=bool(rng.integers(0, 2)))
            elif op == 2:
                slot = int(rng.choice([tgt, drf]))
                cache.truncate_slot(slot, int(rng.integers(
                    0, cache.slots[slot].num_tokens + 1)))
            elif op == 3:
                cache.append_token(int(rng.choice([tgt, drf])))
            elif op == 4:
                if cache.slots[drf].num_tokens == 0:
                    cache.share_prefix(tgt, drf, int(rng.integers(
                        0, cache.slots[tgt].num_tokens + 1)))
            elif op == 5:
                cache.free_slot(tgt)
                cache.free_slot(drf)
        except (JaxOOM, TorchOOM):
            pass
        trail.append((cache.host_tables().tolist(),
                      cache.allocator.free_count))
    for seat in range(pairs):
        if cache.slots[seat] is not None:
            cache.free_slot(seat)
            cache.free_slot(pairs + seat)
    return trail, cache.allocator.free_count, cache.allocator.num_blocks


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paired_slots_conserve_blocks(seed):
    """The same walk on both caches: the same tables and free counts at
    every step, and every block back on the free list at the end."""
    _need_jax()
    from repro.configs import get_config
    from repro.serving import PagedKVCache as JaxCache
    t_trail, t_free, t_n = _walk(
        lambda *a, **k: PagedKVCache(*a, device="cpu", **k),
        tget("gpt2-small", smoke=True), seed)
    j_trail, j_free, _ = _walk(JaxCache, get_config("gpt2-small", smoke=True),
                               seed)
    assert t_trail == j_trail
    assert t_free == j_free == t_n - 1


def test_spec_config_and_draft_rows(states):
    with pytest.raises(ValueError, match="draft_rank"):
        SpecConfig(draft_rank=0.0)
    with pytest.raises(ValueError, match="spec_len"):
        SpecConfig(draft_rank=0.5, spec_len=0)
    _, (tcfg, tpf, ttable, tinfos) = states
    eng = ElasticEngine(tcfg, tpf, ttable, tinfos, device="cpu",
                        spec=SpecConfig(draft_rank=0.9, spec_len=2))
    top = ttable.table.shape[0] - 1
    assert eng.spec_draft_row(0) is None
    assert eng.spec_draft_row(top) is not None
    assert ElasticEngine(tcfg, tpf, ttable, tinfos,
                         device="cpu").spec_draft_row(top) is None


# ------------------------------------------------------------- the card

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def gpt2_round(dev):
    """gpt2-small at full width (dense weights from seed 0) with a paged
    cache holding 8 sequences of 90-160 tokens, and the operands of one
    round: 8 verify runs of k_cap + 1 = 5 (half sampled, with q rows) and
    a 64-token chunk that finishes its prompt."""
    from repro_torch.launch.train import dense_init
    cfg = tget("gpt2-small")
    params = dense_init(cfg, 0, dev)
    rng = np.random.default_rng(0)
    cache = PagedKVCache(cfg, max_batch=9, max_len=256, block_size=16,
                         prefix_cache=False, device=dev)
    committed = rng.integers(90, 160, 8).astype(np.int32)
    for s, n in enumerate(committed):
        cache.open_slot(s)
        cache.extend_slot(s, int(n) + 4)
    cache.open_slot(8)
    cache.extend_slot(8, 100)
    gen = torch.Generator(dev).manual_seed(1)
    for pool in cache.pools:
        for a in pool.values():
            a.normal_(generator=gen)
    kk, v = 5, cfg.vocab_size
    sid = np.concatenate([np.repeat(np.arange(8), kk), np.full(64, 8)])
    pos = np.concatenate([np.concatenate([np.arange(c - 1, c + 4)
                                          for c in committed]),
                          np.arange(36, 100)])
    t = len(sid)
    tok = rng.integers(0, v, (1, t)).astype(np.int32)
    temp = np.where(np.arange(8) % 2, 0.8, 0.0).astype(np.float32)
    seed = np.where(temp > 0, 100 + np.arange(8), 0).astype(np.int32)
    req = np.arange(8, dtype=np.int32)
    q = rng.dirichlet(np.full(v, 0.1), (8, 4)).astype(np.float32)
    accept = {"k": np.full(8, 4, np.int32),
              "drafts": tok[0, :40].reshape(8, kk)[:, 1:].copy(),
              "temperature": temp, "top_k": np.full(8, 40, np.int32),
              "q": q, "u": tds.accept_uniforms(seed, req, committed, 4)}
    sample_ids = np.concatenate([np.arange(40), [t - 1], [0, 0, 0]])
    chunk = {"temperature": np.asarray([0.8, 0, 0, 0], np.float32),
             "top_k": np.asarray([40, 0, 0, 0], np.int32),
             "seed": np.asarray([9, 0, 0, 0], np.int32),
             "req_id": np.asarray([8, 0, 0, 0], np.int32),
             "purpose": np.zeros(4, np.int32),
             "position": np.asarray([100, 0, 0, 0], np.int32)}
    return dict(cfg=cfg, params=params, cache=cache, sid=sid, pos=pos,
                tok=tok, accept=accept, sample_ids=sample_ids, chunk=chunk,
                committed=committed, seed=seed, req=req)


def _round_call(r, dev):
    """One ``paged_verify_accept_step`` with operands uploaded as the
    decoder uploads them (queued, no wait)."""
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(  # noqa
        dev, non_blocking=True)
    caches = {"slot_ids": up(r["sid"].astype(np.int32)),
              "positions": up(r["pos"].astype(np.int32)),
              "block_tables": up(r["cache"].host_tables(null_rows=1)),
              "segments": r["cache"].pools,
              "sample_ids": up(r["sample_ids"].astype(np.int32))}
    accept = {k: up(a) for k, a in r["accept"].items()}
    chunk = {k: (up(a) if k in ("temperature", "top_k")
                 else torch.from_numpy(a)) for k, a in r["chunk"].items()}
    commit, m, first, _ = tds.paged_verify_accept_step(
        r["params"], r["cfg"], caches, up(r["tok"]), accept, chunk)
    return commit, m, first, accept


@pytest.mark.cuda
def test_verify_accept_step_on_card_is_sync_free(dev, gpt2_round):
    _round_call(gpt2_round, dev)               # kernels built outside
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = _round_call(gpt2_round, dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    commit, m = out[0].cpu(), out[1].cpu()
    assert commit.shape == (8, 5) and m.shape == (8,)
    assert ((m >= 0) & (m <= 4)).all()


@pytest.mark.cuda
def test_verify_accept_step_on_card_repeats(dev, gpt2_round):
    a = [t.cpu() for t in _round_call(gpt2_round, dev)[:3]]
    b = [t.cpu() for t in _round_call(gpt2_round, dev)[:3]]
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_gathered_uniforms_are_keyed_at_committed_plus_m(dev, gpt2_round):
    """The residual and bonus uniforms the step gathers by ``m`` on the
    card are ``keyed_uniform`` at ``committed + m``."""
    _, m, _, accept = _round_call(gpt2_round, dev)
    u = accept["u"]
    got_res = torch.gather(u[:, 4:9], 1, m.long()[:, None])[:, 0].cpu()
    got_bon = torch.gather(u[:, 9:], 1, m.long()[:, None])[:, 0].cpu()
    pos = torch.as_tensor(gpt2_round["committed"]) + m.cpu()
    for purpose, got in ((DRAW_RESIDUAL, got_res), (DRAW_TARGET, got_bon)):
        want = tds.keyed_uniform(
            torch.as_tensor(gpt2_round["seed"]),
            torch.as_tensor(gpt2_round["req"]),
            torch.full((8,), purpose, dtype=torch.int32), pos.to(torch.int32))
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ACCEPT_CASES)
def test_device_accept_on_card_matches_cpu(dev, case):
    """The accept arithmetic on the card commits what it commits on the
    CPU, on the random rows of the JAX comparison."""
    for seed in range(3):
        rows, ops = _accept_operands(case, seed)
        gc, gm = _torch_accept(rows, ops, dev)
        cc, cm_ = _torch_accept(rows, ops)
        np.testing.assert_array_equal(gm, cm_)
        np.testing.assert_array_equal(gc, cc)
