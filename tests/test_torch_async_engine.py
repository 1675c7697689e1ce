"""The port's one-iteration lookahead pipeline against the JAX engine, on
the CPU, and one speculative iteration on the card.

Mirrors ``tests/test_async_engine.py``, holding the port against the JAX
package (weights bridged from the JAX smoke fixture of
``test_torch_serving.py``) with tolerance 0 on tokens, greedy and sampled
alike (the port reproduces the keyed threefry uniforms bit for bit):

  * the identity matrix (``plain``, ``chunked``, ``prefix``,
    ``tight_blocks``): the port's lookahead streams equal the JAX engine's
    synchronous streams, which equal the port's synchronous streams;
  * forced rollbacks (``lookahead_fault``), plain and with prefix caching,
    and a rollback of a plan that made a copy-on-write (the port's pools
    change in place, the reference's are rebound);
  * lookahead with ``spec`` (speculative rows stay commit-serial), and
    without device sampling (served serially);
  * trace balance: every ``lookahead`` span ends in exactly one
    ``lookahead_commit`` or ``rollback``;
  * the double-buffer state machine (seeded): plan, predicted advance,
    commit, rollback and cancel on standalone scheduler, cache and batcher,
    a restore byte-equal to its snapshot, and exact block accounting.

The test marked ``cuda`` runs on a machine with a card (no JAX there):

    PYTHONPATH=src python -m pytest -q tests/test_torch_async_engine.py -m cuda

The streaming front door's tests are in ``test_torch_session.py``, which
shares this file's fixtures and helpers.
"""
import functools
import random
import warnings

import numpy as np
import pytest
import torch

from repro_torch.obs import make_tracer
from repro_torch.serving import (ContinuousBatcher, ElasticEngine,
                                 PagedKVCache, Request, SamplingParams,
                                 Scheduler, ServingMetrics)
from repro_torch.serving.engine import _DeferredLog
from repro_torch.spec import SpecConfig

try:
    import jax  # noqa: F401
except ImportError:             # the card's machine has no JAX
    jax = None

torch.set_num_threads(1)

BLOCK = 8
STOCH = dict(temperature=0.8, top_k=8)

# prompts straddle block boundaries; max_new covers one-token edges and
# multi-iteration decodes; budgets route to three rows; every other request
# samples (keyed draws, so identity must hold for it too)
MIX = [(7, 6, 1.0, False), (8, 3, 0.4, True), (9, 7, 1.0, False),
       (17, 2, 0.7, True), (4, 1, 1.0, False), (12, 8, 1.0, True)]

# per case (engine kwargs, request spec); tight_blocks shrinks the pool
# under long decodes so sequences preempt each other mid-stream
MATRIX = {
    "plain": (dict(), MIX),
    "chunked": (dict(prefill_chunk=4, token_budget=8), MIX),
    "prefix": (dict(prefix_cache=True), MIX),
    "tight_blocks": (dict(max_len=32, block_size=4, num_blocks=4,
                          prefill_chunk=4, token_budget=8),
                     [(4, 11, 1.0, False), (4, 11, 1.0, True),
                      (6, 9, 1.0, False), (9, 7, 1.0, True)]),
}


def _need_jax():
    if jax is None:
        pytest.skip("JAX is not installed here")


@functools.cache
def _built_states():
    from test_torch_serving import build_states
    return build_states()


@pytest.fixture(scope="module")
def states():
    """The JAX smoke state and its bridge into the port (built once a
    process; ``test_torch_session.py`` shares it)."""
    _need_jax()
    return _built_states()


def requests(cfg, spec, req_cls, samp_cls, seed=7):
    out = []
    for i, (pl, mn, b, stoch) in enumerate(spec):
        rng = np.random.default_rng(seed + i)
        prompt = rng.integers(0, cfg.vocab_size, pl).astype(np.int32)
        sampling = samp_cls(seed=seed, **STOCH) if stoch else None
        out.append(req_cls(prompt=prompt, max_new_tokens=mn, budget=b,
                           sampling=sampling))
    return out


def streams(reqs, results):
    return [list(map(int, r.tokens[len(rq.prompt):]))
            for rq, r in zip(reqs, results)]


def port_engine(states, **kw):
    _, (tcfg, tpf, ttable, tinfos) = states
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("block_size", BLOCK)
    return ElasticEngine(tcfg, tpf, ttable, tinfos, device="cpu", **kw)


@functools.cache
def _jax_template():
    from repro.serving import ElasticEngine as JaxEngine
    (cfg, pf, table, infos), _ = _built_states()
    return JaxEngine(cfg, pf, table, infos, lookahead=False)


def jax_engine(**kw):
    """A synchronous JAX engine that shares one template's jitted steps and
    deployed rows: the JAX engine compiles every new shape per instance,
    and the steps depend on the config alone."""
    from repro.serving import ElasticEngine as JaxEngine
    tpl = _jax_template()
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("block_size", BLOCK)
    eng = JaxEngine(tpl.cfg, tpl.params_fact, tpl.table, tpl.infos,
                    lookahead=False, **kw)
    for name, value in vars(tpl).items():
        if name.endswith("_jit"):
            setattr(eng, name, value)
    eng._deployed = tpl._deployed
    return eng


def jax_streams(mix, **kw):
    """The JAX engine's synchronous streams of ``mix``'s requests."""
    from repro.serving import Request as JaxRequest
    from repro.serving import SamplingParams as JaxSampling
    cfg = _built_states()[0][0]
    reqs = requests(cfg, mix, JaxRequest, JaxSampling)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return streams(reqs, jax_engine(**kw).generate(reqs))


def port_streams(eng, spec):
    reqs = requests(eng.cfg, spec, Request, SamplingParams)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return streams(reqs, eng.generate(reqs))


@pytest.fixture(scope="module")
def jax_sync(states):
    """The JAX engine's synchronous streams per matrix case, once each."""
    return {case: jax_streams(spec, **kw)
            for case, (kw, spec) in MATRIX.items()}


# ---------------------------------------------------------- identity matrix

@pytest.mark.parametrize("case", list(MATRIX))
def test_lookahead_identity_matrix(states, jax_sync, case):
    """Lookahead streams equal the JAX engine's synchronous ones, which
    equal the port's synchronous ones, under every cache and prefill
    regime, mid-prefill preemption (tight_blocks) included."""
    kw, spec = MATRIX[case]
    sync = port_streams(port_engine(states, lookahead=False, **kw), spec)
    eng = port_engine(states, lookahead=True, **kw)
    got = port_streams(eng, spec)
    assert sync == jax_sync[case]
    assert got == jax_sync[case]
    m = eng.last_metrics.summary()
    assert m["lookahead_iterations"] > 0
    assert m["overlap_fraction"] > 0.0
    if case == "tight_blocks":
        assert m["preemptions"] > 0       # the case exists to force these
    if case == "plain":
        assert m["rollbacks"] == 0        # nothing invalidates speculation


@pytest.mark.parametrize("case", ["plain", "prefix"])
def test_forced_rollback_identity(states, jax_sync, case):
    """Fault injection forces periodic rollbacks; restore and commit replay
    leave the streams identical."""
    kw, spec = MATRIX[case]
    eng = port_engine(states, lookahead=True, **kw)
    eng.lookahead_fault = lambda it: it % 3 == 0
    assert port_streams(eng, spec) == jax_sync[case]
    m = eng.last_metrics.summary()
    assert m["rollbacks"] > 0
    assert m["lookahead_iterations"] > m["rollbacks"]


# Outside speculative decoding's rewinds no write lands in a shared block:
# the prefix probe maps whole blocks. The copy-on-write test makes the probe
# rewind each hit three tokens into its last block, as a token-granular
# prefix cache would, so the admission's first chunk copies that block on
# write. Request 2 shares request 0's first block and is seated when request
# 1 leaves, inside a speculative plan.
COW_SPEC = [(16, 8, 1.0, False), (5, 2, 1.0, True), (13, 4, 1.0, True)]
COW_KW = dict(prefix_cache=True, prefill_chunk=8)


def _cow_requests(cfg, req_cls, samp_cls):
    reqs = requests(cfg, COW_SPEC, req_cls, samp_cls)
    reqs[2].prompt[:BLOCK] = reqs[0].prompt[:BLOCK]
    return reqs


def _rewinding_probe(cache_cls, monkeypatch):
    probe = cache_cls.probe_prefix

    def rewound(self, slot, tokens):
        hit = probe(self, slot, tokens)
        if hit:
            hit -= 3
            self.truncate_slot(slot, hit)    # keeps the block, shared
        return hit
    monkeypatch.setattr(cache_cls, "probe_prefix", rewound)


def test_forced_rollback_after_copy_on_write(states, monkeypatch):
    """A speculative plan that copies a shared block on write is rolled
    back: its copy went to a block the plan allocated, the abandoned
    dispatch still writes into it in place, and the replan copies again
    behind it on the stream. The streams equal the port's and the JAX
    engine's synchronous ones."""
    from repro.serving import Request as JaxRequest
    from repro.serving import SamplingParams as JaxSampling
    from repro.serving.kv_cache import PagedKVCache as JaxCache
    _rewinding_probe(JaxCache, monkeypatch)
    _rewinding_probe(PagedKVCache, monkeypatch)
    (cfg, *_), (tcfg, *_) = states
    jreqs = _cow_requests(cfg, JaxRequest, JaxSampling)
    want = streams(jreqs, jax_engine(**COW_KW).generate(jreqs))
    reqs = _cow_requests(tcfg, Request, SamplingParams)
    sync = port_engine(states, lookahead=False, **COW_KW)
    assert streams(reqs, sync.generate(reqs)) == want

    eng = port_engine(states, lookahead=True, **COW_KW)
    eng.lookahead_fault = lambda it: True     # roll back every speculation
    rolled_back_cows = []
    rollback = eng._rollback

    def spy(snap, touched, pending, sched, cache, *a):
        before = snap["cache"]["stats"].cow_copies
        rolled_back_cows.append(cache.stats.cow_copies - before)
        return rollback(snap, touched, pending, sched, cache, *a)
    eng._rollback = spy
    assert streams(reqs, eng.generate(reqs)) == want
    assert any(n > 0 for n in rolled_back_cows), rolled_back_cows
    for e in (sync, eng):
        m = e.last_metrics.summary()
        assert m["prefix_hits"] == 1 and m["prefix_hit_tokens"] == 5


def test_lookahead_identity_with_spec(states):
    """Speculative rows serve through the commit-serial decoder in both
    modes, non-speculative rows pipeline: the streams equal the JAX
    engine's synchronous speculative ones."""
    from repro.serving import SpecConfig as JaxSpec
    want = jax_streams(MIX, spec=JaxSpec(draft_rank=0.9, spec_len=3))
    eng = port_engine(states, lookahead=True,
                      spec=SpecConfig(draft_rank=0.9, spec_len=3))
    assert port_streams(eng, MIX) == want
    m = eng.last_metrics.summary()
    assert m["spec_rounds"] > 0
    assert m["lookahead_iterations"] > 0     # the 0.4 row pipelines


def test_lookahead_requires_device_sampling(states):
    """Host sampling reads logits between dispatch and commit, the wait
    the pipeline removes: the engine serves the serial loop instead."""
    want = jax_streams(MIX[:2], device_sampling=False)
    eng = port_engine(states, lookahead=True, device_sampling=False)
    assert port_streams(eng, MIX[:2]) == want
    assert eng.last_metrics.summary()["lookahead_iterations"] == 0


def test_trace_balance(states):
    """Every lookahead span ends in exactly one commit or rollback
    instant: none lost, none resolved twice."""
    eng = port_engine(states, lookahead=True, tracer=make_tracer(True))
    eng.lookahead_fault = lambda it: it % 4 == 0
    port_streams(eng, MIX)
    names = [e["name"] for e in eng.tracer.to_chrome()["traceEvents"]]
    lookaheads = names.count("lookahead")
    assert lookaheads > 0 and names.count("rollback") > 0
    assert lookaheads == (names.count("lookahead_commit")
                          + names.count("rollback"))


# --------------------------------------------- double-buffered state machine

class _RowMachine:
    """Drives the engine's double-buffer primitives (plan and predicted
    advance, commit apply, rollback restore, cancel) on standalone
    scheduler, cache and batcher state, checking after every rollback that
    the restore is byte-equal to the snapshot, and after every step that
    block accounting is exact."""

    def __init__(self, states, seed):
        self.eng = port_engine(states, prefill_chunk=4, token_budget=8)
        cfg = self.eng.cfg
        self.sched = Scheduler(self.eng.router)
        self.cache = PagedKVCache(cfg, max_batch=2, max_len=32,
                                  block_size=4, num_blocks=10,
                                  prefix_cache=False, device="cpu")
        self.batcher = ContinuousBatcher(2)
        self.metrics = ServingMetrics()
        self.results = {}
        self.rnd = random.Random(seed)
        self.total_blocks = self.cache.allocator.free_count
        self.pending = None      # (plan, snapshot, canonical bytes)
        self.intake = []         # arrivals held while a plan is in flight
        self.row = 0
        self.req_ids = []
        self.submitted = 0
        self.rollbacks = 0

    def canon(self) -> bytes:
        seqs = {s.req_id: s for s in self.batcher.active_sequences()}
        for q in self.sched.queues.values():
            for s in q:
                seqs[s.req_id] = s
        return repr((self.sched.snapshot(), self.cache.snapshot(),
                     self.batcher.snapshot(),
                     sorted((rid, s.snapshot())
                            for rid, s in seqs.items()))).encode()

    def check_blocks(self):
        held = set()
        for st in self.cache.slots:
            if st is not None:
                held.update(st.blocks)
        assert len(held) + self.cache.allocator.free_count \
            == self.total_blocks

    def submit(self):
        """Arrivals enter the scheduler only at commit or rollback
        boundaries, as ``serve_session`` drains them."""
        pl = self.rnd.randint(1, 20)
        mn = self.rnd.randint(1, 5)
        prompt = np.asarray([self.rnd.randrange(64) for _ in range(pl)],
                            np.int32)
        self.intake.append(Request(prompt=prompt, max_new_tokens=mn,
                                   budget=1.0))
        self.submitted += 1
        if self.pending is None:
            self.drain_intake()

    def drain_intake(self):
        for req in self.intake:
            seq = self.sched.submit(req)
            self.metrics.on_submit(seq.req_id)
            self.eng._seq_index[seq.req_id] = seq
            self.row = seq.row
            self.req_ids.append(seq.req_id)
        self.intake = []

    def dispatch(self):
        if self.pending is not None:
            return
        snap = self.eng._snapshot_row(self.sched, self.cache, self.batcher)
        before = self.canon()
        self.cache.allocator.begin_alloc_log()
        plog = _DeferredLog(self.eng, self.metrics, self.results)
        plan = self.eng._plan_iteration(self.row, self.sched, self.cache,
                                        self.batcher, self.metrics, plog)
        if not plan.empty:
            self.eng._advance_predicted(plan, self.cache, self.batcher,
                                        self.metrics)
        self.pending = (plan, snap, before)

    def commit(self):
        if self.pending is None:
            return
        plan, _, _ = self.pending
        self.cache.allocator.end_alloc_log()
        plan.sampled = np.arange(64, dtype=np.int64)   # stand-in tokens
        self.eng._commit_apply(plan, self.batcher)
        self.eng._cancel_cursor = max(self.eng._cancel_cursor,
                                      plan.cancel_cursor)
        plan.plog.flush()
        self.pending = None
        self.drain_intake()

    def rollback(self):
        if self.pending is None:
            return
        plan, snap, before = self.pending
        touched = self.cache.allocator.end_alloc_log()
        self.eng._restore_row(snap, self.sched, self.cache, self.batcher)
        assert self.canon() == before         # the restore is byte-exact
        for b in touched:
            self.cache._unregister_block(b)
        tset = set(touched)
        for slot, seq in enumerate(self.batcher.slots):
            if seq is not None and tset & set(self.cache.slots[slot].blocks):
                self.eng._evict(seq, self.sched, self.cache, self.batcher,
                                self.metrics, reason="rollback_recompute")
        # the commit replay is guarded: a patch lands only where its
        # placeholder survived the restore
        plan.sampled = np.arange(64, dtype=np.int64)
        self.eng._commit_apply(plan, self.batcher)
        self.pending = None
        self.rollbacks += 1
        self.drain_intake()

    def cancel(self):
        live = [r for r in self.req_ids
                if self.eng._seq_index[r].state != "finished"]
        if live:
            self.eng.cancel(self.rnd.choice(live))

    def step(self):
        op = self.rnd.choice(["submit", "dispatch", "dispatch", "commit",
                              "commit", "rollback", "cancel"])
        getattr(self, op)()
        self.check_blocks()

    def drain(self):
        """Plain dispatch and commit until everything finishes; the
        allocator is then whole again."""
        if self.pending is not None:
            self.commit()
        for _ in range(300):
            self.dispatch()
            empty = self.pending[0].empty
            self.commit()
            if empty and not self.sched.has_waiting():
                break
        else:
            pytest.fail("machine did not drain")
        assert self.batcher.num_active == 0
        assert self.cache.allocator.free_count == (self.total_blocks
                                                   - self.cache.cached_blocks)
        done = sum(1 for r in self.req_ids
                   if self.eng._seq_index[r].state == "finished")
        assert done == self.submitted


@pytest.mark.parametrize("seed", range(3))
def test_double_buffer_state_machine(states, seed):
    m = _RowMachine(states, seed)
    for _ in range(3):
        m.submit()
    for _ in range(60):
        m.step()
    m.drain()
    assert m.rollbacks > 0


# ------------------------------------------------------------- the card

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_speculative_iteration_on_card_is_sync_free(dev):
    """One speculative iteration, from ``_plan_iteration`` through
    ``_dispatch_mixed_async`` (feed fixups from the previous iteration's
    unread tokens included) and ``_advance_predicted``, queues everything
    without a host synchronisation; both iterations then commit."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serving_state
    from repro_torch.launch.train import dense_init
    cfg = get_config("gpt2-small", smoke=True)
    pf, table, infos = serving_state(cfg, dense_init(cfg, 0, dev), 0)
    eng = ElasticEngine(cfg, pf, table, infos, device=dev, max_batch=2,
                        max_len=64, block_size=BLOCK, prefill_chunk=8,
                        lookahead=True)
    metrics, results = ServingMetrics(), {}
    sched = Scheduler(eng.router)
    for rq in requests(cfg, [(7, 4, 1.0, False), (8, 4, 1.0, True)],
                       Request, SamplingParams):
        seq = sched.submit(rq)
        metrics.on_submit(seq.req_id)
        eng._seq_index[seq.req_id] = seq
    row = sched.next_row()
    cache = PagedKVCache(cfg, max_batch=2, max_len=64, block_size=BLOCK,
                         prefix_cache=False, device=dev)
    batcher = ContinuousBatcher(2)

    def iteration(pending):
        plan = eng._plan_iteration(row, sched, cache, batcher, metrics,
                                   _DeferredLog(eng, metrics, results))
        fixups = eng._feed_fixups(plan, pending) if pending else []
        eng._dispatch_mixed_async(params, cache, batcher, plan,
                                  pending and pending.tokens_dev, fixups)
        eng._advance_predicted(plan, cache, batcher, metrics)
        return plan, fixups

    with torch.no_grad():
        params = eng._realize(row)
        first, _ = iteration(None)              # kernels built here
        torch.cuda.set_sync_debug_mode("error")
        try:
            second, fixups = iteration(first)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        eng._commit_iteration(first, batcher, metrics)
        eng._commit_iteration(second, batcher, metrics)
    assert fixups, "the second iteration decodes on unread tokens"
    for plan in (first, second):
        assert plan.tokens_host.is_pinned()
        n = len(plan.sample_ids)
        assert ((plan.sampled[:n] >= 0)
                & (plan.sampled[:n] < cfg.vocab_size)).all()
