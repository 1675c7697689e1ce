"""The port's drain engine against the JAX package's, on the CPU.

``ElasticEngine.generate_drain`` (and ``generate`` with ``mode="auto"``
for the families the paged path does not cover) must emit the token
streams of the JAX engine's ``generate_drain`` on the same state bridged
into the port: greedy and device-sampled requests, mixed prompt lengths
(the padding contract: a shorter prompt's stream holds its padding),
more requests than ``max_batch``, ``max_new_tokens`` of 0, and the host
sampler. States are plain-SVD FlexRank states of seeded dense weights
(``decompose`` without moments; the drain path is what is held here, not
calibration), so every budget row is GAR-deployed on both sides.
"""
import functools

import numpy as np
import jax
import pytest
import torch

from repro.configs import get_config
from repro.core import flexrank as JFR
from repro.models import common as jcm
from repro.models import transformer as jtfm
from repro.serving import ElasticEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro_torch import bridge
from repro_torch.configs import get_config as tget
from repro_torch.serving import ElasticEngine, Request, SamplingParams

torch.set_num_threads(1)

ARCHS = ("gpt2-small", "rwkv6-3b", "zamba2-7b")


@functools.lru_cache(maxsize=None)
def _states(arch):
    """(JAX (cfg, factors, table, infos), the port's bridged copy)."""
    cfg = get_config(arch, smoke=True)
    dense = jcm.instantiate(jtfm.model_spec(cfg), jax.random.PRNGKey(0))
    fact, curves = JFR.decompose(dense, cfg, None)
    table, infos = JFR.build_table(cfg, curves)
    return (cfg, fact, table, infos), (
        tget(arch, smoke=True),
        bridge.params_to_torch(jax.tree.map(np.asarray, fact)),
        bridge.profile_table(table), bridge.group_infos(infos))


def _requests(cfg, spec, seed):
    """``spec``: (prompt length, max_new_tokens, budget, sampled) per
    request; sampled ones at temperature 0.8 and top-k 20, or 0 (no
    truncation) for every third."""
    rng = np.random.default_rng(seed)
    jreqs, treqs = [], []
    for i, (plen, new, budget, sampled) in enumerate(spec):
        prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        knobs = (dict(temperature=0.8, top_k=0 if i % 3 == 0 else 20,
                      seed=50 + i) if sampled else None)
        jreqs.append(JaxRequest(prompt=prompt, max_new_tokens=new,
                                budget=budget,
                                sampling=knobs and JaxSampling(**knobs)))
        treqs.append(Request(prompt=prompt, max_new_tokens=new,
                             budget=budget,
                             sampling=knobs and SamplingParams(**knobs)))
    return jreqs, treqs


def _serve_both(arch, spec, *, seed=0, max_batch=3, **kw):
    jstate, tstate = _states(arch)
    jreqs, treqs = _requests(jstate[0], spec, seed)
    jeng = JaxEngine(*jstate, max_batch=max_batch, max_len=32, **kw)
    teng = ElasticEngine(*tstate, max_batch=max_batch, max_len=32,
                         device="cpu", **kw)
    return jeng.generate_drain(jreqs), teng, teng.generate(treqs,
                                                           mode="drain")


def _assert_identical(ref, got, spec):
    assert len(ref) == len(got) == len(spec)
    for i, (a, b, (plen, new, _, _)) in enumerate(zip(ref, got, spec)):
        assert b.tokens.dtype == np.asarray(a.tokens).dtype, i
        np.testing.assert_array_equal(b.tokens, np.asarray(a.tokens),
                                      err_msg=f"request {i}")
        assert len(b.tokens) == plen + new, i
        assert (b.budget_row, b.deployed_params) == (a.budget_row,
                                                     a.deployed_params), i


# seven requests at two budgets with max_batch 3: row batches of 3 + 1 and
# 3; prompts of 5-16 tokens (rwkv6's chunk is 16: a padded prompt must not
# pass it unless it is a multiple), greedy and sampled mixed in a batch,
# and max_new_tokens that differ within a batch, 0 among them
MIXED = [(9, 5, 0.4, False), (16, 5, 1.0, True), (5, 3, 0.4, True),
         (12, 0, 1.0, False), (7, 5, 0.4, True), (14, 4, 1.0, False),
         (11, 5, 0.4, False)]


@pytest.mark.parametrize("arch", ARCHS)
def test_drain_streams_identical(arch):
    ref, eng, got = _serve_both(arch, MIXED)
    _assert_identical(ref, got, MIXED)
    # the padding contract: request 2 (5 tokens) is padded to its batch's
    # 9, so its stream carries four zeros after its prompt
    assert not got[2].tokens[5:9].any()
    s = eng.last_metrics.summary()
    assert s["requests"] == len(MIXED)
    assert s["generated_tokens"] == sum(new for _, new, _, _ in MIXED)


@pytest.mark.parametrize("arch", ["gpt2-small", "rwkv6-3b"])
def test_drain_host_sampling_identical(arch):
    spec = MIXED[:4]
    ref, _, got = _serve_both(arch, spec, seed=1, device_sampling=False)
    _assert_identical(ref, got, spec)


def test_drain_all_zero_new_tokens():
    spec = [(6, 0, 1.0, False), (10, 0, 1.0, True)]
    ref, _, got = _serve_both("rwkv6-3b", spec, seed=2)
    _assert_identical(ref, got, spec)


def test_auto_routes_recurrent_families_to_drain():
    """``auto`` serves rwkv6 through drain (the streams of
    ``generate_drain``); ``continuous`` there raises as in the reference,
    and on an attention stack ``auto`` stays continuous."""
    _, tstate = _states("rwkv6-3b")
    _, treqs = _requests(tstate[0], MIXED[:3], 3)
    eng = ElasticEngine(*tstate, max_batch=3, max_len=32, device="cpu")
    auto = eng.generate(treqs)
    drain = eng.generate_drain(treqs)
    for a, b in zip(auto, drain):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    with pytest.raises(ValueError, match="mode='drain' or 'auto'"):
        eng.generate(treqs, mode="continuous")
    with pytest.raises(ValueError, match="unknown mode"):
        eng.generate(treqs, mode="static")
    _, gstate = _states("gpt2-small")
    geng = ElasticEngine(*gstate, max_batch=3, max_len=32, device="cpu",
                         prefill_chunk=8)
    geng.generate(_requests(gstate[0], MIXED[:1], 3)[1])
    assert geng.last_metrics.summary()["mixed_iterations"] > 0


@pytest.mark.parametrize("argv,lens", [
    (["--arch", "rwkv6-3b"], [12] * 4),
    (["--arch", "zamba2-7b", "--prompt-len", "9"], [13] * 4),
    (["--engine", "drain", "--temperature", "0.8", "--top-k", "20"],
     [12] * 4)])
def test_launcher_serves_through_drain_on_cpu(argv, lens, capsys):
    from repro_torch.launch import serve
    res = serve.main(argv + ["--smoke", "--device", "cpu", "--requests",
                             "4", "--max-new", "4", "--budgets", "0.4,1.0"])
    assert [len(r.tokens) for r in res] == lens
    out = capsys.readouterr().out
    assert "# serving:" in out and "mixed iterations" not in out
    assert "# iteration split" not in out
