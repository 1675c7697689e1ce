"""The port's MLA attention against the JAX package's, on the CPU, at
minicpm3-4b's smoke config.

``effective_weight`` in its dense, GAR and rank-masked forms;
``mla_apply`` without a cache (exact query-chunked attention, global and
windowed, one chunk and several) and with one (the absorbed decode
against the latent cache); ``init_decode_state`` and the bridge's round
trip of an MLA cache; ``prefill`` + ``decode_step`` on dense and
GAR-deployed weights with float32 and bfloat16 caches; the port's decode
against its own forward; the drain engine's streams through
``generate(mode="auto")``; and the serving launcher on every new config.

Weights are numpy draws bridged into both packages. Tolerances, float32,
relative to the reference's max: one block 1e-5 (the same arithmetic),
logits 1e-4 (a whole model), the port's absorbed decode against its
forward 1e-4 (two orders of the same products), cache leaves 1e-5;
bfloat16 caches are held up to rounding ties
(``tests/test_torch_bf16_ties.py``).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config
from repro.core import flexrank as JFR
from repro.models import attention as jattn
from repro.models import common as jcm
from repro.models import mla as jmla
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_config as tget
from repro_torch.core import flexrank as TFR
from repro_torch.models import mla as tmla
from repro_torch.models import transformer as ttfm
from test_torch_bf16_ties import Bf16Writes, check_bf16_parity

torch.set_num_threads(1)

ARCH = "minicpm3-4b"
BATCH, PROMPT, STEPS, MAX_LEN = 2, 10, 3, 24
TOL_BLOCK = 1e-5
TOL_LOGITS = 1e-4


def _rel(a, b) -> float:
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-12)


@functools.lru_cache(maxsize=None)
def _state():
    """(cfg, port cfg, numpy dense params, JAX plain-SVD factors, table,
    infos); the norm scales (zeros in the spec) drawn small."""
    cfg = get_config(ARCH, smoke=True)
    rng = np.random.default_rng(5)

    def draw(spec):
        scale = 0.2 if spec.init == "zeros" else 1.0 / np.sqrt(
            spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1])
        return (scale * rng.standard_normal(spec.shape)).astype(np.float32)

    dense = jax.tree.map(draw, jtfm.model_spec(cfg), is_leaf=jcm.is_spec)
    fact, curves = JFR.decompose(jax.tree.map(jnp.asarray, dense), cfg, None)
    table, infos = JFR.build_table(cfg, curves)
    return cfg, tget(ARCH, smoke=True), dense, fact, table, infos


def _params(which):
    """Both packages' model params: dense, or budget row 0 GAR-deployed."""
    cfg, tcfg, dense, fact, table, infos = _state()
    if which == "dense":
        tree = dense
    else:
        tree = jax.tree.map(np.asarray,
                            JFR.gar_deploy(fact, cfg, infos, table, 0))
    return jax.tree.map(jnp.asarray, tree), bridge.params_to_torch(tree)


def _attn_params(form):
    """Layer 0's attention params in both packages, and its ranks at row 0
    for the factorized form."""
    cfg, _, dense, fact, table, infos = _state()
    r_j = r_t = None
    if form == "dense":
        tree = dense
    elif form == "factorized":
        tree = fact
        r_j = jax.tree.map(lambda a: a[0], JFR.ranks_tree(
            cfg, infos, JFR.table_device(table),
            jnp.asarray(0))["segments"][0]["attn"])
        r_t = jax.tree.map(int, r_j)
    else:
        tree = JFR.gar_deploy(fact, cfg, infos, table, 0)
    p = jax.tree.map(lambda a: np.asarray(a)[0], tree["segments"][0]["attn"])
    return jax.tree.map(jnp.asarray, p), bridge.params_to_torch(p), r_j, r_t


# ---------------------------------------------------------------- block

@pytest.mark.parametrize("form", ["dense", "factorized", "gar"])
def test_effective_weight_matches_jax(form):
    p_j, p_t, r_j, r_t = _attn_params(form)
    rank_j = None if r_j is None else r_j["kv_up"]
    rank_t = None if r_t is None else r_t["kv_up"]
    w_j = jmla._effective_weight(p_j["kv_up"], rank_j)
    w_t = tmla.effective_weight(p_t["kv_up"], rank_t)
    assert w_t.shape == w_j.shape
    assert _rel(w_t, w_j) < TOL_BLOCK


@pytest.mark.parametrize("q_chunk", [1024, 4])
@pytest.mark.parametrize("window", [1 << 30, 5])
@pytest.mark.parametrize("form", ["dense", "factorized", "gar"])
def test_mla_apply_matches_jax(form, window, q_chunk, monkeypatch):
    """No cache: 12 tokens in one query chunk, or in three of 4 (the
    reference's ``lax.scan`` over chunks against the port's loop)."""
    monkeypatch.setattr(jattn, "Q_CHUNK", q_chunk)
    monkeypatch.setattr(tmla, "Q_CHUNK", q_chunk)
    cfg, tcfg = _state()[:2]
    p_j, p_t, r_j, r_t = _attn_params(form)
    x = np.random.default_rng(2).standard_normal(
        (BATCH, 12, cfg.d_model)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)
    y_j, c_j = jmla.mla_apply(p_j, jnp.asarray(x), cfg,
                              positions=jnp.asarray(pos), window=window,
                              ranks=r_j)
    with torch.no_grad():
        y_t, c_t = tmla.mla_apply(p_t, torch.as_tensor(x), tcfg,
                                  positions=torch.as_tensor(pos),
                                  window=window, ranks=r_t)
    assert c_j is None and c_t is None
    assert _rel(y_t, y_j) < TOL_BLOCK


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["dense", "factorized", "gar"])
def test_mla_apply_absorbed_decode_matches_jax(form, dtype):
    """With a latent cache: a 7-token prefill at idx 0, then one token at
    idx 7; outputs, cache rows and idx against the reference's. float32
    within 1e-5; a bfloat16 cache is held up to rounding ties
    (``tests/test_torch_bf16_ties.py``): outputs at 1e-5 before the first
    differing cache element, which is a one-ulp tie, the rest within
    bfloat16's 2u."""
    cfg, tcfg = _state()[:2]
    p_j, p_t, r_j, r_t = _attn_params(form)
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((BATCH, s, cfg.d_model)).astype(np.float32)
          for s in (7, 1)]
    c_j = jax.tree.map(lambda a: a[0], jmla.init_mla_cache(
        cfg, BATCH, 16, dtype=getattr(jnp, dtype)))
    c_t = tmla.init_mla_cache(tcfg, BATCH, 16, dtype=getattr(torch, dtype))
    c_t = {k: (v[0] if k != "idx" else v) for k, v in c_t.items()}
    writes = Bf16Writes(c_t["c_kv"], c_t["k_rope"])
    start = 0
    ys_t, ys_j = [], []
    for x in xs:
        pos = np.arange(start, start + x.shape[1], dtype=np.int32)
        y_j, c_j = jmla.mla_apply(p_j, jnp.asarray(x), cfg,
                                  positions=jnp.asarray(pos),
                                  window=1 << 30, ranks=r_j, cache=c_j)
        with torch.no_grad(), writes:
            y_t, c_t = tmla.mla_apply(p_t, torch.as_tensor(x), tcfg,
                                      positions=torch.as_tensor(pos),
                                      window=1 << 30, ranks=r_t, cache=c_t)
        start += x.shape[1]
        assert y_t.dtype == torch.float32
        assert c_t["idx"] == int(c_j["idx"]) == start
        for k in ("c_kv", "k_rope"):
            assert str(c_t[k].dtype) == f"torch.{dtype}"
        if dtype == "float32":
            assert _rel(y_t, y_j) < TOL_BLOCK
            for k in ("c_kv", "k_rope"):
                assert _rel(c_t[k], c_j[k]) < TOL_BLOCK
        ys_t.append(y_t)
        ys_j.append(np.asarray(y_j))
    if dtype == "bfloat16":
        keys = ("c_kv", "k_rope")
        check_bf16_parity(
            torch.cat(ys_t, 1), np.concatenate(ys_j, 1),
            [{k: c_t[k] for k in keys}], [{k: np.asarray(c_j[k])
                                           for k in keys}],
            [{k: writes.shadow(c_t[k]) for k in keys}], tol=TOL_BLOCK)


def test_mla_cache_overflow_raises():
    _, tcfg = _state()[:2]
    _, p_t, _, _ = _attn_params("dense")
    cache = {k: (v[0] if k != "idx" else v) for k, v in tmla.init_mla_cache(
        tcfg, 1, 4, dtype=torch.float32).items()}
    with pytest.raises(ValueError, match="cannot take"):
        tmla.mla_apply(p_t, torch.zeros(1, 5, tcfg.d_model), tcfg,
                       positions=torch.arange(5), window=1 << 30,
                       cache=cache)


# ------------------------------------------------------- decode states

def test_init_decode_state_and_bridge_round_trip():
    """The MLA cache's leaves have the reference's paths, shapes and
    dtypes (bfloat16 by default); a state of random leaves goes through
    ``decode_state_to_torch`` and back exactly, ``idx`` sized by
    ``c_kv``."""
    cfg, tcfg = _state()[:2]
    st_j = jtfm.init_decode_state(cfg, BATCH, MAX_LEN)
    st_t = ttfm.init_decode_state(tcfg, BATCH, MAX_LEN)
    assert set(st_t["segments"][0]) == {"c_kv", "k_rope", "idx"}
    leaves_j = jax.tree_util.tree_flatten_with_path(st_j)[0]
    leaves_t = jax.tree_util.tree_flatten_with_path(
        bridge.decode_state_to_numpy(st_t))[0]
    assert [p for p, _ in leaves_t] == [p for p, _ in leaves_j]
    for (_, a_t), (_, a_j) in zip(leaves_t, leaves_j):
        assert a_t.shape == a_j.shape
    assert st_t["segments"][0]["c_kv"].dtype == torch.bfloat16
    st32 = jtfm.init_decode_state(cfg, BATCH, MAX_LEN, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    st_np = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.asarray(a).dtype) if a.ndim > 1 else np.full(a.shape, 7, a.dtype),
        st32)
    back = bridge.decode_state_to_numpy(bridge.decode_state_to_torch(st_np))
    assert back["segments"][0]["idx"].shape == (cfg.segments[0].count,)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(st_np)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _tokens(cfg):
    return np.random.default_rng(9).integers(
        0, cfg.vocab_size, (BATCH, PROMPT + STEPS)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["dense", "gar"])
def test_prefill_decode_matches_jax(which, dtype):
    """A prefill of 10 tokens, then three single steps (the absorbed
    decode), on both sides: float32 logits within 1e-4 at every call, the
    cache leaves within 1e-5 after the last; bfloat16 caches held up to
    rounding ties (``tests/test_torch_bf16_ties.py``: logits at 1e-4
    before the first differing cache element, a one-ulp tie there, the
    rest within bfloat16's 2u); positions advanced alike."""
    cfg, tcfg = _state()[:2]
    p_j, p_t = _params(which)
    toks = _tokens(cfg)
    st_j = jtfm.init_decode_state(cfg, BATCH, MAX_LEN,
                                  dtype=getattr(jnp, dtype))
    st_t = ttfm.init_decode_state(tcfg, BATCH, MAX_LEN,
                                  dtype=getattr(torch, dtype))
    keys = ("c_kv", "k_rope")
    writes = Bf16Writes(*[c[k] for c in st_t["segments"] for k in keys])
    step_j = jax.jit(lambda p, st, tok: jtfm.decode_step(p, cfg, st, tok))
    feeds = [toks[:, :PROMPT]] + [toks[:, PROMPT + i:PROMPT + i + 1]
                                  for i in range(STEPS)]
    outs_t, outs_j = [], []
    with torch.no_grad(), writes:
        for i, feed in enumerate(feeds):
            l_j, st_j = step_j(p_j, st_j, jnp.asarray(feed))
            fn = ttfm.prefill if i == 0 else ttfm.decode_step
            l_t, st_t = fn(p_t, tcfg, st_t, torch.as_tensor(feed))
            if dtype == "float32":
                assert _rel(l_t, l_j) < TOL_LOGITS, i
            outs_t.append(l_t)
            outs_j.append(np.asarray(l_j))
    assert st_t["pos"] == int(st_j["pos"]) == PROMPT + STEPS
    back = bridge.decode_state_to_numpy(st_t)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(st_j)):
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, np.asarray(b))
        elif dtype == "float32":
            assert _rel(a, b) < TOL_BLOCK
    if dtype == "bfloat16":
        def layers(segs, get):
            return [{k: get(c[k])[l] for k in keys}
                    for c in segs for l in range(c["c_kv"].shape[0])]
        check_bf16_parity(
            torch.cat(outs_t, 1), np.concatenate(outs_j, 1),
            layers(st_t["segments"], lambda a: a),
            layers(st_j["segments"], np.asarray),
            layers(st_t["segments"], writes.shadow), tol=TOL_LOGITS)


def test_decode_matches_forward():
    """The port's own parity: the absorbed decode from the latent cache
    gives the logits of the exact forward over the whole sequence."""
    cfg, tcfg = _state()[:2]
    _, p_t = _params("gar")
    toks = torch.as_tensor(_tokens(cfg))
    with torch.no_grad():
        full, aux = ttfm.forward(p_t, tcfg, toks)
        st = ttfm.init_decode_state(tcfg, BATCH, MAX_LEN,
                                    dtype=torch.float32)
        logits, st = ttfm.prefill(p_t, tcfg, st, toks[:, :PROMPT])
        outs = [logits]
        for i in range(STEPS):
            logits, st = ttfm.decode_step(p_t, tcfg, st,
                                          toks[:, PROMPT + i:PROMPT + i + 1])
            outs.append(logits)
    assert float(aux) == 0.0
    assert _rel(torch.cat(outs, dim=1), full.numpy()) < TOL_LOGITS


# --------------------------------------------------------------- engine

def test_drain_streams_identical():
    """``generate(mode="auto")`` routes MLA to drain on both engines:
    greedy and sampled requests, prompts of mixed lengths (the padding
    contract), more requests than ``max_batch``."""
    from repro.serving import ElasticEngine as JaxEngine
    from repro.serving import Request as JaxRequest
    from repro.serving import SamplingParams as JaxSampling
    from repro_torch.serving import ElasticEngine, Request, SamplingParams
    cfg, tcfg, _, fact, table, infos = _state()
    assert not ttfm.paged_compatible(tcfg)
    spec = [(9, 5, 0.4, False), (12, 5, 1.0, True), (5, 3, 0.4, True),
            (7, 4, 1.0, False), (11, 5, 0.4, False)]
    rng = np.random.default_rng(0)
    jreqs, treqs = [], []
    for i, (plen, new, budget, sampled) in enumerate(spec):
        prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        knobs = (dict(temperature=0.8, top_k=20, seed=50 + i)
                 if sampled else None)
        jreqs.append(JaxRequest(prompt=prompt, max_new_tokens=new,
                                budget=budget,
                                sampling=knobs and JaxSampling(**knobs)))
        treqs.append(Request(prompt=prompt, max_new_tokens=new,
                             budget=budget,
                             sampling=knobs and SamplingParams(**knobs)))
    jeng = JaxEngine(cfg, fact, table, infos, max_batch=2, max_len=32)
    teng = ElasticEngine(tcfg, bridge.params_to_torch(
        jax.tree.map(np.asarray, fact)), bridge.profile_table(table),
        bridge.group_infos(infos), max_batch=2, max_len=32, device="cpu")
    ref = jeng.generate(jreqs, mode="auto")
    got = teng.generate(treqs, mode="auto")
    for i, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(b.tokens, np.asarray(a.tokens),
                                      err_msg=f"request {i}")
        assert b.budget_row == a.budget_row
    s = teng.last_metrics.summary()
    assert s["decode_steps"] > 0 and not s["mixed_iterations"]


@pytest.mark.parametrize("arch,engine", [
    ("deepseek-moe-16b", "continuous"), ("llama4-scout-17b-a16e",
                                         "continuous"),
    ("minicpm3-4b", "drain"), ("deepseek-7b", "continuous"),
    ("stablelm-1.6b", "continuous")])
def test_launcher_serves_new_configs_on_cpu(arch, engine, capsys):
    """``auto`` picks continuous batching for the attention stacks (MoE
    included) and drain for MLA."""
    from repro_torch.launch import serve
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--requests", "3", "--max-new", "3", "--budgets",
                      "0.4,1.0", "--prefill-chunk", "8"])
    assert [len(r.tokens) for r in res] == [11] * 3
    out = capsys.readouterr().out
    assert "# serving:" in out
    if engine == "continuous":
        assert "# iteration split" in out
    else:
        assert "# iteration split" not in out
