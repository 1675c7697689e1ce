"""The port's pure-decode path against the JAX package's, on the CPU.

``ops.paged_attention_forward`` against the JAX oracle and the Pallas
decode kernel in interpret mode; ``paged_attn_apply`` on dense,
factorized and GAR parameters; ``paged_decode_step`` over several steps on
the gpt2 and gemma3 smoke fixtures (gemma3: grouped KV heads and a
16-token window that the positions cross), and against the port's own
``paged_mixed_step`` with one token a slot; the gemma3 smoke engine's
token streams against the JAX engine's with prompts longer than the
window.

Tolerances: attention outputs 2e-5 absolute (two softmax implementations
summing in other orders); a layer or a step 2e-5 of the output's max
(float32 products of two libraries through the layers); pools 1e-5
absolute (one projection each); decode vs mixed in the port 1e-6 of the
logits' max (the same plain versions on rows laid out differently);
greedy tokens and engine streams identical.
"""
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config
from repro.core import flexrank as JFR
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import common as jcm
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_config as tget
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm

torch.set_num_threads(1)


def _state(arch):
    """The JAX suite's smoke recipe (tests/test_chunked_prefill.py): a
    seeded dense init, calibration, DataSVD and DP; and the port's config."""
    from repro.data import make_source
    from repro.launch.train import build_flexrank_state
    cfg = get_config(arch, smoke=True)
    source = make_source(cfg.vocab_size, 64, 4, seed=0)
    dense = jcm.instantiate(jtfm.model_spec(cfg), jax.random.PRNGKey(0))
    params_fact, table, infos = build_flexrank_state(cfg, dense, source)
    return cfg, dense, params_fact, table, infos, tget(arch, smoke=True)


@pytest.fixture(scope="module")
def gemma():
    return _state("gemma3-27b")


@pytest.fixture(scope="module")
def gpt2():
    return _state("gpt2-small")


# -------------------------------------------------- decode attention op

def _decode_operands(rng, hq, hkv, d, bs, mb, lens):
    """Pools with a null block 0, one table row a slot; a slot whose
    context is 1 reads the null row (an idle slot at position 0)."""
    b = len(lens)
    nb = b * mb + 1
    kp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    tables = (1 + rng.permutation(b * mb).reshape(b, mb)).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    tables[lens == 1] = 0
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    return q, kp, vp, tables, lens


# (Hq, Hkv, D, BS, MB, contexts): a context that fills its last block
# exactly, one that ends mid-block, an idle slot (context 1, null row)
DECODE_GEOMS = [(4, 4, 16, 4, 5, [20, 9, 1]),
                (8, 2, 32, 8, 4, [32, 17, 1, 8]),
                (12, 4, 40, 7, 3, [21, 5, 1]),
                (6, 3, 24, 5, 6, [30, 13, 26])]


@pytest.mark.parametrize("geom", range(len(DECODE_GEOMS)))
@pytest.mark.parametrize("window", [None, 8, 11])
def test_paged_attention_forward_matches_jax(geom, window):
    """Windows 8 and 11 start at and between block boundaries; both JAX
    paths (its oracle, and the Pallas kernel in interpret mode where it
    takes no window), softcap off and on: 2e-5 absolute."""
    hq, hkv, d, bs, mb, lens = DECODE_GEOMS[geom]
    args = _decode_operands(np.random.default_rng(geom), hq, hkv, d, bs, mb,
                            lens)
    for softcap in (0.0, 20.0):
        y_t = ops.paged_attention_forward(*map(torch.as_tensor, args),
                                          softcap=softcap,
                                          window=window).numpy()
        assert np.isfinite(y_t).all()
        for use_pallas in (False, "interpret"):
            y_j = np.asarray(jops.paged_attention_forward(
                *map(jnp.asarray, args), softcap=softcap, window=window,
                use_pallas=use_pallas))
            assert float(np.abs(y_t - y_j).max()) < 2e-5, (softcap,
                                                            use_pallas)


def test_paged_attention_window_reduces_to_the_visible_keys():
    """A window drops exactly the keys older than ``ctx - window``:
    scribbling on them changes nothing, scribbling inside changes the
    output."""
    rng = np.random.default_rng(5)
    q, kp, vp, tables, lens = _decode_operands(rng, 4, 2, 16, 4, 6, [22])
    t = [torch.as_tensor(a) for a in (q, kp, vp, tables, lens)]
    y = ops.paged_attention_forward(*t, window=10)
    old = torch.as_tensor(tables[0, :3]).long()     # keys 0..11; 12 is first
    k2, v2 = t[1].clone(), t[2].clone()
    k2[old] = 50.0
    v2[old] = -50.0
    y_old = ops.paged_attention_forward(t[0], k2, v2, *t[3:], window=10)
    np.testing.assert_array_equal(y.numpy(), y_old.numpy())
    k2[int(tables[0, 3]), 0] = 50.0                 # key 12, visible
    y_in = ops.paged_attention_forward(t[0], k2, v2, *t[3:], window=10)
    assert float((y_in - y).abs().max()) > 1e-3


# ---------------------------------------------------- paged_attn_apply

def _attn_params(state, form):
    """Layer 0's attention parameters of the smoke state: dense, the
    factorized leaves with row 0's ranks, or GAR-deployed at row 0."""
    cfg, dense, params_fact, table, infos, _ = state
    layer = lambda tree: jax.tree.map(lambda a: a[0], tree["segments"][0])
    if form == "dense":
        return layer(dense)["attn"], None
    if form == "gar":
        return layer(JFR.gar_deploy(params_fact, cfg, infos, table,
                                    0))["attn"], None
    ranks = JFR.ranks_tree(cfg, infos, JFR.table_device(table),
                           jnp.asarray(0))["segments"][0]["attn"]
    return layer(params_fact)["attn"], {k: v[0] for k, v in ranks.items()}


@pytest.mark.parametrize("form", ["dense", "factorized", "gar"])
@pytest.mark.parametrize("window", [None, 16])
def test_paged_attn_apply_matches_jax(gemma, form, window):
    cfg, tcfg = gemma[0], gemma[5]
    p_j, ranks_j = _attn_params(gemma, form)
    p_t = bridge.params_to_torch(jax.tree.map(np.asarray, p_j))
    ranks_t = (None if ranks_j is None
               else {k: int(v) for k, v in ranks_j.items()})
    rng = np.random.default_rng(3)
    bs, mb = 4, 8
    hd = cfg.resolved_head_dim
    kp = rng.standard_normal((13, bs, cfg.num_kv_heads, hd)).astype(np.float32)
    vp = rng.standard_normal((13, bs, cfg.num_kv_heads, hd)).astype(np.float32)
    tables = np.asarray([[1, 2, 3, 4, 5, 6, 0, 0], [7, 8, 9, 10, 11, 12, 0, 0],
                         [0] * 8], np.int32)
    positions = np.asarray([22, 7, 0], np.int32)     # the last slot idle
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    y_j, kp_j, vp_j = jattn.paged_attn_apply(
        p_j, jnp.asarray(x), cfg, positions=jnp.asarray(positions),
        block_tables=jnp.asarray(tables), k_pool=jnp.asarray(kp),
        v_pool=jnp.asarray(vp), window=window, ranks=ranks_j)
    kp_t, vp_t = torch.as_tensor(kp.copy()), torch.as_tensor(vp.copy())
    y_t, kp_t2, vp_t2 = tattn.paged_attn_apply(
        p_t, torch.as_tensor(x), tcfg, positions=torch.as_tensor(positions),
        block_tables=torch.as_tensor(tables), k_pool=kp_t, v_pool=vp_t,
        window=window, ranks=ranks_t)
    assert kp_t2 is kp_t and vp_t2 is vp_t                 # in place
    y_j = np.asarray(y_j)
    assert float(np.abs(y_t.numpy() - y_j).max()) < 2e-5 * (
        float(np.abs(y_j).max()) + 1e-6)
    for a, b in ((kp_t, kp_j), (vp_t, vp_j)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) < 1e-5
    assert not np.array_equal(kp_t.numpy(), kp)


# --------------------------------------------------- paged_decode_step

def _decode_caches(cfg, rng):
    """Four slots of a 4-token-block cache: three live sequences at
    positions 3, 13 and 14 over pools holding a random prefix, and one
    idle slot at position 0 on the null row."""
    bs, mb = 4, 8
    hd = cfg.resolved_head_dim
    nb = 3 * mb + 1
    pools = [{k: rng.standard_normal((s.count, nb, bs, cfg.num_kv_heads, hd)
                                     ).astype(np.float32) for k in "kv"}
             for s in cfg.segments]
    tables = np.zeros((4, mb), np.int32)
    tables[:3] = 1 + rng.permutation(3 * mb).reshape(3, mb)
    positions = np.asarray([3, 13, 14, 0], np.int32)
    return pools, tables, positions


def _decode_run(state, row, steps):
    """``steps`` decode steps on both sides from the same caches, each side
    feeding back its own greedy tokens. Returns per-step logits, tokens
    and the final pools of both sides."""
    cfg, _, params_fact, table, infos, tcfg = state
    row = row % table.table.shape[0]
    jparams = JFR.gar_deploy(params_fact, cfg, infos, table, row)
    tparams = bridge.params_to_torch(jparams)
    rng = np.random.default_rng(row + 11)
    pools, tables, positions = _decode_caches(cfg, rng)
    tok = rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32)
    jc = {"positions": jnp.asarray(positions),
          "block_tables": jnp.asarray(tables),
          "segments": [{k: jnp.asarray(a) for k, a in p.items()}
                       for p in pools]}
    tc = {"positions": torch.as_tensor(positions),
          "block_tables": torch.as_tensor(tables),
          "segments": [{k: torch.as_tensor(a.copy()) for k, a in p.items()}
                       for p in pools]}
    tok_j, tok_t = jnp.asarray(tok), torch.as_tensor(tok)
    step_j = jax.jit(lambda p, c, t: jtfm.paged_decode_step(p, cfg, c, t))
    out = []
    for _ in range(steps):
        lj, jc = step_j(jparams, jc, tok_j)
        lt, tc = ttfm.paged_decode_step(tparams, tcfg, tc, tok_t)
        # the idle slot stays at position 0, as device_positions keeps it
        jc["positions"] = jc["positions"].at[3].set(0)
        tc["positions"][3] = 0
        tok_j = jnp.argmax(lj[:, -1], axis=-1).astype(jnp.int32)[:, None]
        tok_t = torch.argmax(lt[:, -1], dim=-1).to(torch.int32)[:, None]
        out.append((np.asarray(lj), lt.numpy(), np.asarray(tok_j),
                    tok_t.numpy()))
    return out, jc, tc


@pytest.mark.parametrize("arch", ["gpt2", "gemma"])
@pytest.mark.parametrize("row", [0, -1])
def test_paged_decode_step_matches_jax(request, arch, row):
    """Six steps: gemma3-smoke's slots at positions 13 and 14 cross its
    16-token window on the local layers."""
    state = request.getfixturevalue(arch)
    cfg = state[0]
    out, jc, tc = _decode_run(state, row, 6)
    for lj, lt, tj, tt in out:
        assert lt.shape == lj.shape == (4, 1, cfg.vocab_size)
        assert np.isfinite(lt).all()
        assert float(np.abs(lt - lj).max()) < 2e-5 * float(np.abs(lj).max())
        np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(tc["positions"].numpy(),
                                  np.asarray(jc["positions"]))
    for pj, pt in zip(jc["segments"], tc["segments"]):
        for k in "kv":
            assert float(np.abs(pt[k].numpy() - np.asarray(pj[k])).max()) \
                < 1e-5


@pytest.mark.parametrize("arch", ["gpt2", "gemma"])
def test_paged_decode_step_equals_mixed_step(request, arch):
    """The port's decode step against its mixed step with one token a slot
    (slot_ids = arange), over four steps at the top row: logits within
    1e-6 of their max, pools equal."""
    cfg, _, params_fact, table, infos, tcfg = request.getfixturevalue(arch)
    from repro_torch.core import flexrank as TFR
    params = TFR.gar_deploy(bridge.params_to_torch(params_fact), tcfg,
                            bridge.group_infos(infos),
                            bridge.profile_table(table),
                            table.table.shape[0] - 1)
    rng = np.random.default_rng(2)
    pools, tables, positions = _decode_caches(cfg, rng)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 1))
                          .astype(np.int32))
    dec = {"positions": torch.as_tensor(positions),
           "block_tables": torch.as_tensor(tables),
           "segments": [{k: torch.as_tensor(a.copy()) for k, a in p.items()}
                        for p in pools]}
    mix_segments = [{k: torch.as_tensor(a.copy()) for k, a in p.items()}
                    for p in pools]
    for _ in range(4):
        mix = {"slot_ids": torch.arange(4, dtype=torch.int32),
               "positions": dec["positions"].clone(),
               "block_tables": dec["block_tables"],
               "segments": mix_segments}
        with torch.no_grad():
            l_mix, mix = ttfm.paged_mixed_step(params, tcfg, mix,
                                               tok.reshape(1, 4))
            l_dec, dec = ttfm.paged_decode_step(params, tcfg, dec, tok)
        l_mix = l_mix.reshape(4, 1, -1)
        assert float((l_dec - l_mix).abs().max()) <= 1e-6 * float(
            l_mix.abs().max())
        tok = torch.argmax(l_dec[:, -1], dim=-1).to(torch.int32)[:, None]
        assert torch.equal(tok, torch.argmax(l_mix[:, -1], dim=-1).to(
            torch.int32)[:, None])
    for pd, pm in zip(dec["segments"], mix_segments):
        for k in "kv":
            assert float((pd[k] - pm[k]).abs().max()) <= 1e-6


# ------------------------------------------------------------- engine

def test_gemma_engine_token_streams_identical(gemma):
    """gemma3-smoke served by both engines: prompts of 18-30 tokens past
    the 16-token window, 8-token prefill chunks, device sampling, greedy
    and temperature/top-k requests at two budgets."""
    from repro.serving import ElasticEngine as JaxEngine
    from repro.serving import Request as JaxRequest
    from repro.serving import SamplingParams as JaxSampling
    from repro_torch.serving import ElasticEngine, Request, SamplingParams
    cfg, _, params_fact, table, infos, tcfg = gemma
    spec = [(22, 6, 1.0), (30, 5, 0.4), (18, 6, 1.0), (25, 4, 0.4)]

    def requests(req_cls, samp_cls):
        rng = np.random.default_rng(7)
        return [req_cls(prompt=rng.integers(0, cfg.vocab_size, pl)
                        .astype(np.int32), max_new_tokens=mn, budget=b,
                        sampling=(samp_cls(temperature=0.8, top_k=40,
                                           seed=3 + i) if i % 2 else None))
                for i, (pl, mn, b) in enumerate(spec)]

    kw = dict(max_batch=2, max_len=64, block_size=8, prefill_chunk=8)
    jeng = JaxEngine(cfg, params_fact, table, infos, lookahead=False, **kw)
    teng = ElasticEngine(tcfg, bridge.params_to_torch(params_fact),
                         bridge.profile_table(table),
                         bridge.group_infos(infos), device="cpu", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jres = jeng.generate(requests(JaxRequest, JaxSampling),
                             mode="continuous")
        tres = teng.generate(requests(Request, SamplingParams),
                             mode="continuous")
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert t.budget_row == j.budget_row
    assert teng.last_metrics.summary()["mixed_iterations"] == \
        jeng.last_metrics.summary()["mixed_iterations"]
