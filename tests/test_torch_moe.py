"""The port's MoE FFN and the five configs it brings in, against the JAX
package, on the CPU.

``moe_apply`` on deepseek-moe and llama4-scout smoke weights in the dense,
factorized (rank-masked) and GAR forms, once at the config's capacity
with enough tokens to drop pairs (some pair must drop) and once with no
drops (``capacity_factor = num_experts``, the reference's own no-drop
device, ``tests/test_models.py``): output, aux and the kept set; ``top_k``
ties; ``forward`` logits and aux of all five new configs (deepseek-moe,
llama4-scout, minicpm3, deepseek-7b, stablelm); the paged mixed and
decode steps of deepseek-moe over a flat batch whose capacity drops; the
engine's token streams; the FlexRank state (moments, curves, table, GAR
leaves with (layers, experts) lead dims) and the whitening that one
layer's experts share.

Weights are numpy draws bridged into both packages. Tolerances, float32
throughout, relative to the reference's max: ``moe_apply`` 1e-5 (the same
arithmetic; einsums in other summation orders), logits 1e-4 (a whole
model, as in ``tests/test_torch_train.py``), moments and curves 1e-4;
with bfloat16 K/V caches the decode is held up to rounding ties
(``tests/test_torch_bf16_ties.py``).
"""
import dataclasses
import functools
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import data as jdata
from repro.configs import get_config
from repro.core import flexrank as JFR
from repro.models import common as jcm
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch import data as tdata
from repro_torch.configs import get_config as tget
from repro_torch.core import datasvd, flexrank as TFR
from repro_torch.core.covariance import sqrt_and_inv_sqrt
from repro_torch.models import common as tcm
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from test_torch_bf16_ties import Bf16Writes, check_bf16_parity

torch.set_num_threads(1)

MOE_ARCHS = ("deepseek-moe-16b", "llama4-scout-17b-a16e")
NEW_ARCHS = MOE_ARCHS + ("minicpm3-4b", "deepseek-7b", "stablelm-1.6b")
TOL_MOE = 1e-5
TOL_LOGITS = 1e-4


def _rel(a, b) -> float:
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-12)


def _no_drop(cfg):
    """The config with ``capacity_factor = num_experts``: every pair fits."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


@functools.lru_cache(maxsize=None)
def _state(arch):
    """(cfg, port cfg, numpy dense params, JAX factors from a plain-SVD
    ``decompose``, table, infos)."""
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(len(arch))

    def draw(spec):
        scale = 0.2 if spec.init == "zeros" else 1.0 / np.sqrt(
            spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1])
        return (scale * rng.standard_normal(spec.shape)).astype(np.float32)

    dense = jax.tree.map(draw, jtfm.model_spec(cfg), is_leaf=jcm.is_spec)
    fact, curves = JFR.decompose(jax.tree.map(jnp.asarray, dense), cfg, None)
    table, infos = JFR.build_table(cfg, curves)
    return cfg, tget(arch, smoke=True), dense, fact, table, infos


def _moe_seg(cfg) -> int:
    return next(i for i, s in enumerate(cfg.segments) if s.kind == "attn")


def _moe_params(arch, form):
    """The first MoE layer's ``mlp`` params in both packages, and the ranks
    of budget row 0 for the factorized form (None otherwise)."""
    cfg, _, dense, fact, table, infos = _state(arch)
    i = _moe_seg(cfg)
    ranks_j = ranks_t = None
    if form == "dense":
        tree = dense
    elif form == "factorized":
        tree = fact
        rj = JFR.ranks_tree(cfg, infos, JFR.table_device(table),
                            jnp.asarray(0))["segments"][i]["mlp"]
        ranks_j = jax.tree.map(lambda a: a[0], rj)   # layer 0's
        ranks_t = jax.tree.map(int, ranks_j)
    else:
        tree = JFR.gar_deploy(fact, cfg, infos, table, 0)
    mlp = jax.tree.map(lambda a: np.asarray(a)[0], tree["segments"][i]["mlp"])
    return (jax.tree.map(jnp.asarray, mlp), bridge.params_to_torch(mlp),
            ranks_j, ranks_t)


def _jax_kept(p_j, x, cfg):
    """The reference's kept set, from its own arithmetic
    (``repro/models/moe.py:moe_apply``'s routing and slot lines)."""
    m = cfg.moe
    b, s, _ = x.shape
    probs = jax.nn.softmax(jcm.linear(p_j["router"], x.astype(jnp.float32)),
                           axis=-1)
    _, top_e = jax.lax.top_k(probs, m.top_k)
    cap = max(int(np.ceil(s * m.top_k * m.capacity_factor / m.num_experts)),
              4)
    flat_e = top_e.reshape(b, s * m.top_k)
    onehot = jax.nn.one_hot(flat_e, m.num_experts, dtype=jnp.int32)
    slot = jnp.sum(jnp.cumsum(onehot, axis=1) * onehot, axis=-1) - 1
    return np.asarray(top_e), np.asarray(slot < cap)


def _port_kept(p_t, x, cfg):
    m = cfg.moe
    probs = torch.softmax(tcm.linear(p_t["router"], x.float()), dim=-1)
    _, top_e = tmoe.route(probs, m.top_k)
    _, keep = tmoe.assign_slots(top_e, m.num_experts,
                                tmoe.capacity(cfg, x.shape[1]))
    return top_e.numpy(), keep.numpy()


# ------------------------------------------------------------ moe_apply

@pytest.mark.parametrize("drops", [True, False])
@pytest.mark.parametrize("form", ["dense", "factorized", "gar"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_jax(arch, form, drops):
    """Two rows of 48 tokens: at the config's capacity (deepseek 8 experts
    top-2: 15 slots for a mean load of 12; llama4 4 experts top-1: 15 for
    12) some pairs drop; at ``capacity_factor = num_experts`` none does."""
    cfg, tcfg = _state(arch)[:2]
    if not drops:
        cfg, tcfg = _no_drop(cfg), _no_drop(tcfg)
    p_j, p_t, r_j, r_t = _moe_params(arch, form)
    x = np.random.default_rng(7).standard_normal(
        (2, 48, cfg.d_model)).astype(np.float32)
    y_j, aux_j = jmoe.moe_apply(p_j, jnp.asarray(x), cfg, ranks=r_j)
    with torch.no_grad():
        y_t, aux_t = tmoe.moe_apply(p_t, torch.as_tensor(x), tcfg, ranks=r_t)
    assert y_t.shape == y_j.shape and y_t.dtype == torch.float32
    assert _rel(y_t, y_j) < TOL_MOE
    assert abs(float(aux_t) - float(aux_j)) <= TOL_MOE * abs(float(aux_j))
    e_j, keep_j = _jax_kept(p_j, jnp.asarray(x), cfg)
    e_t, keep_t = _port_kept(p_t, torch.as_tensor(x), tcfg)
    np.testing.assert_array_equal(e_t, e_j)
    np.testing.assert_array_equal(keep_t, keep_j)
    assert (not keep_j.all()) == drops


@pytest.mark.parametrize("k", [1, 2, 3])
def test_route_ties_match_jax_top_k(k):
    """Equal probabilities: the lower expert index first, as
    ``jax.lax.top_k`` orders them."""
    probs = np.asarray([[0.1, 0.3, 0.3, 0.1, 0.2],
                        [0.2, 0.2, 0.2, 0.2, 0.2],
                        [0.0, 0.25, 0.0, 0.25, 0.5],
                        [0.4, 0.1, 0.4, 0.05, 0.05]], np.float32)
    vj, ij = jax.lax.top_k(jnp.asarray(probs), k)
    vt, it = tmoe.route(torch.as_tensor(probs), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_tied_router_matches_jax(arch):
    """A zero router: every expert ties on every token, so top-k takes the
    first k experts and the capacity drops the later tokens' pairs."""
    cfg, tcfg = _state(arch)[:2]
    p_j, p_t, _, _ = _moe_params(arch, "dense")
    p_j = dict(p_j, router={"w": jnp.zeros_like(p_j["router"]["w"])})
    p_t = dict(p_t, router={"w": torch.zeros_like(p_t["router"]["w"])})
    x = np.random.default_rng(8).standard_normal(
        (1, 20, cfg.d_model)).astype(np.float32)
    y_j, aux_j = jmoe.moe_apply(p_j, jnp.asarray(x), cfg)
    with torch.no_grad():
        y_t, aux_t = tmoe.moe_apply(p_t, torch.as_tensor(x), tcfg)
    assert _rel(y_t, y_j) < TOL_MOE
    assert abs(float(aux_t) - float(aux_j)) <= TOL_MOE * abs(float(aux_j))
    e_t, keep_t = _port_kept(p_t, torch.as_tensor(x), tcfg)
    assert (e_t == np.arange(cfg.moe.top_k)).all()
    np.testing.assert_array_equal(keep_t, _jax_kept(p_j, jnp.asarray(x),
                                                    cfg)[1])
    assert not keep_t.all()


# -------------------------------------------------------------- forward

@pytest.mark.parametrize("which", ["dense", "factorized"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_matches_jax(arch, which):
    """Logits and aux of the five new configs, dense and at the
    factorized row 0 with its rank masks; two rows of 24 tokens (the MoE
    layers drop pairs at that length)."""
    cfg, tcfg, dense, fact, table, infos = _state(arch)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    if which == "dense":
        p_j, p_t, r_j, r_t = dense, bridge.params_to_torch(dense), None, None
    else:
        p_j, p_t = fact, bridge.params_to_torch(jax.tree.map(np.asarray,
                                                             fact))
        r_j = JFR.ranks_tree(cfg, infos, JFR.table_device(table),
                             jnp.asarray(0))
        r_t = TFR.ranks_tree(tcfg, bridge.group_infos(infos),
                             TFR.table_host(bridge.profile_table(table)), 0)
    l_j, aux_j = jtfm.forward(jax.tree.map(jnp.asarray, p_j), cfg,
                              jnp.asarray(toks), ranks=r_j)
    with torch.no_grad():
        l_t, aux_t = ttfm.forward(p_t, tcfg, torch.as_tensor(toks),
                                  ranks=r_t)
    assert l_t.shape == l_j.shape
    assert _rel(l_t, l_j) < TOL_LOGITS
    assert aux_t.dtype == torch.float32 and aux_t.shape == ()
    if cfg.moe is None:
        assert float(aux_t) == float(aux_j) == 0.0
    else:
        assert float(aux_j) > 0.0
        assert abs(float(aux_t) - float(aux_j)) <= TOL_MOE * float(aux_j)


def test_unported_kinds_still_raise():
    """Every segment kind of the reference is ported: a vision unit in an
    attention config builds the reference's spec (4 stacked self blocks
    and the cross block); only an unknown kind raises, a ``ValueError`` as
    in the reference."""
    from repro.configs.base import Segment as JSegment
    from repro_torch.configs.base import ModelConfig, Segment
    tcfg = dataclasses.replace(tget("deepseek-7b", smoke=True),
                               segments=(Segment("vision_unit", 1),))
    cfg = dataclasses.replace(get_config("deepseek-7b", smoke=True),
                              segments=(JSegment("vision_unit", 1),))
    assert isinstance(tcfg, ModelConfig)
    shapes_t = [s.shape for s in tcm.tree_leaves(ttfm.model_spec(tcfg),
                                                 tcm.is_spec)]
    shapes_j = [s.shape for s in jax.tree.leaves(jtfm.model_spec(cfg),
                                                 is_leaf=jcm.is_spec)]
    assert shapes_t == shapes_j
    seg = ttfm.segment_spec(tcfg, tcfg.segments[0])
    assert seg["selfs"]["attn"]["q"]["w"].shape[:2] == (1, 4)
    assert seg["cross"]["gate"].shape == (1, 1)
    with pytest.raises(ValueError, match="unknown segment kind"):
        ttfm.model_spec(dataclasses.replace(
            tcfg, segments=(Segment("hyena", 1),)))


# ---------------------------------------------------------- paged steps

def _paged_operands(cfg, rng):
    """A flat batch of 40 tokens: two decode tokens, a 30-token prefill
    chunk and 8 pads on the null row (at deepseek-smoke's top-2 of 8
    experts the 80 pairs compete for 13 slots an expert, so pairs drop)."""
    bs, nb = 4, 24
    hd = cfg.resolved_head_dim
    pools = [{k: rng.standard_normal((s.count, nb, bs, cfg.num_kv_heads, hd)
                                     ).astype(np.float32) for k in "kv"}
             for s in cfg.segments]
    tables = np.zeros((4, 10), np.int32)
    tables[:3] = 1 + np.arange(30).reshape(3, 10) % 23
    slot_ids = np.asarray([0, 1] + [2] * 30 + [3] * 8, np.int32)
    positions = np.asarray([9, 5] + list(range(30)) + [0] * 8, np.int32)
    tok = rng.integers(0, cfg.vocab_size, (1, 40)).astype(np.int32)
    return pools, {"slot_ids": slot_ids, "positions": positions,
                   "block_tables": tables,
                   "sample_ids": np.asarray([0, 1, 31, 0], np.int32)}, tok


def _gar_row(arch, row):
    cfg, tcfg, _, fact, table, infos = _state(arch)
    jp = JFR.gar_deploy(fact, cfg, infos, table, row)
    return jp, bridge.params_to_torch(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("row", [0, -1])
def test_paged_mixed_step_matches_jax_with_drops(row, monkeypatch):
    arch = "deepseek-moe-16b"
    cfg, tcfg, _, _, table, _ = _state(arch)
    jp, tp = _gar_row(arch, row % table.table.shape[0])
    pools, ops_np, tok = _paged_operands(cfg, np.random.default_rng(5))
    kept = []
    slots = tmoe.assign_slots

    def record(top_e, e, cap):
        out = slots(top_e, e, cap)
        kept.append((cap, out[1].clone()))
        return out
    monkeypatch.setattr(tmoe, "assign_slots", record)
    jc = {**{k: jnp.asarray(v) for k, v in ops_np.items()},
          "segments": [{k: jnp.asarray(a) for k, a in p.items()}
                       for p in pools]}
    tc = {**{k: torch.as_tensor(v) for k, v in ops_np.items()},
          "segments": [{k: torch.as_tensor(a.copy()) for k, a in p.items()}
                       for p in pools]}
    lj, cj = jtfm.paged_mixed_step(jp, cfg, jc, jnp.asarray(tok))
    with torch.no_grad():
        lt, ct = ttfm.paged_mixed_step(tp, tcfg, tc, torch.as_tensor(tok))
    assert tuple(lt.shape) == tuple(lj.shape) == (1, 4, cfg.vocab_size)
    assert _rel(lt, lj) < TOL_LOGITS
    for pj, pt in zip(cj["segments"], ct["segments"]):
        for k in "kv":
            assert _rel(pt[k], pj[k]) < 1e-5
    # one flat batch per MoE layer, at the capacity of its 40 tokens
    assert len(kept) == cfg.segments[1].count
    assert all(cap == tmoe.capacity(tcfg, 40) for cap, _ in kept)
    assert any(not bool(keep.all()) for _, keep in kept)


def test_paged_decode_step_matches_jax():
    """Four slots, three live, four steps, each side feeding back its own
    greedy tokens: per-row capacity over the (B, 1) batch."""
    arch = "deepseek-moe-16b"
    cfg, tcfg, _, _, table, _ = _state(arch)
    jp, tp = _gar_row(arch, table.table.shape[0] - 1)
    rng = np.random.default_rng(11)
    bs, mb = 4, 8
    hd = cfg.resolved_head_dim
    pools = [{k: rng.standard_normal((s.count, 3 * mb + 1, bs,
                                      cfg.num_kv_heads, hd)
                                     ).astype(np.float32) for k in "kv"}
             for s in cfg.segments]
    tables = np.zeros((4, mb), np.int32)
    tables[:3] = 1 + rng.permutation(3 * mb).reshape(3, mb)
    positions = np.asarray([3, 13, 14, 0], np.int32)
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
    for _ in range(4):
        lj, jc = jtfm.paged_decode_step(jp, cfg, jc, tok_j)
        with torch.no_grad():
            lt, tc = ttfm.paged_decode_step(tp, tcfg, tc, tok_t)
        jc["positions"] = jc["positions"].at[3].set(0)
        tc["positions"][3] = 0
        assert _rel(lt, lj) < TOL_LOGITS
        tok_j = jnp.argmax(lj[:, -1], axis=-1).astype(jnp.int32)[:, None]
        tok_t = torch.argmax(lt[:, -1], dim=-1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))


# --------------------------------------------------------------- engine

def test_engine_streams_identical():
    """deepseek-moe-smoke served by both engines from one calibrated
    state: 8-token prefill chunks, greedy and temperature/top-k requests
    at two budgets. The flat batches are plan for plan the same, so the
    capacities and drops are too."""
    from repro.data import make_source
    from repro.launch.train import build_flexrank_state
    from repro.serving import ElasticEngine as JaxEngine
    from repro.serving import Request as JaxRequest
    from repro.serving import SamplingParams as JaxSampling
    from repro_torch.serving import ElasticEngine, Request, SamplingParams
    cfg = get_config("deepseek-moe-16b", smoke=True)
    dense = jcm.instantiate(jtfm.model_spec(cfg), jax.random.PRNGKey(0))
    params_fact, table, infos = build_flexrank_state(
        cfg, dense, make_source(cfg.vocab_size, 64, 4, seed=0))
    spec = [(14, 6, 1.0), (21, 5, 0.4), (9, 6, 1.0), (17, 4, 0.4)]

    def requests(req_cls, samp_cls):
        rng = np.random.default_rng(7)
        return [req_cls(prompt=rng.integers(0, cfg.vocab_size, pl)
                        .astype(np.int32), max_new_tokens=mn, budget=b,
                        sampling=(samp_cls(temperature=0.8, top_k=40,
                                           seed=3 + i) if i % 2 else None))
                for i, (pl, mn, b) in enumerate(spec)]

    kw = dict(max_batch=2, max_len=64, block_size=8, prefill_chunk=8)
    jeng = JaxEngine(cfg, params_fact, table, infos, lookahead=False, **kw)
    teng = ElasticEngine(tget("deepseek-moe-16b", smoke=True),
                         bridge.params_to_torch(params_fact),
                         bridge.profile_table(table),
                         bridge.group_infos(infos), device="cpu", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jres = jeng.generate(requests(JaxRequest, JaxSampling),
                             mode="auto")
        tres = teng.generate(requests(Request, SamplingParams), mode="auto")
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert t.budget_row == j.budget_row
    assert teng.last_metrics.summary()["mixed_iterations"] == \
        jeng.last_metrics.summary()["mixed_iterations"] > 0


# ---------------------------------------------------------------- state

@functools.lru_cache(maxsize=None)
def _calibrated(arch):
    """Both packages' moments, factors, curves and tables from the same
    dense weights and calibration batches (the launchers' source)."""
    cfg, tcfg, dense = _state(arch)[:3]
    src_j = jdata.make_source(cfg.vocab_size, 32, 4, seed=0)
    src_t = tdata.make_source(tcfg.vocab_size, 32, 4, seed=0)
    dense_j = jax.tree.map(jnp.asarray, dense)
    dense_t = bridge.params_to_torch(dense)
    mom_j = JFR.collect_moments(dense_j, cfg,
                                jdata.calibration_batches(src_j, 2))
    with torch.no_grad():
        mom_t = TFR.collect_moments(dense_t, tcfg,
                                    tdata.calibration_batches(src_t, 2))
    fact_j, curves_j = JFR.decompose(dense_j, cfg, mom_j)
    fact_t, curves_t = TFR.decompose(dense_t, tcfg, mom_t)
    return mom_j, mom_t, fact_j, curves_j, fact_t, curves_t


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "minicpm3-4b"])
def test_flexrank_state_matches_jax(arch):
    """Tap keys and moments (one per MoE layer's expert projection, its
    count every capacity slot, empty ones included), the groups in the
    reference's sorted order, the DataSVD curves, the table, and the GAR
    leaves of rows 0 and the top one."""
    cfg, tcfg = _state(arch)[:2]
    mom_j, mom_t, fact_j, curves_j, fact_t, curves_t = _calibrated(arch)
    assert sorted(mom_t) == sorted(mom_j)
    for key, (m_j, c_j) in mom_j.items():
        assert mom_t[key][1] == c_j, key
        assert _rel(mom_t[key][0], m_j) < 1e-4, key
    infos_t = TFR.group_infos(tcfg)
    assert [i.path for i in infos_t] == [
        i.path for i in JFR.group_infos(cfg)]
    paths = [i.path for i in infos_t]
    if cfg.moe is not None:
        assert paths.index("segments/1/mlp/experts/down") < paths.index(
            "segments/1/mlp/shared/down")
        # 2 batches of 4 rows of 32 tokens: every slot of every expert
        e = cfg.moe.num_experts
        for l in range(2):
            assert mom_t[f"segments/1/@{l}/mlp/experts/gate"][1] == \
                2 * 4 * e * tmoe.capacity(tcfg, 32)
        info = next(i for i in infos_t if i.path.endswith("experts/gate"))
        assert info.lead_dims == (2, e) and info.scan_dims == (2,)
    else:
        attn = [p.rsplit("/", 1)[1] for p in paths
                if "/attn/" in p and p.startswith("segments/0")]
        assert attn == ["kv_down", "kv_up", "o", "q_down", "q_up"]
    for path, c in curves_j.items():
        assert _rel(curves_t[path], c) < 1e-4, path
    table_j, infos_j = JFR.build_table(cfg, curves_j)
    table_t, tinfos = TFR.build_table(tcfg, {k: v.copy()
                                            for k, v in curves_j.items()})
    np.testing.assert_array_equal(table_t.table, table_j.table)
    assert tinfos == bridge.group_infos(infos_j)
    fact_jt = bridge.params_to_torch(jax.tree.map(np.asarray, fact_j))
    for k in (0, table_j.table.shape[0] - 1):
        jd = jax.tree.map(np.asarray, JFR.gar_deploy(fact_j, cfg, infos_j,
                                                     table_j, k))
        td = bridge.params_to_numpy(TFR.gar_deploy(fact_jt, tcfg, tinfos,
                                                   table_t, k))
        a = jax.tree_util.tree_flatten_with_path(jd)[0]
        b = jax.tree_util.tree_flatten_with_path(td)[0]
        assert [p for p, _ in a] == [p for p, _ in b]
        for (path, x), (_, y) in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape, path
            if x.dtype == np.int32:
                np.testing.assert_array_equal(y, x)
            else:
                np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-6)
        if cfg.moe is not None:
            perm = td["segments"][1]["mlp"]["experts"]["down"]["perm_inv"]
            assert perm.shape == (2, cfg.moe.num_experts, cfg.d_model)
    # bridged round trip of the deployed tree, (L, E) perm_inv included
    back = bridge.params_to_numpy(bridge.params_to_torch(td))
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(td)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_experts_share_their_layers_whitening():
    """``decompose`` computes one whitening per MoE layer's moment and
    reuses it for the layer's experts: the factors are bit for bit those
    of ``datasvd_factors`` computing it anew for each expert."""
    arch = "deepseek-moe-16b"
    cfg, tcfg, dense = _state(arch)[:3]
    _, mom_t, _, _, fact_t, _ = _calibrated(arch)
    w = bridge.params_to_torch(dense)["segments"][1]["mlp"]["experts"][
        "up"]["w"]
    for l in range(2):
        moment, count = mom_t[f"segments/1/@{l}/mlp/experts/up"]
        for e in (0, 3, cfg.moe.num_experts - 1):
            f = datasvd.datasvd_factors(w[l, e].T,
                                        sqrt_and_inv_sqrt(moment, count),
                                        max_rank=cfg.moe.d_ff_expert)
            leaf = fact_t["segments"][1]["mlp"]["experts"]["up"]
            assert torch.equal(leaf["u"][l, e], f.u)
            assert torch.equal(leaf["v"][l, e], f.v)


# ------------------------------------------------------------- decode

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_prefill_decode_matches_jax(dtype):
    """deepseek-moe-smoke: a prefill of 12 tokens (per-row capacity over
    the (B, S) batch), then three single steps, on both sides from one
    state, K/V caches of ``dtype``. float32: the logits within 1e-4 at
    every call. bfloat16: both sides round the same float32 K/V, but a
    value on a rounding midpoint may go either way, and the tokens after
    it then part (``test_torch_bf16_ties``): the logits agree at 1e-4
    before the first differing cache element, it is a one-ulp tie, and
    the rest agrees within bfloat16's 2u."""
    arch = "deepseek-moe-16b"
    cfg, tcfg, dense = _state(arch)[:3]
    p_j, p_t = jax.tree.map(jnp.asarray, dense), bridge.params_to_torch(dense)
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 15)).astype(np.int32)
    st_j = jtfm.init_decode_state(cfg, 2, 24, dtype=getattr(jnp, dtype))
    st_t = ttfm.init_decode_state(tcfg, 2, 24, dtype=getattr(torch, dtype))
    leaves = [c[k] for c in st_t["segments"] for k in ("k", "v")]
    feeds = [toks[:, :12]] + [toks[:, 12 + i:13 + i] for i in range(3)]
    outs_j, outs_t = [], []
    with torch.no_grad(), Bf16Writes(*leaves) as writes:
        for i, feed in enumerate(feeds):
            l_j, st_j = jtfm.decode_step(p_j, cfg, st_j, jnp.asarray(feed))
            fn = ttfm.prefill if i == 0 else ttfm.decode_step
            l_t, st_t = fn(p_t, tcfg, st_t, torch.as_tensor(feed))
            if dtype == "float32":
                assert _rel(l_t, l_j) < TOL_LOGITS, i
            outs_j.append(np.asarray(l_j))
            outs_t.append(l_t.numpy())
    assert st_t["pos"] == int(st_j["pos"]) == 15
    if dtype == "bfloat16":
        def layers(segs, get):
            return [{k: get(c[k])[l] for k in ("k", "v")}
                    for c in segs for l in range(c["k"].shape[0])]
        check_bf16_parity(
            np.concatenate(outs_t, 1), np.concatenate(outs_j, 1),
            layers(st_t["segments"], lambda a: a),
            layers(st_j["segments"], np.asarray),
            layers(st_t["segments"], writes.shadow), tol=TOL_LOGITS)


@pytest.mark.parametrize("shape,r", [((6, 40, 24), 12), ((3, 24, 24), 24),
                                     ((1, 30, 8), 1), ((5, 16, 16), 9)])
def test_gar_transform_of_a_stack_equals_each_matrix(shape, r):
    """``gar_deploy`` transforms a leaf's matrices (a group's layers, an MoE
    layer's experts) as one stack: each matrix's pivots and factors are
    bit for bit those of its own call (a repeated row among them)."""
    from repro_torch.core import gar as tgar
    rng = np.random.default_rng(shape[0] * 100 + r)
    n_in = 20
    u = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    v = torch.as_tensor(rng.standard_normal(
        (shape[0], n_in, shape[2])).astype(np.float32))
    if shape[1] > r:
        u[-1, 5] = u[-1, 2]
    stack = tgar.gar_transform(u, v, r)
    for i in range(shape[0]):
        one = tgar.gar_transform(u[i], v[i], r)
        assert torch.equal(stack.perm[i], one.perm)
        assert torch.equal(stack.u_hat[i], one.u_hat)
        assert torch.equal(stack.v_tilde[i], one.v_tilde)
