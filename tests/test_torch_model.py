"""The port's model path against the JAX package's, on the CPU: the
parameter bridge, the shared primitives, and ``paged_mixed_step`` on the
gpt2 smoke fixture at two budget rows."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config
from repro.core import flexrank as JFR
from repro.models import common as jcm
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_config as tget
from repro_torch.core import flexrank as TFR
from repro_torch.models import common as tcm
from repro_torch.models import transformer as ttfm

torch.set_num_threads(1)

RNG = np.random.default_rng(1)


@pytest.fixture(scope="module")
def fixture():
    """The JAX suite's smoke state (tests/test_chunked_prefill.py recipe)
    and its bridged copy."""
    from repro.data import make_source
    from repro.launch.train import build_flexrank_state
    cfg = get_config("gpt2-small", smoke=True)
    source = make_source(cfg.vocab_size, 64, 4, seed=0)
    dense = jcm.instantiate(jtfm.model_spec(cfg), jax.random.PRNGKey(0))
    params_fact, table, infos = build_flexrank_state(cfg, dense, source)
    return (cfg, dense, params_fact, table, infos,
            tget("gpt2-small", smoke=True))


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_bridge_round_trip_exact(fixture):
    cfg, dense, params_fact, table, infos, tcfg = fixture
    deployed = JFR.gar_deploy(params_fact, cfg, infos, table, 0)
    for tree in (dense, params_fact, deployed):
        np_tree = jax.tree.map(np.asarray, tree)
        back = bridge.params_to_numpy(bridge.params_to_torch(np_tree))
        a, b = _flat(np_tree), _flat(back)
        assert [p for p, _ in a] == [p for p, _ in b]
        for (path, x), (_, y) in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape, path
            np.testing.assert_array_equal(x, y)
    t = bridge.params_to_torch(deployed)
    assert t["segments"][0]["attn"]["q"]["perm_inv"].dtype == torch.int64
    tt = bridge.profile_table(table)
    np.testing.assert_array_equal(tt.table, table.table)
    assert (tt.layer_names, tt.budgets, tt.max_ranks) == \
        (table.layer_names, table.budgets, table.max_ranks)
    assert bridge.group_infos(infos) == TFR.group_infos(tcfg)


def test_specs_match(fixture):
    cfg, *_, tcfg = fixture
    jspec, tspec = jtfm.model_spec(cfg), ttfm.model_spec(tcfg)
    assert tcm.param_count(tspec) == jcm.param_count(jspec)
    shapes = [s.shape for s in jax.tree.leaves(
        JFR.factorized_spec(cfg), is_leaf=jcm.is_spec)]
    assert [s.shape for s in tcm.tree_leaves(
        TFR.factorized_spec(tcfg), tcm.is_spec)] == shapes


def test_tree_items_paths_match_jax(fixture):
    """``tree_items`` walks in ``tree_leaves`` order and names each leaf by
    the JAX tree's key path (dict keys and list indices joined by ``/``)."""
    cfg, *_, tcfg = fixture
    flat, _ = jax.tree_util.tree_flatten_with_path(
        JFR.factorized_spec(cfg), is_leaf=jcm.is_spec)
    jpaths = ["/".join(str(k.key if hasattr(k, "key") else k.idx)
                       for k in path) for path, _ in flat]
    tree = TFR.factorized_spec(tcfg)
    items = list(tcm.tree_items(tree, tcm.is_spec))
    assert [p for p, _ in items] == jpaths
    assert [s for _, s in items] == tcm.tree_leaves(tree, tcm.is_spec)
    for p, s in items:
        assert tcm.tree_get(tree, p) is s


# ------------------------------------------------------------ primitives

def _close(t, j, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("form", ["dense", "factorized", "masked", "gar",
                                  "gar_full_rank"])
def test_linear_forms(form):
    n, m, r = 24, 20, 12

    def w(*shape):   # weights scaled by 1/sqrt(fan_in), as instantiate does
        return (RNG.standard_normal(shape) / np.sqrt(shape[0])).astype(
            np.float32)

    x = RNG.standard_normal((2, 5, n)).astype(np.float32)
    rank = None
    if form == "dense":
        p = {"w": w(n, m)}
    elif form in ("factorized", "masked"):
        p = {"v": w(n, r), "u": w(m, r)}
        rank = 5 if form == "masked" else None
    else:
        rr = m if form == "gar_full_rank" else r
        p = {"v_tilde": w(n, rr), "u_hat": w(m - rr, rr),
             "perm_inv": RNG.permutation(m).astype(np.int32)}
    y_j = jcm.linear(jax.tree.map(jnp.asarray, p), jnp.asarray(x), rank=rank)
    y_t = tcm.linear(bridge.params_to_torch(p), torch.as_tensor(x), rank=rank)
    _close(y_t, y_j)


def test_norm_rope_swiglu():
    x = RNG.standard_normal((2, 7, 3, 16)).astype(np.float32)
    scale = RNG.standard_normal(16).astype(np.float32)
    _close(tcm.rms_norm(torch.as_tensor(x), torch.as_tensor(scale)),
           jcm.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    for pos in (np.arange(7, dtype=np.int32),
                RNG.integers(0, 300, (2, 7)).astype(np.int32)):
        _close(tcm.rope(torch.as_tensor(x), torch.as_tensor(pos)),
               jcm.rope(jnp.asarray(x), jnp.asarray(pos)))
        _close(tcm.rope(torch.as_tensor(x), torch.as_tensor(pos), dims=8,
                        base=500000.0),
               jcm.rope(jnp.asarray(x), jnp.asarray(pos), dims=8,
                        base=500000.0))
    g = RNG.standard_normal((4, 9)).astype(np.float32)
    u = RNG.standard_normal((4, 9)).astype(np.float32)
    _close(tcm.swiglu(torch.as_tensor(g), torch.as_tensor(u)),
           jcm.swiglu(jnp.asarray(g), jnp.asarray(u)))


def test_instantiate_is_seeded():
    from repro_torch.models import attention as tattn
    cfg = tget("gpt2-small", smoke=True)
    spec = tattn.attn_spec(cfg)
    a = tcm.instantiate(spec, torch.Generator().manual_seed(4))
    b = tcm.instantiate(spec, torch.Generator().manual_seed(4))
    for x, y in zip(tcm.tree_leaves(a), tcm.tree_leaves(b)):
        assert torch.equal(x, y)
    assert float(a["q_norm"].abs().sum()) == 0.0
    assert abs(float(a["q"]["w"].std()) * cfg.d_model ** 0.5 - 1.0) < 0.1


# ------------------------------------------------------ paged mixed step

def _mixed_operands(cfg, rng):
    """Two live slots (a decode token and a prefill chunk) plus pads that
    point at the null row, with a sample_ids gather."""
    bs, nb = 4, 11
    hd = cfg.resolved_head_dim
    pools = [{k: rng.standard_normal((s.count, nb, bs, cfg.num_kv_heads, hd)
                                     ).astype(np.float32) for k in "kv"}
             for s in cfg.segments]
    tables = np.asarray([[1, 2, 3, 4, 0, 0], [5, 6, 7, 8, 9, 10],
                         [0, 0, 0, 0, 0, 0]], np.int32)
    slot_ids = np.asarray([0, 1, 1, 1, 1, 1, 2, 2], np.int32)
    positions = np.asarray([13, 17, 18, 19, 20, 21, 0, 0], np.int32)
    tok = rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)
    sample_ids = np.asarray([0, 5, 0, 0], np.int32)
    return pools, {"slot_ids": slot_ids, "positions": positions,
                   "block_tables": tables, "sample_ids": sample_ids}, tok


@pytest.mark.parametrize("row", [0, -1])
@pytest.mark.parametrize("gather", [True, False])
def test_paged_mixed_step_matches_jax(fixture, row, gather):
    cfg, _, params_fact, table, infos, tcfg = fixture
    row = row % table.table.shape[0]
    jparams = JFR.gar_deploy(params_fact, cfg, infos, table, row)
    tparams = bridge.params_to_torch(jparams)
    pools, ops_np, tok = _mixed_operands(cfg, np.random.default_rng(row))
    if not gather:
        ops_np = {k: v for k, v in ops_np.items() if k != "sample_ids"}
    jc = {**{k: jnp.asarray(v) for k, v in ops_np.items()},
          "segments": [{k: jnp.asarray(a) for k, a in p.items()}
                       for p in pools]}
    tc = {**{k: torch.as_tensor(v) for k, v in ops_np.items()},
          "segments": [{k: torch.as_tensor(a.copy()) for k, a in p.items()}
                       for p in pools]}
    lj, cj = jtfm.paged_mixed_step(jparams, cfg, jc, jnp.asarray(tok))
    lt, ct = ttfm.paged_mixed_step(tparams, tcfg, tc, torch.as_tensor(tok))
    assert tuple(lt.shape) == tuple(lj.shape) == \
        ((1, 4, cfg.vocab_size) if gather else (1, 8, cfg.vocab_size))
    assert float(np.abs(lt.numpy() - np.asarray(lj)).max()) < 1e-4
    for pj, pt, p0 in zip(cj["segments"], ct["segments"], pools):
        for k in "kv":
            assert float(np.abs(pt[k].numpy() - np.asarray(pj[k])).max()) \
                < 1e-5
            assert not np.array_equal(pt[k].numpy(), p0[k])   # in place


def test_paged_mixed_step_with_factorized_ranks(fixture):
    """The factorized form with the nested rank mask on the same path."""
    cfg, _, params_fact, table, infos, tcfg = fixture
    import jax.numpy as jnp_
    ranks_j = JFR.ranks_tree(cfg, infos, JFR.table_device(table),
                             jnp_.asarray(0))
    ranks_t = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), ranks_j)
    pools, ops_np, tok = _mixed_operands(cfg, np.random.default_rng(9))
    jc = {**{k: jnp.asarray(v) for k, v in ops_np.items()},
          "segments": [{k: jnp.asarray(a) for k, a in p.items()}
                       for p in pools]}
    tc = {**{k: torch.as_tensor(v) for k, v in ops_np.items()},
          "segments": [{k: torch.as_tensor(a.copy()) for k, a in p.items()}
                       for p in pools]}
    lj, _ = jtfm.paged_mixed_step(params_fact, cfg, jc, jnp.asarray(tok),
                                  ranks=ranks_j)
    lt, _ = ttfm.paged_mixed_step(bridge.params_to_torch(params_fact), tcfg,
                                  tc, torch.as_tensor(tok), ranks=ranks_t)
    assert float(np.abs(lt.numpy() - np.asarray(lj)).max()) < 1e-4
