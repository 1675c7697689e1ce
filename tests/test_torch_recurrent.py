"""The port's recurrent families (rwkv6, zamba2) against the JAX package's,
on the CPU, at the smoke configs (seq 32, batch 2): the WKV6 and SSD plain
versions and their dispatch, their gradients, ``rwkv_apply`` and
``mamba_apply``, the forward with factorized params at the first and last
budget rows, the calibration moments, DataSVD curves and DP table, the
consolidation loss and its gradients, and two training steps.

Every leaf that the specs initialize to zero (decay and mixing LoRAs,
bonus, ``a_log``, ``dt_bias``, norm scales) holds small random values
instead, the same numpy arrays in both packages: from zeros every
decay would be ``exp(-1)`` and the data-dependent decay would go
unexercised. Tolerances, float32 throughout: the chunked plain versions
against the reference's chunked versions 1e-5 of the output's max (the
same arithmetic); against the sequential recurrences 1e-4 (another order:
cumulative log-decays against a step-by-step product); gradients 1e-4 of
each gradient's max; forward logits and losses 1e-4 relative, moments
1e-5 of their max, curves 1e-3 of their max, loss gradients 1e-3 of each
leaf's max, two training steps 1e-3 relative, as in
``tests/test_torch_train.py`` and for its reasons.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import data as jdata
from repro.configs import get_config
from repro.core import flexrank as JFR
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import common as jcm
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro_torch import bridge, threefry
from repro_torch import data as tdata
from repro_torch.configs import get_config as tget
from repro_torch.core import flexrank as TFR
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcm
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm

torch.set_num_threads(1)

SEQ, BATCH = 32, 2
ARCHS = ("rwkv6-3b", "zamba2-7b")
CALIB_BATCHES = {"rwkv6-3b": 8, "zamba2-7b": 2}


def _rel(a, b) -> float:
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-12)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _dense(arch, seed=0):
    """(cfg, port cfg, JAX dense params, port dense params): one set of
    numpy weights drawn as ``common.instantiate`` scales them (normal
    leaves N(0, 1/fan_in), ones kept), every zero-initialized leaf drawn
    from 0.2 x N(0, 1) instead."""
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(seed)

    def draw(spec):
        if spec.init == "ones":
            return np.ones(spec.shape, np.float32)
        scale = 0.2 if spec.init == "zeros" else 1.0 / np.sqrt(
            spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1])
        return (scale * rng.standard_normal(spec.shape)).astype(np.float32)

    dense = jax.tree.map(draw, jtfm.model_spec(cfg), is_leaf=jcm.is_spec)
    return (cfg, tget(arch, smoke=True), jax.tree.map(jnp.asarray, dense),
            bridge.params_to_torch(dense))


# -------------------------------------------------- WKV6 plain versions

def _wkv_inputs(b, s, h, n, seed, *, w_low=1e-14):
    """r/k/v standard normal, w log-uniform over (w_low, 1) (below 1e-12
    some decays meet the clamp), u standard normal."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32)
               for _ in range(3))
    w = (10.0 ** rng.uniform(np.log10(w_low), 0, (b, s, h, n))).astype(
        np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    return r, k, v, w, u


def _flat(t, b, s, h, n):
    return t.transpose(0, 2, 1, 3).reshape(b * h, s, n)


@pytest.mark.parametrize("b,s,h,n,chunk,tol", [(2, 48, 3, 8, 16, 1e-5),
                                               (1, 64, 2, 16, 64, 1e-4)])
def test_wkv_chunked_matches_jax(b, s, h, n, chunk, tol):
    """At chunk 64 the cumulative log-decays reach some 900 in magnitude
    (decays down to 1e-14), and float32 keeps their differences, the
    exponents of the decay tensor, to about 5e-5: both packages stand
    2-4e-5 off the sequential recurrence there, so 1e-4."""
    arrays = _wkv_inputs(b, s, h, n, s + n)
    y_j, st_j = jrwkv.wkv_chunked(*map(jnp.asarray, arrays), chunk=chunk)
    y_t, st_t = trwkv.wkv_chunked(*map(torch.as_tensor, arrays), chunk=chunk)
    assert _rel(y_t, y_j) < tol
    assert _rel(st_t, st_j) < tol


@pytest.mark.parametrize("b,s,h,n", [(2, 50, 3, 8), (1, 33, 2, 16)])
def test_wkv6_ref_and_ops_match_jax(b, s, h, n):
    """Ragged S: the sequential oracles against each other, and the port's
    dispatch (the chunked version, steps padded) against the reference's
    sequential dispatch."""
    r, k, v, w, u = _wkv_inputs(b, s, h, n, s * n)
    flat = [_flat(t, b, s, h, n) for t in (r, k, v, w)]
    uf = np.tile(u, (b, 1))
    y_j = np.asarray(jref.wkv6_ref(*map(jnp.asarray, flat), jnp.asarray(uf)))
    y_t = ref.wkv6_ref(*map(torch.as_tensor, flat), torch.as_tensor(uf))
    assert _rel(y_t, y_j) < 1e-5
    y_ops_j = jops.wkv6_forward(*map(jnp.asarray, (r, k, v, w, u)))
    y_ops_t = ops.wkv6_forward(*map(torch.as_tensor, (r, k, v, w, u)),
                               chunk=16)
    assert y_ops_t.shape == (b, s, h, n)
    assert _rel(y_ops_t, y_ops_j) < 1e-4


def test_wkv6_ops_matches_jax_interpret():
    """One small case of the Pallas kernel in interpret mode, ragged S."""
    arrays = _wkv_inputs(1, 20, 2, 8, 3)
    y_j = jops.wkv6_forward(*map(jnp.asarray, arrays), chunk=8,
                            use_pallas="interpret")
    y_t = ops.wkv6_forward(*map(torch.as_tensor, arrays), chunk=8)
    assert _rel(y_t, y_j) < 1e-4


# --------------------------------------------------- SSD plain versions

def _ssd_inputs(b, s, h, p, g, n, seed, *, dt_scale=0.5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((b, s, h))) * dt_scale).astype(
        np.float32)
    a = -np.abs(rng.standard_normal(h)).astype(np.float32)
    bb, cc = (rng.standard_normal((b, s, g, n)).astype(np.float32)
              for _ in range(2))
    return x, dt, a, bb, cc


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [(2, 48, 4, 8, 1, 16, 16),
                                               (1, 40, 4, 16, 2, 8, 20)])
def test_ssd_chunked_matches_jax(b, s, h, p, g, n, chunk):
    arrays = _ssd_inputs(b, s, h, p, g, n, s + g)
    y_j, st_j = jssm.ssd_chunked(*map(jnp.asarray, arrays), chunk=chunk)
    y_t, st_t = tssm.ssd_chunked(*map(torch.as_tensor, arrays), chunk=chunk)
    assert _rel(y_t, y_j) < 1e-5
    assert _rel(st_t, st_j) < 1e-5


@pytest.mark.parametrize("b,s,h,p,g,n", [(2, 37, 4, 8, 1, 4),
                                         (1, 50, 6, 8, 2, 16)])
def test_ssd_ref_and_ops_match_jax(b, s, h, p, g, n):
    x, dt, a, bb, cc = _ssd_inputs(b, s, h, p, g, n, s * h)
    rep = h // g
    xf = x.transpose(0, 2, 1, 3).reshape(b * h, s, p)
    dtf = dt.transpose(0, 2, 1).reshape(b * h, s)
    bf, cf = (np.repeat(t, rep, axis=2).transpose(0, 2, 1, 3).reshape(
        b * h, s, n) for t in (bb, cc))
    af = np.tile(a, b)
    y_j = np.asarray(jref.ssd_ref(*map(jnp.asarray, (xf, dtf, af, bf, cf))))
    y_t = ref.ssd_ref(*map(torch.as_tensor, (xf, dtf, af, bf, cf)))
    assert _rel(y_t, y_j) < 1e-5
    y_ops_j = jops.ssd_forward(*map(jnp.asarray, (x, dt, a, bb, cc)))
    y_ops_t = ops.ssd_forward(*map(torch.as_tensor, (x, dt, a, bb, cc)),
                              chunk=16)
    assert y_ops_t.shape == (b, s, h, p)
    assert _rel(y_ops_t, y_ops_j) < 1e-4


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_ops_matches_jax_interpret(g):
    arrays = _ssd_inputs(1, 20, 4, 8, g, 8, 7 + g)
    y_j = jops.ssd_forward(*map(jnp.asarray, arrays), chunk=8,
                           use_pallas="interpret")
    y_t = ops.ssd_forward(*map(torch.as_tensor, arrays), chunk=8)
    assert _rel(y_t, y_j) < 1e-4


# ------------------------------------------------------------ gradients

def _grads_t(fn, arrays, dy):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    fn(*ts).backward(torch.as_tensor(dy))
    return [t.grad for t in ts]


def test_wkv6_grads_match_jax():
    """The recompute backward against ``jax.grad`` of the reference's
    chunked form, at decays in (0.2, 1): the masked exponent of the
    reference stays finite (below chunk x 1.7), so its gradient is too."""
    b, s, h, n, chunk = 2, 40, 2, 8, 8
    arrays = list(_wkv_inputs(b, s, h, n, 11, w_low=0.2))
    dy = np.random.default_rng(12).standard_normal((b, s, h, n)).astype(
        np.float32)
    g_j = jax.grad(lambda *a: jnp.sum(jrwkv.wkv_chunked(
        *a, chunk=chunk)[0] * dy), argnums=tuple(range(5)))(
        *map(jnp.asarray, arrays))
    g_t = _grads_t(lambda *a: ops.wkv6_forward(*a, chunk=chunk), arrays, dy)
    for name, a, b_ in zip("rkvwu", g_t, g_j):
        assert _rel(a, b_) < 1e-4, name


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_grads_match_jax(g):
    """As for WKV6, at step sizes whose masked exponent stays finite in the
    reference (the sum of at most 15 steps of |N(0, 0.5)| |a|)."""
    b, s, h, p, n, chunk = 2, 32, 4, 8, 8, 16
    arrays = list(_ssd_inputs(b, s, h, p, g, n, 13 + g))
    dy = np.random.default_rng(14).standard_normal((b, s, h, p)).astype(
        np.float32)
    g_j = jax.grad(lambda *a: jnp.sum(jssm.ssd_chunked(
        *a, chunk=chunk)[0] * dy), argnums=tuple(range(5)))(
        *map(jnp.asarray, arrays))
    g_t = _grads_t(lambda *a: ops.ssd_forward(*a, chunk=chunk), arrays, dy)
    for name, a, b_ in zip(("x", "dt", "a", "b", "c"), g_t, g_j):
        assert _rel(a, b_) < 1e-4, name


def test_ssd_grads_finite_where_the_masked_exponent_overflows():
    """Step sizes whose masked exponent passes float32's range (the sum
    of up to 63 step sizes past 88.7, as zamba2's chunks of 128 can
    reach): through ``where(mask, exp(rel), 0)`` the reference's gradients
    in ``dt`` and ``a`` are NaN (0 x inf); the port's masked exponent
    keeps every gradient finite and equal to autograd through the
    sequential recurrence, and those in x, b and c to the reference's."""
    b, s, h, p, g, n, chunk = 1, 64, 2, 8, 1, 8, 64
    arrays = list(_ssd_inputs(b, s, h, p, g, n, 15, dt_scale=4.0))
    arrays[2] = -np.ones(h, np.float32)
    assert arrays[1][0, 1:].sum(0).min() > 89.0     # exp overflows
    dy = np.random.default_rng(16).standard_normal((b, s, h, p)).astype(
        np.float32)
    g_t = _grads_t(lambda *a: ops.ssd_forward(*a, chunk=chunk), arrays, dy)
    g_j = jax.grad(lambda *a: jnp.sum(jssm.ssd_chunked(
        *a, chunk=chunk)[0] * dy), argnums=tuple(range(5)))(
        *map(jnp.asarray, arrays))

    def sequential(x, dt, a, bb, cc):
        rep = h // g
        xf = x.transpose(1, 2).reshape(b * h, s, p)
        dtf = dt.transpose(1, 2).reshape(b * h, s)
        bf, cf = (t.repeat_interleave(rep, 2).transpose(1, 2).reshape(
            b * h, s, n) for t in (bb, cc))
        y = ref.ssd_ref(xf, dtf, a.repeat(b), bf, cf)
        return y.reshape(b, h, s, p).transpose(1, 2)

    g_s = _grads_t(sequential, arrays, dy)
    for name, a, b_s, b_j in zip(("x", "dt", "a", "b", "c"), g_t, g_s, g_j):
        assert torch.isfinite(a).all(), name
        assert _rel(a, b_s.numpy()) < 1e-4, name
        if name in ("dt", "a"):
            assert np.isnan(np.asarray(b_j)).all(), name
        else:
            assert _rel(a, b_j) < 1e-4, name


# ------------------------------------------------------- block applies

def test_rwkv_apply_matches_jax():
    cfg, tcfg, dense_j, dense_t = _dense("rwkv6-3b")
    x = np.random.default_rng(1).standard_normal(
        (BATCH, SEQ, cfg.d_model)).astype(np.float32)
    p_j = jax.tree.map(lambda a: a[0], dense_j["segments"][0])
    p_t = tcm.tree_map(lambda a: a[0], dense_t["segments"][0])
    y_j = jax.jit(lambda p, x: jrwkv.rwkv_apply(p, x, cfg)[0])(
        p_j, jnp.asarray(x))
    y_t, _ = trwkv.rwkv_apply(p_t, torch.as_tensor(x), tcfg)
    assert _rel(y_t, y_j) < 1e-5
    # the carried-state branch from a zero state gives the same block
    # output through the chunked plain form, and a state of the
    # reference's layout
    zero = tcm.tree_map(lambda a: a[0], trwkv.init_rwkv_state(
        tcfg, BATCH, num_instances=1))
    y_s, st = trwkv.rwkv_apply(p_t, torch.as_tensor(x), tcfg, state=zero)
    assert _rel(y_s, y_j) < 1e-5
    assert sorted(st) == ["shift_c", "shift_t", "wkv"]


def test_mamba_apply_matches_jax():
    cfg, tcfg, dense_j, dense_t = _dense("zamba2-7b")
    x = np.random.default_rng(2).standard_normal(
        (BATCH, SEQ, cfg.d_model)).astype(np.float32)
    p_j = jax.tree.map(lambda a: a[0], dense_j["segments"][1]["mamba"])
    p_t = tcm.tree_map(lambda a: a[0], dense_t["segments"][1]["mamba"])
    y_j = jax.jit(lambda p, x: jssm.mamba_apply(p, x, cfg)[0])(
        p_j, jnp.asarray(x))
    y_t, _ = tssm.mamba_apply(p_t, torch.as_tensor(x), tcfg)
    assert _rel(y_t, y_j) < 1e-5
    zero = tcm.tree_map(lambda a: a[0], tssm.init_mamba_state(
        tcfg, BATCH, num_instances=1))
    y_s, st = tssm.mamba_apply(p_t, torch.as_tensor(x), tcfg, state=zero)
    assert _rel(y_s, y_j) < 1e-5
    assert sorted(st) == ["conv", "ssd"]


# ---------------------------------------------- the FlexRank pipeline

@functools.lru_cache(maxsize=None)
def _state(arch):
    """Both packages calibrate, decompose and DP-select from one set of
    dense weights (the port from the bridged copy)."""
    cfg, tcfg, dense, dense_t = _dense(arch)
    src_j = jdata.make_source(cfg.vocab_size, SEQ, BATCH, seed=0)
    src_t = tdata.make_source(tcfg.vocab_size, SEQ, BATCH, seed=0)
    # the launchers' 8 calibration batches where the training loop is
    # compared (rwkv6); 2 for zamba2, whose eager JAX calibration is slow
    n_cal = CALIB_BATCHES[arch]
    mom_j = JFR.collect_moments(dense, cfg,
                                jdata.calibration_batches(src_j, n_cal))
    mom_t = TFR.collect_moments(dense_t, tcfg,
                                tdata.calibration_batches(src_t, n_cal))
    fact_j, curves_j = JFR.decompose(dense, cfg, mom_j)
    fact_t, curves_t = TFR.decompose(dense_t, tcfg, mom_t)
    table_j, infos_j = JFR.build_table(cfg, curves_j)
    table_t, infos_t = TFR.build_table(tcfg, curves_t)
    return dict(arch=arch, cfg=cfg, tcfg=tcfg, src_j=src_j,
                src_t=src_t, dense=dense, dense_t=dense_t, mom_j=mom_j,
                mom_t=mom_t, fact_j=fact_j, curves_j=curves_j,
                curves_t=curves_t, table_j=table_j, table_t=table_t,
                infos_j=infos_j, infos_t=infos_t)


@pytest.fixture(params=ARCHS)
def st(request):
    return _state(request.param)


def test_groups_and_tap_keys(st):
    """8 groups for rwkv6, 11 for zamba2; the tap keys are the reference's
    (two layer indices for zamba2's unit mambas, none for the shared
    attention block) and the moments agree."""
    assert len(st["infos_t"]) == {"rwkv6-3b": 8, "zamba2-7b": 11}[st["arch"]]
    assert st["infos_t"] == bridge.group_infos(st["infos_j"])
    assert sorted(st["mom_t"]) == sorted(st["mom_j"])
    if st["arch"] == "zamba2-7b":
        assert "segments/0/@1/mambas/@0/mamba/in_proj" in st["mom_t"]
        assert "shared_attn/attn/q" in st["mom_t"]
        # the shared block's moments sum over both units
        assert st["mom_t"]["shared_attn/attn/q"][1] == \
            2 * BATCH * SEQ * CALIB_BATCHES["zamba2-7b"]
    else:
        assert "segments/0/@1/time/r" in st["mom_t"]
    for key, (m_j, c_j) in st["mom_j"].items():
        m_t, c_t = st["mom_t"][key]
        assert c_t == c_j
        assert _rel(m_t, m_j) < 1e-5, key


def test_curves_close_and_table_identical(st):
    for path, c_j in st["curves_j"].items():
        assert _rel(st["curves_t"][path], c_j) < 1e-3, path
    np.testing.assert_array_equal(st["table_t"].table, st["table_j"].table)
    assert st["table_t"].layer_names == st["table_j"].layer_names


def test_forward_first_and_last_rows(st):
    """The forward of the JAX factors (bridged) at budget rows 0 and last."""
    cfg, tcfg = st["cfg"], st["tcfg"]
    fact_t = bridge.params_to_torch(_np_tree(st["fact_j"]))
    tokens = st["src_j"].batch_at(3)["tokens"][:, :-1]
    tdev_j = JFR.table_device(st["table_j"])
    tdev_t = TFR.table_host(st["table_t"])
    for k in (0, tdev_t.shape[0] - 1):
        l_j, _ = jtfm.forward(st["fact_j"], cfg, jnp.asarray(tokens),
                              ranks=JFR.ranks_tree(cfg, st["infos_j"], tdev_j,
                                                   jnp.asarray(k)))
        l_t, _ = ttfm.forward(fact_t, tcfg, torch.as_tensor(tokens),
                              ranks=TFR.ranks_tree(tcfg, st["infos_t"],
                                                   tdev_t, k))
        assert l_t.shape == (BATCH, SEQ, tcfg.vocab_size)
        assert _rel(l_t, l_j) < 1e-4, k


def _key_for_row(k: int, num_k: int) -> int:
    return next(i for i in range(1000)
                if TFR.budget_draw(threefry.prng_key(i), num_k) == k)


def test_consolidation_loss_and_grads(st):
    cfg, tcfg = st["cfg"], st["tcfg"]
    num_k = st["table_t"].table.shape[0]
    seed = _key_for_row(0, num_k)
    batch = st["src_j"].batch_at(2)
    loss_j = JFR.make_consolidation_loss(cfg, st["infos_j"],
                                         JFR.table_device(st["table_j"]),
                                         st["dense"])
    (l_j, aux_j), g_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        st["fact_j"], {"tokens": jnp.asarray(batch["tokens"])},
        jax.random.PRNGKey(seed))
    params = tcm.tree_map(lambda t: t.requires_grad_(True),
                          bridge.params_to_torch(_np_tree(st["fact_j"])))
    loss_t = TFR.make_consolidation_loss(tcfg, st["infos_t"],
                                         TFR.table_host(st["table_t"]),
                                         st["dense_t"])
    l_t, aux_t = loss_t(params, {"tokens": torch.as_tensor(batch["tokens"])},
                        threefry.prng_key(seed))
    l_t.backward()
    assert aux_t["budget_k"] == int(aux_j["budget_k"]) == 0
    assert abs(float(l_t.detach()) - float(l_j)) / abs(float(l_j)) < 1e-4
    flat_j = jax.tree_util.tree_flatten_with_path(g_j)[0]
    assert len(flat_j) == len(tcm.tree_leaves(params))
    for path, g in flat_j:
        leaf = params
        for p in path:
            leaf = leaf[getattr(p, "key", getattr(p, "idx", None))]
        grad = torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
        assert np.all(np.isfinite(np.asarray(g)))
        assert _rel(grad, g) < 1e-3, jax.tree_util.keystr(path)


def test_two_steps_match_reference_loop():
    """``repro_torch.launch.train.run`` against ``repro.launch.train``'s
    flexrank_kd loop from the same dense weights and batches (rwkv6)."""
    st = _state("rwkv6-3b")
    cfg = st["cfg"]
    steps, lr, seed = 2, 1e-3, 0
    opt_cfg = jadamw.AdamWConfig(lr=lr, warmup_steps=min(100, steps // 10 + 1),
                                 total_steps=steps)
    loss_fn = JFR.make_consolidation_loss(
        cfg, st["infos_j"], JFR.table_device(st["table_j"]), st["dense"])

    @jax.jit
    def step_fn(params, opt_state, batch, rng):
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, batch, rng)
        params, opt_state, _ = jadamw.apply_updates(params, grads, opt_state,
                                                    opt_cfg)
        return params, opt_state, metrics

    params, opt_state = st["fact_j"], jadamw.init(st["fact_j"])
    losses_j, rows_j = [], []
    for step in range(steps):
        batch = {"tokens": jnp.asarray(st["src_j"].batch_at(step)["tokens"])}
        rng = jax.random.fold_in(jax.random.PRNGKey(seed + 1), step)
        params, opt_state, metrics = step_fn(params, opt_state, batch, rng)
        losses_j.append(float(metrics["loss"]))
        rows_j.append(int(metrics["budget_k"]))
    res = ttrain.run(st["tcfg"], st["dense_t"], st["src_t"], steps=steps,
                     lr=lr, seed=seed, log=lambda s: None)
    assert res.budget_rows == rows_j
    np.testing.assert_allclose(res.losses, losses_j, rtol=1e-3)
    assert all(np.isfinite(res.eval_before + res.eval_after))


def test_launcher_cli_recurrent():
    for arch in ARCHS:
        _, losses = ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                                 "--mode", "flexrank_kd", "--steps", "2",
                                 "--seq-len", "16", "--batch", "2"])
        assert len(losses) == 2 and all(np.isfinite(losses))


@pytest.mark.parametrize("arch,match", [
    ("seamless-m4t-medium", "A.13"), ("llama-3.2-vision-11b", "A.14")])
def test_unported_families_name_their_roadmap_item(arch, match):
    """The audio (A.13) and vision (A.14) families are ported: no
    ``NotImplementedError`` in the port names their ROADMAP item any
    more, and the family builds from a seed and runs ``forward`` with its
    frontend to finite logits of the reference's spec shapes."""
    import pathlib
    root = pathlib.Path(ttfm.__file__).resolve().parents[1]
    for path in root.rglob("*.py"):
        assert f"ROADMAP {match}" not in path.read_text(), path
    cfg, tcfg = get_config(arch, smoke=True), tget(arch, smoke=True)
    spec_t, spec_j = ttfm.model_spec(tcfg), jtfm.model_spec(cfg)
    assert spec_t["frontend_proj"]["w"].shape == \
        spec_j["frontend_proj"]["w"].shape == (cfg.frontend_dim, cfg.d_model)
    params = tcm.instantiate(spec_t, torch.Generator().manual_seed(0))
    frontend = torch.randn(1, 6, cfg.frontend_dim,
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, aux = ttfm.forward(params, tcfg,
                                   torch.zeros(1, 5, dtype=torch.long),
                                   frontend=frontend)
    assert logits.shape == (1, 5, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and float(aux) == 0.0
