"""The reference's analysis helpers in the port, against the JAX package's
on the same numpy inputs from a seed, on the CPU: the streaming second
moment (``CovarianceState``, ``accumulate``, ``collect_layer_moments``),
DataSVD's reconstructions and truncation errors, ``gar_apply`` and the
flop counts, the rank masks, ``sample_profile_index`` (bit for bit, with
and without weights), ``profile_param_cost``, ``configs.shapes_for`` and
``repro_torch.core``'s exports.

Tolerances, float32: a moment 1e-5 of its max (the same products summed in
other orders); errors and curves 1e-5 relative (a few hundred products of
one factor pair); ``gar_apply`` 1e-5 of the output's max against the
dense reconstruction and the reference, and bit for bit against the
kernel route's plain version. Masks, counts, draws and costs are exact.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro import configs as jconfigs
from repro.core import covariance as jcov
from repro.core import datasvd as jsvd
from repro.core import gar as jgar
from repro.core import profiles as jprof
from repro_torch import configs as tconfigs
from repro_torch import threefry
from repro_torch.core import covariance as tcov
from repro_torch.core import datasvd as tsvd
from repro_torch.core import gar as tgar
from repro_torch.core import profiles as tprof
from repro_torch.kernels import ops

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_accumulate_matches_jax_and_is_linear(dtype):
    """Three batches folded one by one equal the reference's fold and the
    fold of their concatenation; the count is the number of rows, and the
    moment float32 whatever the input's dtype."""
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((2, 5, 8)).astype(np.float32)
          for _ in range(3)]
    tdt = getattr(torch, dtype)
    js, ts = jcov.CovarianceState.create(8), tcov.CovarianceState.create(8)
    for x in xs:
        js = jcov.accumulate(js, jnp.asarray(x, getattr(jnp, dtype)))
        ts = tcov.accumulate(ts, torch.as_tensor(x).to(tdt))
    assert ts.moment.dtype == ts.count.dtype == torch.float32
    assert float(ts.count) == float(js.count) == 30.0
    assert _rel(ts.moment, js.moment) < 1e-5
    once = tcov.accumulate(tcov.CovarianceState.create(8), torch.cat(
        [torch.as_tensor(x).to(tdt) for x in xs]))
    assert float(once.count) == 30.0
    assert _rel(once.moment, ts.moment) < 1e-5


def test_collect_layer_moments_matches_jax():
    """A toy model of two taps: the input of a linear layer and of the
    next one, over four calibration batches."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    batches = [rng.standard_normal((3, 6)).astype(np.float32)
               for _ in range(4)]
    taps = {"in": 6, "hidden": 4}

    def j_apply(p, x):
        h = jnp.tanh(x @ p["w"])
        return h, {"in": x, "hidden": h}

    def t_apply(p, x):
        h = torch.tanh(x @ p["w"])
        return h, {"in": x, "hidden": h}
    js = jcov.collect_layer_moments(j_apply, {"w": jnp.asarray(w)},
                                    [jnp.asarray(b) for b in batches], taps)
    ts = tcov.collect_layer_moments(t_apply, {"w": _t(w)},
                                    [_t(b) for b in batches], taps)
    assert sorted(ts) == sorted(js)
    for k in taps:
        assert float(ts[k].count) == float(js[k].count) == 12.0
        assert ts[k].moment.shape == (taps[k], taps[k])
        assert _rel(ts[k].moment, js[k].moment) < 1e-5
    empty = tcov.collect_layer_moments(t_apply, {"w": _t(w)}, [], taps)
    assert float(empty["in"].count) == 0.0 and not empty["in"].moment.any()


def _factors(m, n, seed):
    """A weight (m, n), a calibration moment and the reference's DataSVD
    factors of them, with the same factors as torch tensors."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((m, n)).astype(np.float32)
    x = rng.standard_normal((64, n)).astype(np.float32) * np.linspace(
        0.2, 2.0, n, dtype=np.float32)
    moment = (x.T @ x).astype(np.float32)
    jf = jsvd.datasvd_factors(jnp.asarray(w), jnp.asarray(moment), 64.0)
    tf = tsvd.Factors(u=_t(jf.u), v=_t(jf.v))
    return w, moment, jf, tf


@pytest.mark.parametrize("with_moment", [True, False])
def test_reconstruction_error_and_curve_match_jax(with_moment):
    """On the same factor pair: ``reconstruct`` at every rank,
    ``reconstruction_error`` at ranks 1, 3 and full, and the whole
    truncation curve (the Gram branch without a moment)."""
    w, moment, jf, tf = _factors(12, 9, 2)
    mom_j = jnp.asarray(moment) if with_moment else None
    mom_t = _t(moment) if with_moment else None
    assert _rel(tf.reconstruct(), jf.reconstruct()) < 1e-6
    for r in (1, 3, tf.rank):
        assert _rel(tf.reconstruct(r), jf.reconstruct(r)) < 1e-6
        assert _rel(tsvd.reconstruction_error(_t(w), tf, r, mom_t),
                    jsvd.reconstruction_error(jnp.asarray(w), jf, r,
                                              mom_j)) < 1e-5
    curve_t = tsvd.truncation_error_curve(_t(w), tf, mom_t)
    curve_j = jsvd.truncation_error_curve(jnp.asarray(w), jf, mom_j)
    assert curve_t.shape == (tf.rank,)
    assert _rel(curve_t, curve_j) < 1e-5


def test_port_datasvd_maps_the_reference_call():
    """``datasvd_factors(w, sqrt_and_inv_sqrt(moment, count))`` is the
    reference's ``datasvd_factors(w, moment, count)``: the same truncated
    reconstructions and data-weighted errors (the factors agree up to the
    signs of their columns)."""
    w, moment, jf, _ = _factors(10, 7, 3)
    tf = tsvd.datasvd_factors(_t(w), tcov.sqrt_and_inv_sqrt(_t(moment),
                                                            64.0))
    for r in (2, 5, 7):
        assert _rel(tf.reconstruct(r), jf.reconstruct(r)) < 1e-4
    assert _rel(tsvd.truncation_error_curve(_t(w), tf, _t(moment)),
                jsvd.truncation_error_curve(jnp.asarray(w), jf,
                                            jnp.asarray(moment))) < 1e-4


@pytest.mark.parametrize("m, n, r", [(24, 16, 5), (16, 16, 16)])
def test_gar_apply_matches_reconstruction_kernel_route_and_jax(m, n, r):
    rng = np.random.default_rng(m + r)
    u = torch.as_tensor(rng.standard_normal((m, n)).astype(np.float32))
    v = torch.as_tensor(rng.standard_normal((n, n)).astype(np.float32))
    g = tgar.gar_transform(u, v, r)
    x = torch.as_tensor(rng.standard_normal((3, 4, n)).astype(np.float32))
    y = tgar.gar_apply(g, x)
    assert y.shape == (3, 4, m)
    assert _rel(y, x @ tgar.reconstruction(g).T) < 1e-5
    assert torch.equal(y, ops.gar_forward(x, g.v_tilde, g.u_hat,
                                          torch.argsort(g.perm)))
    jg = jgar.GarFactors(u_hat=jnp.asarray(g.u_hat.numpy()),
                         v_tilde=jnp.asarray(g.v_tilde.numpy()),
                         perm=jnp.asarray(g.perm.numpy(), jnp.int32))
    assert _rel(y, jgar.gar_apply(jg, jnp.asarray(x.numpy()))) < 1e-5


@pytest.mark.parametrize("m, n, r, tokens", [
    (768, 3072, 410, 1), (21504, 5376, 2151, 264), (8192, 5120, 5120, 8)])
def test_flop_counts_match_jax(m, n, r, tokens):
    assert tgar.gar_flops(m, n, r, tokens) == jgar.gar_flops(m, n, r, tokens)
    assert tgar.lowrank_flops(m, n, r, tokens) == jgar.lowrank_flops(
        m, n, r, tokens)
    assert tgar.dense_flops(m, n, tokens) == jgar.dense_flops(m, n, tokens)
    assert tgar.gar_flops(m, n, r) < tgar.lowrank_flops(m, n, r)


def _table(seed=4):
    rng = np.random.default_rng(seed)
    max_ranks = [8, 5, 12]
    t = np.sort(rng.integers(1, 6, (4, 3)), axis=0).astype(np.int32)
    names = ("a", "b", "c")
    return (jprof.ProfileTable(names, t, (0.2, 0.4, 0.7, 1.0), tuple(
        max_ranks)), tprof.ProfileTable(names, t, (0.2, 0.4, 0.7, 1.0),
                                        tuple(max_ranks)), max_ranks)


def test_rank_masks_and_slices_match_jax():
    jt, tt, max_ranks = _table()
    for rank in (0, 3, 8):
        assert np.array_equal(tprof.rank_mask(rank, 8).numpy(),
                              np.asarray(jprof.rank_mask(rank, 8)))
    assert tprof.rank_mask(torch.tensor(2), 4, dtype=torch.int32).tolist() \
        == [1, 1, 0, 0]
    table_t = torch.as_tensor(tt.table)
    for k in range(tt.num_budgets):
        for kk in (k, torch.tensor(k)):
            got = tprof.masks_for_index(table_t, kk, max_ranks)
            want = jprof.masks_for_index(jnp.asarray(jt.table), k, max_ranks)
            assert [g.shape[0] for g in got] == max_ranks
            for g, w in zip(got, want):
                assert np.array_equal(g.numpy(), np.asarray(w))
    u, v = torch.ones(2, 6, 5), torch.ones(2, 4, 5)
    su, sv = tprof.rank_slice(u, v, 3)
    ju, jv = jprof.rank_slice(jnp.ones((2, 6, 5)), jnp.ones((2, 4, 5)), 3)
    assert su.shape == ju.shape and sv.shape == jv.shape


def test_profile_param_cost_matches_jax():
    jt, tt, _ = _table(5)
    costs = [300.0, 128.0, 1536.5]
    got = tprof.profile_param_cost(tt, costs)
    assert got.dtype == np.float64
    assert np.array_equal(got, jprof.profile_param_cost(jt, costs))


@pytest.mark.parametrize("weights", [
    None, (1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0),
    (0.1, 0.0, 0.3, 0.05, 0.0, 0.25, 0.3), (1e-3, 5.0, 1e-3, 1e-3, 2.0,
                                             1e-3, 0.7)])
def test_sample_profile_index_bit_for_bit(weights):
    """300 keys, as the consolidation loop forms them (``fold_in`` of the
    seed's key by the step), every draw equal to the reference's."""
    draw = jax.jit(lambda key: jprof.sample_profile_index(key, 7, weights))
    seen = set()
    for step in range(300):
        seed = step % 3
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        tk = threefry.fold_in(threefry.prng_key(seed), step)
        got = tprof.sample_profile_index(tk, 7, weights)
        assert got == int(draw(jk)), step
        seen.add(got)
    if weights is not None:
        assert not seen & {i for i, w in enumerate(weights) if w == 0.0}
    assert len(seen) >= 3
    with pytest.raises(ValueError):
        tprof.sample_profile_index(threefry.prng_key(0), 6, (1.0,) * 7)


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_shapes_for_matches_jax(arch):
    got = tconfigs.shapes_for(arch)
    want = jconfigs.shapes_for(arch)
    assert [(s.name, s.seq_len, s.global_batch, s.kind) for s in got] == [
        (s.name, s.seq_len, s.global_batch, s.kind) for s in want]


def test_core_exports_match_jax():
    assert tcore.__all__ == jcore.__all__
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None
