"""The port's paper-§4 trainer (``core/nestedness.py``), its threefry draws
and PowerSGD (``optim/compression.py``) against the JAX package's, on the
CPU, and the theory tests (``tests/test_nestedness_theory.py``,
Theorems 4.1-4.3) on the port's own trained factors.

Exact: threefry ``split``, ``random_bits`` and the uniforms under
``normal``. Tolerances: ``normal`` 1e-5 relative plus 1e-6 absolute
(``torch.erfinv`` and XLA's differ by up to ~90 float32 ulps in the tails,
5.8e-6 relative over 2M draws); the losses 1e-6 and their gradients 1e-5
relative (float32 sums in other orders); 200 Adam steps of ``train`` 1e-5
of each factor's max (the initial normals' ulps, carried); PowerSGD's
``ghat`` and the error 1e-4 of each leaf's ghat max, ``q`` (up to each
column's sign: the QR's choice) 1e-4 of its max, after 3 steps (float32
QR of other LAPACK call paths, fed back through the error).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import nestedness as JN
from repro.optim import compression as JC
from repro_torch import bridge, threefry
from repro_torch.core import nestedness as TN
from repro_torch.models import common as tcm
from repro_torch import distributed as tdist
from repro_torch.optim import compression as TC

torch.set_num_threads(1)


def _rel(a, b) -> float:
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-12)


# -------------------------------------------------------------- threefry

@pytest.mark.parametrize("seed,n", [(0, 2), (5, 7), (123, 64)])
def test_split_matches_jax(seed, n):
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))
    assert threefry.split(threefry.prng_key(seed), n) == [
        tuple(int(w) for w in k) for k in keys]
    assert threefry.split(threefry.prng_key(seed), 2) == list(
        threefry.split2(threefry.prng_key(seed)))


@pytest.mark.parametrize("shape", [(6, 5), (1000,), (3, 4, 7), (1,)])
def test_random_bits_and_uniform_bit_exact(shape):
    key_j, key_t = jax.random.PRNGKey(5), threefry.prng_key(5)
    bits = np.asarray(jax.random.bits(key_j, shape, jnp.uint32))
    np.testing.assert_array_equal(threefry.random_bits(key_t, shape).numpy(),
                                  bits.astype(np.int64))
    lo = np.nextafter(np.float32(-1), np.float32(0))
    for a, b in ((0.0, 1.0), (float(lo), 1.0), (-3.0, 2.5)):
        u = np.asarray(jax.random.uniform(key_j, shape, minval=a, maxval=b))
        np.testing.assert_array_equal(
            threefry.uniform(key_t, shape, a, b).numpy(), u)


@pytest.mark.parametrize("seed,shape", [(0, (6, 5)), (1, (5, 5)),
                                        (7, (100_000,))])
def test_normal_matches_jax(seed, shape):
    n_j = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    n_t = threefry.normal(threefry.prng_key(seed), shape).numpy()
    assert n_t.dtype == np.float32 and n_t.shape == shape
    np.testing.assert_allclose(n_t, n_j, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------- nestedness

@pytest.fixture(scope="module")
def m_star():
    m = JN.make_target(np.random.default_rng(7), 6, 5, decay=1.2)
    np.testing.assert_array_equal(
        TN.make_target(np.random.default_rng(7), 6, 5, decay=1.2), m)
    np.testing.assert_array_equal(TN.svd_truncations(m),
                                  JN.svd_truncations(m))
    return m


@pytest.mark.parametrize("name", ["pts", "asl", "nsl"])
def test_losses_and_grads_match_jax(name):
    rng = np.random.default_rng(3)
    u, v, m = (rng.standard_normal(s).astype(np.float32)
               for s in ((6, 5), (5, 5), (6, 5)))
    fj, ft = getattr(JN, f"{name}_loss"), getattr(TN, f"{name}_loss")
    loss_j, (gu_j, gv_j) = jax.value_and_grad(
        lambda a, b: fj(JN.LinearElastic(a, b), jnp.asarray(m)),
        argnums=(0, 1))(jnp.asarray(u), jnp.asarray(v))
    ut = torch.as_tensor(u).requires_grad_(True)
    vt = torch.as_tensor(v).requires_grad_(True)
    loss_t = ft(TN.LinearElastic(ut, vt), torch.as_tensor(m))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-6)
    assert _rel(ut.grad, gu_j) < 1e-5 and _rel(vt.grad, gv_j) < 1e-5


@pytest.mark.parametrize("name", ["pts", "asl", "nsl"])
def test_train_matches_jax(m_star, name):
    """200 full-batch Adam steps from the same threefry draws."""
    pj = JN.train(getattr(JN, f"{name}_loss"), m_star, steps=200, seed=1)
    pt = TN.train(getattr(TN, f"{name}_loss"), m_star, steps=200, seed=1,
                  device="cpu")
    assert pt.u.dtype == torch.float32 and pt.u.shape == (6, 5)
    assert _rel(pt.u, pj.u) < 1e-5 and _rel(pt.v, pj.v) < 1e-5
    np.testing.assert_allclose(TN.pareto_gaps(pt, m_star),
                               JN.pareto_gaps(pj, m_star), rtol=1e-3,
                               atol=1e-6)


@pytest.fixture(scope="module")
def trained(m_star):
    return {name: TN.train(getattr(TN, f"{name}_loss"), m_star, steps=2500,
                           seed=1, device="cpu")
            for name in ("pts", "asl", "nsl")}


def _w(p):
    return (p.u @ p.v.T).numpy()


def test_all_reach_reasonable_full_fit(trained, m_star):
    # PTS/NSL reconstruct M* at full rank; ASL provably cannot (Thm B.7)
    for name in ("pts", "nsl"):
        assert np.linalg.norm(_w(trained[name]) - m_star) < 5e-2, name


def test_thm41_pts_has_positive_gap(trained, m_star):
    gaps = TN.pareto_gaps(trained["pts"], m_star)
    assert gaps[:-1].max() > 1e-3
    assert gaps[-1] < 5e-3


def test_thm42_asl_gap_lower_bound(trained, m_star):
    k = min(m_star.shape)
    sig = np.linalg.svd(m_star, compute_uv=False)
    lam = np.linalg.svd(_w(trained["asl"]), compute_uv=False).sum() / k
    gaps = TN.pareto_gaps(trained["asl"], m_star)
    for r in range(1, k + 1):
        bound = (r * lam - sig[:r].sum()) ** 2 / k
        assert gaps[r - 1] >= bound - 1e-3, (r, gaps[r - 1], bound)
    assert gaps.max() > 1e-4


def test_thm43_nsl_recovers_pareto_front(trained, m_star):
    gaps = TN.pareto_gaps(trained["nsl"], m_star)
    assert gaps.max() < 5e-3, gaps


# -------------------------------------------------------------- PowerSGD

def _grad_tree(rng):
    def n(*s):
        return rng.standard_normal(s).astype(np.float32)
    return {"a": n(64, 48), "b": n(3, 32, 40), "c": n(16), "d": n(8, 8),
            "segments": [{"w": n(40, 96)}]}


def _sign_fixed(q):
    """Each column times the sign of its largest-magnitude entry."""
    q = np.asarray(q)
    idx = np.abs(q).argmax(axis=0)
    return q * np.sign(q[idx, np.arange(q.shape[1])])


def test_powersgd_three_steps_match_jax():
    rng = np.random.default_rng(0)
    params = _grad_tree(rng)
    cfg_j = JC.PowerSGDConfig(rank=4, min_compress_size=256)
    cfg_t = TC.PowerSGDConfig(rank=4, min_compress_size=256)
    sj = JC.init(jax.tree.map(jnp.asarray, params), cfg_j, seed=3)
    st = TC.init(bridge.params_to_torch(params), cfg_t, seed=3)
    shapes = [tuple(q.shape) for q in tcm.tree_leaves(st.q)]
    assert shapes == [q.shape for q in jax.tree.leaves(sj.q)]
    # a stacked leaf is one (L, m * n) matrix
    assert (0,) in shapes and tuple(st.q["b"].shape) == (32 * 40, 4)
    for a, b in zip(tcm.tree_leaves(st.q), jax.tree.leaves(sj.q)):
        if a.numel():
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
    for _ in range(3):
        g = _grad_tree(rng)
        gj, sj, mj = JC.compress_decompress(jax.tree.map(jnp.asarray, g),
                                            sj, cfg_j)
        gt, st, mt = TC.compress_decompress(bridge.params_to_torch(g), st,
                                            cfg_t)
        assert mt == {k: int(v) if k != "powersgd_ratio" else v
                      for k, v in mj.items()}
        # ghat and the error against the leaf's gradient (with the error
        # fed back): a leaf of rank below r leaves an error of rounding
        # noise only
        for (path, a), b, e, x in zip(
                tcm.tree_items(gt), jax.tree.leaves(gj),
                tcm.tree_leaves(st.error), jax.tree.leaves(sj.error)):
            scale = float(np.abs(np.asarray(b)).max())
            assert tuple(a.shape) == b.shape, path
            assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-4 * scale
            assert tuple(e.shape) == x.shape, path
            if e.numel():
                assert np.abs(e.numpy() - np.asarray(x)).max() < \
                    1e-4 * scale, path
        for a, b in zip(tcm.tree_leaves(st.q), jax.tree.leaves(sj.q)):
            if a.numel():
                assert _rel(_sign_fixed(a.numpy()), _sign_fixed(b)) < 1e-4
    # the uncompressed leaves pass through
    assert torch.equal(gt["c"], torch.as_tensor(g["c"]))


@pytest.mark.parametrize("mesh, error", [
    (None, NameError),
    (tdist.Mesh(tdist.device_array(["cpu"], (1,)), ("model",)), NameError),
    (tdist.Mesh(tdist.device_array(["cpu"] * 2, (2, 1)), ("data", "model")),
     RuntimeError)], ids=["no mesh", "no such axis", "no group"])
def test_powersgd_over_an_axis_with_no_group_raises(mesh, error):
    """``axis_name`` names an axis of the current mesh with a process
    group over its ranks (``tests/test_torch_dist.py`` runs it across
    ranks); without a mesh, or the axis, it raises, as ``jax.lax.pmean``
    does on an unbound axis name, and so does an axis of two ranks on a
    mesh built without groups."""
    st = TC.init({"a": torch.zeros(256, 256)}, TC.PowerSGDConfig())
    with tdist.mesh_context(mesh), pytest.raises(error):
        TC.compress_decompress({"a": torch.zeros(256, 256)}, st,
                               TC.PowerSGDConfig(), axis_name="data")
