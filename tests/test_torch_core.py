"""The port's FlexRank core against the JAX package's, on the CPU: the GAR
transform, the plain-SVD decomposition, the DP profile table, the GAR
deploy and the deployed parameter count.

SVD factors are compared through their truncated reconstructions
``U_r V_r^T``, since singular vectors' signs are free.
"""
import numpy as np
import jax
import pytest
import torch

from repro.configs import get_config
from repro.core import flexrank as JFR
from repro.core import gar as jgar
from repro.models import common as jcm
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_config as tget
from repro_torch.core import flexrank as TFR
from repro_torch.core import gar as tgar

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def smoke():
    """Dense smoke params (the JAX suite's recipe), decomposed without
    moments on both sides."""
    cfg = get_config("gpt2-small", smoke=True)
    tcfg = tget("gpt2-small", smoke=True)
    dense = jcm.instantiate(jtfm.model_spec(cfg), jax.random.PRNGKey(0))
    jfact, jcurves = JFR.decompose(dense, cfg, None)
    tfact, tcurves = TFR.decompose(bridge.params_to_torch(dense), tcfg)
    return cfg, tcfg, dense, (jfact, jcurves), (tfact, tcurves)


@pytest.mark.parametrize("m,n,r", [(40, 32, 12), (24, 24, 24), (64, 16, 16),
                                   (30, 50, 1), (96, 64, 40)])
def test_gar_transform_matches_jax(m, n, r):
    rng = np.random.default_rng(m * 100 + r)
    u = rng.standard_normal((m, min(m, n))).astype(np.float32)
    v = rng.standard_normal((n, min(m, n))).astype(np.float32)
    gj = jgar.gar_transform(u, v, r)
    gt = tgar.gar_transform(torch.as_tensor(u), torch.as_tensor(v), r)
    np.testing.assert_array_equal(gt.perm.numpy(), np.asarray(gj.perm))
    np.testing.assert_allclose(gt.u_hat.numpy(), np.asarray(gj.u_hat),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gt.v_tilde.numpy(), np.asarray(gj.v_tilde),
                               rtol=1e-5, atol=1e-6)
    w_r = u[:, :r].astype(np.float64) @ v[:, :r].T.astype(np.float64)
    np.testing.assert_allclose(tgar.reconstruction(gt).numpy(), w_r,
                               rtol=1e-3, atol=1e-3)


def test_gar_transform_rank_deficient_pivots():
    """A zero column leaves a near-zero pivot: elimination skips it on both
    sides and the same rows come out."""
    rng = np.random.default_rng(2)
    u = rng.standard_normal((20, 8)).astype(np.float32)
    u[:, 3] = 0.0
    u[5] = u[2]
    v = rng.standard_normal((12, 8)).astype(np.float32)
    pj = jgar._pivot_rows(u)
    pt = tgar._pivot_rows(torch.as_tensor(u))
    np.testing.assert_array_equal(pt.numpy(), pj)


def test_decompose_matches_jax(smoke):
    cfg, tcfg, _, (jfact, jcurves), (tfact, tcurves) = smoke
    assert sorted(tcurves) == sorted(jcurves)
    for path, cj in jcurves.items():
        np.testing.assert_allclose(tcurves[path], cj, rtol=1e-4,
                                   atol=1e-4 * float(cj.max()))
    for info in TFR.group_infos(tcfg):
        uj = np.asarray(jcm.tree_get(jfact, info.path)["u"])
        vj = np.asarray(jcm.tree_get(jfact, info.path)["v"])
        leaf = TFR.cm.tree_get(tfact, info.path)
        ut, vt = leaf["u"].numpy(), leaf["v"].numpy()
        assert ut.shape == uj.shape and vt.shape == vj.shape
        for r in (1, info.full_rank // 2, info.full_rank):
            wj = uj[0, :, :r] @ vj[0, :, :r].T
            wt = ut[0, :, :r] @ vt[0, :, :r].T
            np.testing.assert_allclose(wt, wj, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(wj).max()))


def test_build_table_identical(smoke):
    """Fed the same curves, the DP gives the identical table."""
    cfg, tcfg, _, (_, jcurves), _ = smoke
    jt, jinfos = JFR.build_table(cfg, jcurves)
    tt, tinfos = TFR.build_table(tcfg, {k: v.copy()
                                        for k, v in jcurves.items()})
    np.testing.assert_array_equal(tt.table, jt.table)
    assert tt.layer_names == jt.layer_names
    assert tt.budgets == jt.budgets and tt.max_ranks == jt.max_ranks
    assert bridge.group_infos(jinfos) == tinfos


def test_gar_deploy_and_param_count(smoke):
    cfg, tcfg, _, (jfact, jcurves), _ = smoke
    jt, jinfos = JFR.build_table(cfg, jcurves)
    tt, tinfos = bridge.profile_table(jt), bridge.group_infos(jinfos)
    tfact = bridge.params_to_torch(jfact)
    for k in (0, jt.num_budgets - 1):
        jd = jax.tree.map(np.asarray,
                          JFR.gar_deploy(jfact, cfg, jinfos, jt, k))
        td = bridge.params_to_numpy(TFR.gar_deploy(tfact, tcfg, tinfos, tt,
                                                   k))
        a = jax.tree_util.tree_flatten_with_path(jd)[0]
        b = jax.tree_util.tree_flatten_with_path(td)[0]
        assert [p for p, _ in a] == [p for p, _ in b]
        for (path, x), (_, y) in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape, path
            if x.dtype == np.int32:
                np.testing.assert_array_equal(y, x)
            else:
                np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-6)
        assert TFR.deployed_param_count(tcfg, tinfos, tt, k) == \
            JFR.deployed_param_count(cfg, jinfos, jt, k)
    assert TFR.nested_prefix_row(tt, tt.num_budgets - 1, 0.5) == \
        JFR.nested_prefix_row(jt, jt.num_budgets - 1, 0.5)
    assert TFR.is_nested_prefix(tt, 0, tt.num_budgets - 1)
