"""The plain PyTorch versions of the port's kernels against the JAX
package's oracles (``repro.kernels.ref``), over the shape sweeps of
``tests/test_kernels.py``, and the port's ``ops`` dispatch on CPU tensors.

The CUDA kernels themselves are held against these plain versions on the
card (``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``).
Tolerances: float32 attention 2e-5 absolute (two softmax implementations
summing in different orders); GAR and the low-rank linear 2e-4 relative to
the output's max (two matmul libraries), and their gradients the same
relative to each gradient's max; sampled tokens identical and warped probs
1e-5.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

RNG = np.random.default_rng(0)


def _np(*s):
    return RNG.standard_normal(s).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.as_tensor(a)


# ------------------------------------------------------------------- GAR

GAR_SHAPES = [(64, 32, 48, 16), (100, 96, 80, 40), (33, 17, 29, 7),
              (256, 128, 128, 128), (9, 40, 24, 24)]   # last two: m - r = 0


@pytest.mark.parametrize("t,n,m,r", GAR_SHAPES)
def test_gar_plain_matches_jax(t, n, m, r):
    x, v, u = _np(t, n), _np(n, r), _np(m - r, r)
    perm_inv = RNG.permutation(m).astype(np.int32)
    y_j = np.asarray(jops.gar_forward(*map(jnp.asarray, (x, v, u, perm_inv))))
    y_t = ops.gar_forward(*map(torch.as_tensor, (x, v, u)),
                          torch.as_tensor(perm_inv.astype(np.int64))).numpy()
    scale = float(np.abs(y_j).max()) + 1e-6
    assert float(np.abs(y_t - y_j).max()) / scale < 2e-4
    z_j, tail_j = jref.gar_matmul_ref(*map(jnp.asarray, (x, v, u)))
    z_t, tail_t = ref.gar_matmul_ref(*map(torch.as_tensor, (x, v, u)))
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=2e-4,
                               atol=2e-4 * scale)
    assert tail_t.shape == tuple(tail_j.shape)


def test_gar_leading_dims_and_full_rank():
    """(B, S, n) inputs and the degenerate full-rank form (empty u_hat)."""
    x = _np(2, 5, 12)
    v = _np(12, 12)
    perm_inv = RNG.permutation(12)
    u = np.zeros((0, 12), np.float32)
    y_t = ops.gar_forward(torch.as_tensor(x), torch.as_tensor(v),
                          torch.as_tensor(u), torch.as_tensor(perm_inv))
    y_j = jops.gar_forward(jnp.asarray(x), jnp.asarray(v), jnp.asarray(u),
                           jnp.asarray(perm_inv.astype(np.int32)))
    assert y_t.shape == (2, 5, 12)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=2e-4,
                               atol=1e-5)


# ---------------------------------------------------------- low-rank linear

LOWRANK_SHAPES = [(64, 32, 48, 16), (70, 64, 96, 48)]   # tests/test_kernels.py


def _rel_err(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max()) / (
        float(np.abs(b).max()) + 1e-6)


@pytest.mark.parametrize("t,n,m,r", LOWRANK_SHAPES)
@pytest.mark.parametrize("rank", [0, 1, "mid", "full", None])
def test_lowrank_plain_matches_jax(t, n, m, r, rank):
    """The plain version against the JAX oracle and the Pallas kernel in
    interpret mode; ``ops.lowrank_forward`` on (B, S, n) inputs too."""
    rk = {"mid": r // 2, "full": r}.get(rank, rank)
    x, v, u = _np(t, n), _np(n, r), _np(m, r)
    y_t = ref.lowrank_matmul_ref(*map(torch.as_tensor, (x, v, u)), rk)
    y_oracle = jref.lowrank_matmul_ref(*map(jnp.asarray, (x, v, u)), rk)
    y_pallas = jops.lowrank_forward(*map(jnp.asarray, (x, v, u)), rk,
                                    use_pallas="interpret", bt=16, br=16)
    assert _rel_err(y_t.numpy(), y_oracle) < 2e-4
    assert _rel_err(y_t.numpy(), y_pallas) < 2e-4
    y_ops = ops.lowrank_forward(torch.as_tensor(x.reshape(2, t // 2, n)),
                                torch.as_tensor(v), torch.as_tensor(u), rk)
    assert y_ops.shape == (2, t // 2, m)
    np.testing.assert_array_equal(y_ops.reshape(t, m).numpy(), y_t.numpy())
    if rk == 0:
        assert not y_t.any()


@pytest.mark.parametrize("rank", [0, 5, 48, None])
def test_lowrank_gradients_match_jax(rank):
    """dx, dv, du of the port's autograd function (the plain masked
    products) against ``jax.grad`` of the reference's masked branch."""
    t, n, m, r = 70, 64, 96, 48
    x, v, u, dy = _np(t, n), _np(n, r), _np(m, r), _np(t, m)

    def f(x, v, u):
        return jnp.sum(jref.lowrank_matmul_ref(x, v, u, rank) * dy)

    g_j = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (x, v, u)))
    xs = [torch.tensor(a, requires_grad=True) for a in (x, v, u)]
    ops.lowrank_forward(*xs, rank).backward(torch.as_tensor(dy))
    for name, a, b in zip(("dx", "dv", "du"), xs, g_j):
        assert _rel_err(a.grad.numpy(), b) < 2e-4, name
    if rank is not None and rank < r:
        assert not xs[1].grad[:, rank:].any()
        assert not xs[2].grad[:, rank:].any()


# -------------------------------------------------------- paged attention

PAGED_GEOMS = [(4, 4, 16, 4, 3), (8, 2, 32, 8, 4), (5, 5, 24, 3, 4),
               (6, 3, 20, 5, 2), (2, 1, 8, 16, 2), (12, 4, 40, 7, 3),
               (12, 12, 64, 16, 4)]


def _pools(b, hkv, d, bs, mb, null_row=True):
    nb = b * mb + 1
    kp, vp = _np(nb, bs, hkv, d), _np(nb, bs, hkv, d)
    tables = 1 + RNG.permutation(b * mb).reshape(b, mb)
    if null_row:
        tables = np.concatenate([tables, np.zeros((1, mb), np.int64)])
    return kp, vp, tables.astype(np.int32)


@pytest.mark.parametrize("hq,hkv,d,bs,mb", PAGED_GEOMS)
@pytest.mark.parametrize("softcap", [0.0, 20.0])
def test_paged_prefill_plain_matches_jax(hq, hkv, d, bs, mb, softcap):
    """Flat tokens mixing runs and singletons across slots, pads pointed at
    the null row with context 1."""
    b, t = 3, 10
    kp, vp, tables = _pools(b, hkv, d, bs, mb)
    q = _np(t, hq, d)
    sid = RNG.integers(0, b + 1, size=t).astype(np.int32)
    lens = RNG.integers(1, mb * bs + 1, size=t).astype(np.int32)
    lens[sid == b] = 1
    args = (q, kp, vp, tables, sid, lens)
    y_j = jref.paged_prefill_attention_ref(*map(jnp.asarray, args),
                                           softcap=softcap)
    y_t = ops.paged_prefill_attention_forward(*map(torch.as_tensor, args),
                                              softcap=softcap)
    assert float(np.abs(y_t.numpy() - np.asarray(y_j)).max()) < 2e-5


@pytest.mark.parametrize("hq,hkv,d,bs,mb", PAGED_GEOMS[:4])
@pytest.mark.parametrize("window", [None, 5])
def test_paged_decode_plain_matches_jax(hq, hkv, d, bs, mb, window):
    b = 3
    kp, vp, tables = _pools(b, hkv, d, bs, mb, null_row=False)
    q = _np(b, hq, d)
    lens = RNG.integers(1, mb * bs + 1, size=b).astype(np.int32)
    args = (q, kp, vp, tables, lens)
    y_j = jref.paged_attention_ref(*map(jnp.asarray, args), window=window)
    y_t = ref.paged_attention_ref(*map(torch.as_tensor, args), window=window)
    assert float(np.abs(y_t.numpy() - np.asarray(y_j)).max()) < 2e-5


def test_paged_prefill_intra_chunk_causality():
    """Scribbling past each token's context changes nothing before it."""
    b, hq, hkv, d, bs, mb = 1, 4, 2, 16, 4, 3
    kp, vp, tables = _pools(b, hkv, d, bs, mb, null_row=False)
    q = torch.as_tensor(_np(6, hq, d))
    sid = torch.zeros(6, dtype=torch.int32)
    lens = torch.arange(4, 10, dtype=torch.int32)
    kt, vt, tt = map(torch.as_tensor, (kp, vp, tables))
    y1 = ops.paged_prefill_attention_forward(q, kt, vt, tt, sid, lens)
    blk = int(tables[0, 2])
    kt2, vt2 = kt.clone(), vt.clone()
    kt2[blk, 1:] = 99.0
    vt2[blk, 1:] = -99.0
    y2 = ops.paged_prefill_attention_forward(q, kt2, vt2, tt, sid, lens)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-6)


def test_paged_prefill_window_on_cpu_matches_jax():
    """On a CPU tensor the plain version applies ``window``; the reduction
    of prefill to decode with slot_ids = arange holds."""
    b, hq, hkv, d, bs, mb = 2, 8, 4, 16, 4, 4
    kp, vp, tables = _pools(b, hkv, d, bs, mb, null_row=False)
    q = _np(b, hq, d)
    lens = np.asarray([7, 13], np.int32)
    sid = np.arange(b, dtype=np.int32)
    args = (q, kp, vp, tables, sid, lens)
    for window in (None, 5):
        y_t = ops.paged_prefill_attention_forward(
            *map(torch.as_tensor, args), window=window)
        y_d = ref.paged_attention_ref(*map(torch.as_tensor,
                                           (q, kp, vp, tables, lens)),
                                      window=window)
        np.testing.assert_array_equal(y_t.numpy(), y_d.numpy())
        y_j = jref.paged_prefill_attention_ref(*map(jnp.asarray, args),
                                               window=window)
        assert float(np.abs(y_t.numpy() - np.asarray(y_j)).max()) < 2e-5


# --------------------------------------------------------------- sampling

def _sampling_case(s, v, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((s, v)) * 3).astype(np.float32)
    temps = np.where(rng.random(s) < 0.3, 0.0,
                     rng.uniform(0.2, 2.5, s)).astype(np.float32)
    topks = np.where(rng.random(s) < 0.5, 0,
                     rng.integers(1, v + 1, s)).astype(np.int32)
    u = rng.random(s).astype(np.float32)
    return logits, temps, topks, u


@pytest.mark.parametrize("s,v", [(6, 300), (9, 515), (3, 64), (12, 1000),
                                 (4, 2051)])
def test_sampling_plain_matches_jax(s, v):
    logits, temps, topks, u = _sampling_case(s, v, s * 1000 + v)
    zj = jnp.asarray(logits) / jnp.maximum(jnp.asarray(temps), 1e-30)[:, None]
    zt = torch.as_tensor(logits) / torch.clamp(torch.as_tensor(temps),
                                               min=1e-30)[:, None]
    thr_j = jref.topk_threshold_ref(zj, jnp.asarray(topks))
    thr_t = ref.topk_threshold_ref(zt, torch.as_tensor(topks))
    np.testing.assert_array_equal(thr_t.numpy(), np.asarray(thr_j))
    p_j = jref.warp_probs_ref(jnp.asarray(logits), jnp.asarray(temps), thr_j)
    p_t = ref.warp_probs_ref(torch.as_tensor(logits), torch.as_tensor(temps),
                             thr_t)
    assert float(np.abs(p_t.numpy() - np.asarray(p_j)).max()) < 1e-5
    w = np.abs(logits)
    np.testing.assert_array_equal(
        ref.sample_cdf_ref(torch.as_tensor(w), torch.as_tensor(u)).numpy(),
        np.asarray(jref.sample_cdf_ref(jnp.asarray(w), jnp.asarray(u))))
    for thr in (None, "topk"):
        tj, tt = (None, None) if thr is None else (thr_j, thr_t)
        t_j, pr_j = jref.topk_mask_sample_ref(
            jnp.asarray(logits), jnp.asarray(temps), tj, jnp.asarray(u))
        t_t, pr_t = ref.topk_mask_sample_ref(
            torch.as_tensor(logits), torch.as_tensor(temps), tt,
            torch.as_tensor(u))
        np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
        assert float(np.abs(pr_t.numpy() - np.asarray(pr_j)).max()) < 1e-5
        t_only, none = ref.topk_mask_sample_ref(
            torch.as_tensor(logits), torch.as_tensor(temps), tt,
            torch.as_tensor(u), return_probs=False)
        assert none is None
        np.testing.assert_array_equal(t_only.numpy(), t_t.numpy())


@pytest.mark.parametrize("with_topk", [False, True])
@pytest.mark.parametrize("return_probs", [False, True])
def test_sampling_dispatch_matches_jax(with_topk, return_probs):
    """ops dispatch on CPU tensors, threshold sort included (or skipped
    when ``top_k`` is None), against the JAX dispatch's oracle path."""
    logits, temps, topks, u = _sampling_case(10, 123, 7)
    k_j = jnp.asarray(topks) if with_topk else None
    k_t = torch.as_tensor(topks) if with_topk else None
    out_j = jops.topk_mask_sample_forward(
        jnp.asarray(logits), jnp.asarray(temps), k_j, jnp.asarray(u),
        return_probs=return_probs)
    out_t = ops.topk_mask_sample_forward(
        torch.as_tensor(logits), torch.as_tensor(temps), k_t,
        torch.as_tensor(u), return_probs=return_probs)
    if return_probs:
        np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
        assert float(np.abs(out_t[1].numpy()
                            - np.asarray(out_j[1])).max()) < 1e-5
    else:
        assert out_t.dtype == torch.int32
        np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch on CUDA tensors only; ``ops`` never hands
    them a CPU tensor (the plain version takes those)."""
    from repro_torch.kernels import (gar_matmul, lowrank_matmul,
                                     paged_attention, sampling)
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        gar_matmul.gar_matmul(x, torch.zeros(8, 8), torch.zeros(0, 8),
                              torch.arange(8))
    with pytest.raises(ValueError, match="CUDA"):
        lowrank_matmul.lowrank_matmul(x, torch.zeros(8, 4),
                                      torch.zeros(6, 4), 2)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention.paged_prefill_attention(
            torch.zeros(1, 1, 4), torch.zeros(2, 2, 1, 4),
            torch.zeros(2, 2, 1, 4), torch.zeros(1, 1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        sampling.topk_mask_sample(torch.zeros(1, 4), torch.zeros(1),
                                  torch.zeros(1), torch.zeros(1))
    counts = (gar_matmul.launches, lowrank_matmul.launches,
              paged_attention.launches, sampling.launches)
    assert counts == (0, 0, 0, 0)
