"""The split designs of the sampling and WKV6 kernels, on the CPU.

``kernels/sampling.py:split_layout`` sizes the sampling kernels' grid and
scratch: a row of V entries is cut into ``nb`` blocks of ``bv = min(1024,
V)`` (the reference's two-level draw) and split ``i`` holds blocks ``[i *
per, (i + 1) * per)``. Here every block must lie in exactly one split, and a
float32 PyTorch emulation of the three launches of ``csrc/sampling.cu``
(split maxima, block sums in the kernel's tree order, the two-level draw on
a block-wide scan) must give the tokens of the port's plain version and of
the JAX package's Pallas kernel in interpret mode, with probs within
``TOL_PROBS``. A like emulation of ``csrc/wkv6.cu``'s lane split (8 lanes
a group of 4 state columns, 8 rows by 4 columns a lane, the columns halved
over the lanes at xor 4 and 2 and summed at xor 1) must stay within
``TOL_RECUR_SEQ`` of the sequential recurrence and of the Pallas ``wkv6``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.sampling import topk_mask_sample as pallas_sample
from repro_torch.kernels import ref
from repro_torch.kernels import sampling as sk

torch.set_num_threads(1)

TOL_PROBS = 1e-5               # warped probs, absolute; tokens identical
# WKV6 against the sequential recurrence, relative to the output's max
TOL_RECUR_SEQ = 2e-5
NT = 256                       # threads a block of the sampling kernels


# ------------------------------------------------------------ split layout

@pytest.mark.parametrize("v", [64, 515, 1024, 1025, 50257, 262144])
@pytest.mark.parametrize("s", [1, 8, 64, 300])
def test_every_block_in_exactly_one_split(s, v):
    bv, nb, per, splits = sk.split_layout(s, v)
    assert bv == min(sk.BLOCK, v)
    assert nb * bv >= v > (nb - 1) * bv
    assert 1 <= per <= sk.MAX_SPLIT_BLOCKS
    count = np.zeros(nb, np.int64)
    for i in range(splits):
        lo, hi = i * per, min(nb, (i + 1) * per)
        assert lo < hi, (i, lo, hi)     # no split is empty
        count[lo:hi] += 1
    np.testing.assert_array_equal(count, np.ones(nb, np.int64))


@pytest.mark.parametrize("v", [50257, 262144])
def test_split_layout_covers_the_card_at_s8(v):
    """At the serving shapes (S 8) a launch has blocks for every one of the
    H100's 132 SMs, at least twice over."""
    _, _, _, splits = sk.split_layout(8, v)
    assert 8 * splits >= 2 * 132


def test_split_layout_at_gemma_vocab():
    """S 8, V 262144: 256 blocks in 64 splits of 4, 512 blocks a launch."""
    assert sk.split_layout(8, 262144) == (1024, 256, 4, 64)


def test_split_layout_refuses_empty_rows():
    with pytest.raises(ValueError):
        sk.split_layout(1, 0)


# ---------------------------------------------------- sampling emulation

def _butterfly(x, dim_size):
    """An xor-butterfly add over the last axis (lanes), as the warps run
    it: lane l adds lane l ^ o for o = size / 2, ..., 1; lane 0's value."""
    o = dim_size // 2
    while o:
        x = x[..., :o] + x[..., o:2 * o]
        o //= 2
    return x[..., 0]


def _hillis_steele(x, width):
    """Inclusive scan over the last axis by shfl_up adds of 1, 2, 4, ..."""
    o = 1
    while o < width:
        y = x.clone()
        y[..., o:] = x[..., o:] + x[..., :-o]
        x = y
        o *= 2
    return x


def _excl_scan(x):
    """``block_excl_scan`` over the 256 threads (last axis): Hillis-Steele
    in each warp and over the 8 warps' totals, then warp + lane offset."""
    lead = x.shape[:-1]
    incl = _hillis_steele(x.reshape(*lead, NT // 32, 32), 32)
    warps = _hillis_steele(incl[..., 31], NT // 32)
    zero = torch.zeros(*lead, 1)
    warp_excl = torch.cat([zero, warps[..., :-1]], -1)
    lane_excl = torch.cat([torch.zeros(*lead, NT // 32, 1),
                           incl[..., :-1]], -1)
    return (warp_excl[..., None] + lane_excl).reshape(*lead, NT)


def _merge_arg(a, b):
    return b if b[0] > a[0] or (b[0] == a[0] and b[1] < a[1]) else a


def emulate_sample(logits, temp, thr, u, return_probs=False):
    """The three launches of ``csrc/sampling.cu`` in float32: split maxima,
    per-block sums (4 entries a thread in order, an xor butterfly over a
    warp's lanes, the 8 warps in order), then the draw: each thread's run of
    block sums on an exclusive scan, the crossing block, one scan of its
    entries on top of the previous prefix."""
    s, v = logits.shape
    bv, nb, per, splits = sk.split_layout(s, v)
    blocks = torch.zeros(s, nb, 4 * NT)
    valid = torch.zeros(nb, 4 * NT, dtype=torch.bool)
    pos = torch.arange(nb)[:, None] * bv + torch.arange(4 * NT)[None, :]
    valid[:, :bv] = (pos < v)[:, :bv]
    blocks[:, valid] = logits.float()
    t = torch.clamp(temp, min=1e-30)
    z = blocks / t[:, None, None]
    kept = valid & (z >= thr[:, None, None])
    tokens = torch.empty(s, dtype=torch.int32)
    probs = torch.empty(s, v) if return_probs else None
    for i in range(s):
        parts = []
        for sp in range(splits):                 # max_kernel
            b0, b1 = sp * per, min(nb, (sp + 1) * per)
            xv = torch.where(valid[b0:b1], blocks[i, b0:b1],
                             torch.tensor(-math.inf))
            flat = int(torch.argmax(xv))
            best = (float(xv.flatten()[flat]),
                    int(pos[b0:b1].flatten()[flat]))
            zk = z[i, b0:b1][kept[i, b0:b1]]
            parts.append((best, float(zk.max()) if zk.numel() else -math.inf))
        best = (-math.inf, 2**31 - 1)
        for part, _ in parts:
            best = _merge_arg(best, part)
        zmax = torch.tensor(max(zm for _, zm in parts), dtype=torch.float32)
        if not temp[i] > 0:
            tokens[i] = best[1]
            if return_probs:
                probs[i] = 0.0
                probs[i, best[1]] = 1.0
            continue
        e = torch.where(kept[i], torch.exp(z[i] - zmax), torch.zeros(()))
        run = e.reshape(nb, NT, 4)                 # sums_kernel
        thread = ((run[..., 0] + run[..., 1]) + run[..., 2]) + run[..., 3]
        warp = _butterfly(thread.reshape(nb, NT // 32, 32), 32)
        bsum = warp[:, 0]
        for w in range(1, NT // 32):
            bsum = bsum + warp[:, w]
        c = -(-nb // NT)                           # draw_kernel
        own = torch.zeros(NT * c)
        own[:nb] = bsum
        own = own.reshape(NT, c)
        tot = own[:, 0]
        for j in range(1, c):
            tot = tot + own[:, j]
        run = _excl_scan(tot)
        cum = torch.empty(NT, c)
        for j in range(c):
            run = run + own[:, j]
            cum[:, j] = run
        cum = cum.reshape(-1)[:nb]
        total = cum[-1]
        target = u[i].float() * total
        blk = min(int((cum <= target).sum()), nb - 1)
        carry = cum[blk - 1] if blk > 0 else torch.zeros(())
        eb = e[blk].reshape(NT, 4)
        incl = torch.empty(NT, 4)
        a = eb[:, 0]
        incl[:, 0] = a
        for q in range(1, 4):
            a = a + eb[:, q]
            incl[:, q] = a
        base = carry + _excl_scan(a)
        cs = base[:, None] + incl
        n = int(((cs <= target) & valid[blk].reshape(NT, 4)).sum())
        tokens[i] = min(blk * bv + n, v - 1)
        if return_probs:
            probs[i] = e[valid] / total
    return tokens, probs


def _draw_case(s, v, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((s, v)) * 3).astype(np.float32)
    temps = np.where(rng.random(s) < 0.3, 0.0,
                     rng.uniform(0.2, 2.5, s)).astype(np.float32)
    topk = np.where(rng.random(s) < 0.5, 0,
                    rng.integers(1, min(v, 64) + 1, s)).astype(np.int64)
    u = rng.random(s).astype(np.float32)
    return logits, temps, topk, u


def _threshold(logits, temps, topk):
    z = logits / np.maximum(temps, 1e-30)[:, None]
    return ref.topk_threshold_ref(torch.as_tensor(z),
                                  torch.as_tensor(topk)).numpy()


def _check_all_three(logits, temps, thr, u, *, pallas=True):
    """Tokens of the emulation equal the plain version's and the Pallas
    kernel's (interpret mode), with and without probs; probs within
    TOL_PROBS of the plain version's."""
    args = [torch.as_tensor(a) for a in (logits, temps, thr, u)]
    t_e, p_e = emulate_sample(*args, return_probs=True)
    t_r, p_r = ref.topk_mask_sample_ref(*args, return_probs=True)
    np.testing.assert_array_equal(t_e.numpy(), t_r.numpy())
    assert float((p_e - p_r).abs().max()) < TOL_PROBS
    t_only, none = emulate_sample(*args)
    assert none is None
    np.testing.assert_array_equal(t_only.numpy(), t_r.numpy())
    if pallas:
        t_p = pallas_sample(*map(jnp.asarray, (logits, temps, thr, u)),
                            interpret=True)
        np.testing.assert_array_equal(t_e.numpy(), np.asarray(t_p))
    return t_e


@pytest.mark.parametrize("s,v", [(8, 1025), (9, 515), (3, 64), (4, 5000),
                                 (2, 50257)])
def test_emulation_matches_plain_and_pallas(s, v):
    logits, temps, topk, u = _draw_case(s, v, s * 1000 + v)
    for thr in (np.full(s, -np.inf, np.float32),
                _threshold(logits, temps, topk)):
        _check_all_three(logits, temps, thr, u)


def test_emulation_matches_plain_at_gemma_vocab():
    """V 262144 (gemma3's vocabulary), 256 blocks in 64 splits; sampled
    rows of top-k 40 and none."""
    logits, _, _, u = _draw_case(2, 262144, 11)
    temps = np.array([0.8, 1.3], np.float32)
    thr = _threshold(logits, temps, np.array([40, 0]))
    _check_all_three(logits, temps, thr, u, pallas=False)


@pytest.mark.parametrize("v", [1025, 5000])
def test_argmax_ties_across_a_split_edge(v):
    """Greedy rows whose max sits on both sides of a split edge, and on two
    entries of one split and one of the next: the first occurrence wins.
    At these sizes every split is one 1024-block."""
    _, _, per, _ = sk.split_layout(4, v)
    edge = per * sk.BLOCK
    rng = np.random.default_rng(v)
    logits = rng.standard_normal((4, v)).astype(np.float32)
    logits[0, [edge - 1, edge]] = 9.0
    logits[1, [edge, v - 1]] = 9.0
    logits[2, [3, edge - 5, edge]] = 9.0
    logits[3, :] = 2.0                          # a flat row: index 0
    temps = np.zeros(4, np.float32)
    thr = np.full(4, -np.inf, np.float32)
    u = rng.random(4).astype(np.float32)
    t = _check_all_three(logits, temps, thr, u)
    assert t.tolist() == [edge - 1, edge, 3, 0]


def test_top_k_one_and_threshold_ties():
    """Top-k 1 draws the argmax whatever u is; rows where more entries tie
    at the threshold than top-k asks keep every tied entry."""
    v = 3000
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((6, v)).astype(np.float32)
    logits[2:4, [7, 100, 1500, 2048, 2999]] = 8.0   # five ties at top-k 3
    logits[4:, [10, 1030]] = 9.0                # a tie at top-k 1
    temps = np.full(6, 0.7, np.float32)
    topk = np.array([1, 1, 3, 3, 1, 1])
    u = np.array([0.0, 0.999, 0.1, 0.9, 0.3, 0.7], np.float32)
    thr = _threshold(logits, temps, topk)
    t = _check_all_three(logits, temps, thr, u)
    am = logits.argmax(-1)
    assert t[0] == am[0] and t[1] == am[1]
    assert t[2] == 7 and t[3] == 2999           # first and last tied entry
    assert t[4] == 10 and t[5] == 1030


def test_uniforms_at_the_ends():
    """u = 0 draws the first kept entry; u = 1 - 2^-24 the last. Rows 0-3
    keep tied entries only, so every weight is exactly 1 and every sum
    exact: there the last entry's running sum lies above u * total in any
    summation order (with rounded weights two orders may put it on either
    side of a target one ulp below the total). Rows 4-5 draw at u = 0 from
    rounded weights (a sum of positive weights is never 0)."""
    v = 2500
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, v)).astype(np.float32)
    ties = [5, 1023, 1024, 2047, 2499]
    logits[:4, ties] = 6.0
    temps = np.array([0.5, 0.5, 1.0, 1.0, 0.9, 2.0], np.float32)
    topk = np.array([3, 3, 2, 2, 0, 40])
    one_less = np.float32(1 - 2.0**-24)
    u = np.array([0.0, one_less, 0.0, one_less, 0.0, 0.0], np.float32)
    thr = _threshold(logits, temps, topk)
    t = _check_all_three(logits, temps, thr, u)
    assert t[:4].tolist() == [5, 2499, 5, 2499]
    z = logits[4:] / temps[4:, None]
    assert t[4] == 0 and t[5] == int(np.flatnonzero(z[1] >= thr[5])[0])


# ------------------------------------------------------- WKV6 emulation

def _fma(a, b, c):
    """float32 fused multiply-add through float64 (exact product)."""
    return (a.double() * b.double() + c.double()).float()


LANES = 8                      # lanes a group of 4 state columns
# rows of lane g: 4g..4g+3 and 32+4g..32+4g+3
ROWS = torch.tensor([[[32 * h + 4 * g + c for c in range(4)]
                      for h in range(2)] for g in range(LANES)])
COLS = torch.arange(64)
# the lane that ends with column m of its group: 2 (m % 4)
OUT_LANE = 2 * (COLS % 4)


def emulate_wkv6(r, k, v, w, u):
    """``csrc/wkv6.cu`` in float32: (B, S, H, 64) operands, u (H, 64). Lane
    g of a column group runs, for each of its 4 columns, a chain of 4 FMAs
    over each of its two row groups and adds the two; the group's 8 lanes
    then sum column m as ((a_L + a_L^4) + (a_L^2 + a_L^6)) + ((a_L^1 +
    a_L^5) + (a_L^3 + a_L^7)) with L = 2 (m % 4) (halving the columns at
    xor 4 and 2, the pair at xor 1); y = v ruk + that sum, ruk_t = r u k
    over four runs of 16 channels (FMAs in order) added at xor 1 and 2;
    then S <- S max(w, 1e-12) + k v."""
    b, s, h, n = r.shape
    flat = [t.transpose(1, 2).reshape(b * h, s, n).float()
            for t in (r, k, v, w)]
    uf = u.float().repeat(b, 1)
    state = torch.zeros(b * h, n, n)
    ys = []
    for t in range(s):
        rt, kt, vt, wt = (f[:, t] for f in flat)
        wc = torch.clamp(wt, min=1e-12)
        ruk = torch.zeros(b * h, 4)
        for i in range(16):
            ch = 16 * torch.arange(4) + i
            ruk = _fma(rt[:, ch] * uf[:, ch], kt[:, ch], ruk)
        ruk = (ruk[:, 0] + ruk[:, 1]) + (ruk[:, 2] + ruk[:, 3])
        rr = rt[:, ROWS]                                  # (BH, 8, 2, 4)
        ss = state[:, ROWS, :]                            # (BH, 8, 2, 4, N)
        a = rr[..., 0, None] * ss[..., 0, :]
        for c in range(1, 4):
            a = _fma(rr[..., c, None], ss[..., c, :], a)
        a = a[:, :, 0] + a[:, :, 1]                       # (BH, 8, N)

        def lane(x):
            return a[:, OUT_LANE ^ x, COLS]
        red = (((lane(0) + lane(4)) + (lane(2) + lane(6)))
               + ((lane(1) + lane(5)) + (lane(3) + lane(7))))
        ys.append(_fma(vt, ruk[:, None], red))
        state = _fma(state, wc[:, :, None], kt[:, :, None] * vt[:, None, :])
    y = torch.stack(ys, 1)
    return y.reshape(b, h, s, n).transpose(1, 2)


def _wkv_arrays(b, s, h, seed):
    """r/k/v/u standard normal, w log-uniform over (1e-14, 1): some decays
    below the kernel's clamp of 1e-12, as ``chip_smoke.py`` draws them."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, 64)).astype(np.float32)
               for _ in range(3))
    w = (10.0 ** rng.uniform(-14, 0, (b, s, h, 64))).astype(np.float32)
    u = rng.standard_normal((h, 64)).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("b,s,h", [(2, 40, 2), (1, 33, 3), (1, 1, 1)])
def test_wkv6_emulation_matches_sequential_and_pallas(b, s, h):
    arrays = _wkv_arrays(b, s, h, b * 100 + s + h)
    r, k, v, w, u = map(torch.as_tensor, arrays)
    y = emulate_wkv6(r, k, v, w, u)
    flat = [t.transpose(1, 2).reshape(b * h, s, 64) for t in (r, k, v, w)]
    y_s = ref.wkv6_ref(*flat, u.repeat(b, 1))
    y_s = y_s.reshape(b, h, s, 64).transpose(1, 2)
    scale = float(y_s.abs().max()) + 1e-6
    assert float((y - y_s).abs().max()) / scale < TOL_RECUR_SEQ
    y_p = np.asarray(jops.wkv6_forward(*map(jnp.asarray, arrays), chunk=8,
                                       use_pallas="interpret"))
    assert float(np.abs(y.numpy() - y_p).max()) / scale < TOL_RECUR_SEQ
