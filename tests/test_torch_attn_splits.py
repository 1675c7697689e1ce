"""The key-range splits of the paged attention kernels, on the CPU.

``kernels/paged_attention.py:split_layout`` sizes the kernels' grid and
scratch: split ``s`` holds key positions ``[s * keys, (s + 1) * keys)``, and
the merge reads, for a row with keys ``[lo, hi)``, the splits ``lo // keys``
to ``(hi - 1) // keys`` in ascending order. Here every visible key must lie
in exactly one of those splits, and a float32 PyTorch emulation of
split-then-merge must match the port's plain version and the JAX package's
within 2e-5 (the attention tolerance: softmax sums in other orders).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import paged_attention as ak
from repro_torch.kernels import ref

torch.set_num_threads(1)

NEG = -1e30


def _row_keys(ctx, window, mb, bs):
    """The keys [lo, hi) a row attends, as the kernels clip them."""
    lo = max(0, ctx - (window or ak.NO_WINDOW))
    return lo, min(ctx, mb * bs)


@pytest.mark.parametrize("mb,bs", [(128, 16), (16, 16), (3, 7), (64, 5),
                                   (40, 3), (2, 300)])
@pytest.mark.parametrize("window", [None, 1, 9, 1000, 1024])
def test_every_visible_key_in_exactly_one_split(mb, bs, window):
    keys, ns = ak.split_layout(mb, bs)
    assert keys % bs == 0 and keys // bs <= 256
    assert ns * keys >= mb * bs > (ns - 1) * keys
    cap = mb * bs
    edges = {1, 2, cap, cap - 1}
    for s in range(1, ns + 1):
        edges |= {s * keys - 1, s * keys, s * keys + 1}
    for ctx in sorted(c for c in edges if 1 <= c <= cap):
        lo, hi = _row_keys(ctx, window, mb, bs)
        count = np.zeros(cap, np.int64)
        for s in range(lo // keys, (hi - 1) // keys + 1):
            assert s < ns
            a, b = max(lo, s * keys), min(hi, (s + 1) * keys)
            assert a < b, (ctx, s)         # every split read holds a key
            count[a:b] += 1
        visible = np.zeros(cap, np.int64)
        visible[lo:hi] = 1
        np.testing.assert_array_equal(count, visible)


@pytest.mark.parametrize("mb,bs,split_keys", [(128, 16, 256), (3, 7, 256),
                                              (3, 7, 14), (16, 16, 64)])
def test_split_layout_blocks(mb, bs, split_keys):
    keys, ns = ak.split_layout(mb, bs, split_keys)
    assert keys == max(1, split_keys // bs) * bs
    assert ns == math.ceil(mb / (keys // bs))


def test_split_layout_refuses_empty_tables():
    with pytest.raises(ValueError):
        ak.split_layout(0, 16)


@pytest.mark.parametrize("hq,hkv", [(32, 16), (12, 12), (12, 4), (8, 2),
                                    (8, 1)])
def test_tile_tokens_fill_the_tile_rows(hq, hkv):
    tq = ak.tile_tokens(hq, hkv)
    g = hq // hkv
    assert tq * g <= ak.TILE_ROWS < (tq + 1) * g


def test_scratch_matches_its_byte_count():
    q = torch.zeros(264, 32, 128)
    keys, ns, acc, ml = ak._scratch(q, 128, 16)
    assert (keys, ns) == (256, 8)
    assert acc.shape == (264, 32, 8, 128) and ml.shape == (264, 32, 8, 2)
    assert (acc.numel() + ml.numel()) * 4 == ak.scratch_bytes(264, 32, 128,
                                                               128, 16)


def _split_merge(q, k_pool, v_pool, tables, slot_ids, ctx, *, softcap,
                 window, split_keys):
    """Split-then-merge in float32: per (token, query head) the partial
    (m, l, acc) of each split that meets its keys, then the merge in
    ascending split order, as the kernels compute it."""
    t, hq, d = q.shape
    _, bs, hkv, _ = k_pool.shape
    mb = tables.shape[1]
    g = hq // hkv
    keys, _ = ak.split_layout(mb, bs, split_keys)
    qs = q * (1.0 / math.sqrt(d))
    out = torch.empty_like(q)
    for i in range(t):
        row = tables[int(slot_ids[i])].long()
        k = k_pool[row].reshape(mb * bs, hkv, d)
        v = v_pool[row].reshape(mb * bs, hkv, d)
        lo, hi = _row_keys(int(ctx[i]), window, mb, bs)
        for qh in range(hq):
            h = qh // g
            parts = []
            for s in range(lo // keys, (hi - 1) // keys + 1):
                a, b = max(lo, s * keys), min(hi, (s + 1) * keys)
                sc = k[a:b, h] @ qs[i, qh]
                if softcap:
                    sc = softcap * torch.tanh(sc / softcap)
                m = sc.max()
                p = torch.exp(sc - m)
                parts.append((m, p.sum(), p @ v[a:b, h]))
            m = max(pm for pm, _, _ in parts)
            l = sum(pl * torch.exp(pm - m) for pm, pl, _ in parts)
            o = sum(pa * torch.exp(pm - m) for pm, _, pa in parts)
            out[i, qh] = o / l
    return out


@pytest.mark.parametrize("split_keys", [7, 14, 256])
@pytest.mark.parametrize("window", [None, 9, 1])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_split_merge_matches_plain_and_jax(split_keys, window, softcap):
    """GQA 12/4, D 40, BS 7: three slots and a null row for pads; a chunk
    of one slot after two decode tokens, contexts across split edges."""
    rng = np.random.default_rng(split_keys * 10 + (window or 0))
    hq, hkv, d, bs, mb, b = 12, 4, 40, 7, 3, 3
    nb = b * mb + 1
    kp, vp = (rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
              for _ in range(2))
    tables = np.concatenate([1 + rng.permutation(b * mb).reshape(b, mb),
                             np.zeros((1, mb))]).astype(np.int32)
    sid = np.array([0, 1] + [2] * 8 + [b, b], np.int32)
    lens = np.array([21, 14] + list(range(7, 15)) + [1, 1], np.int32)
    q = rng.standard_normal((len(sid), hq, d)).astype(np.float32)
    args = (q, kp, vp, tables, sid, lens)
    y = _split_merge(*map(torch.as_tensor, args), softcap=softcap,
                     window=window, split_keys=split_keys)
    y_p = ref.paged_prefill_attention_ref(*map(torch.as_tensor, args),
                                          softcap=softcap, window=window)
    y_j = np.asarray(jref.paged_prefill_attention_ref(
        *map(jnp.asarray, args), softcap=softcap, window=window))
    assert float((y - y_p).abs().max()) < 2e-5
    assert float(np.abs(y.numpy() - y_j).max()) < 2e-5
