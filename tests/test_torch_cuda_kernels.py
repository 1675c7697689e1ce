"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a GPU (the check runs inside the
test, so every worker collects the same tests). On a machine with an H100:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev):
    return torch.as_tensor(a, device=dev)


@pytest.mark.parametrize("t,n,m,r", [(8, 768, 768, 768), (72, 768, 3072, 500),
                                     (72, 3072, 768, 300), (33, 17, 29, 7),
                                     (100, 96, 80, 40), (5, 64, 64, 64)])
def test_gar_kernel_matches_plain(dev, t, n, m, r):
    rng = np.random.default_rng(t * 7 + r)
    x = rng.standard_normal((t, n)).astype(np.float32)
    v = rng.standard_normal((n, r)).astype(np.float32) / math.sqrt(n)
    u = rng.standard_normal((m - r, r)).astype(np.float32) / math.sqrt(r)
    perm_inv = rng.permutation(m).astype(np.int64)
    args = [_t(a, dev) for a in (x, v, u, perm_inv)]
    y_k = ops.gar_forward(*args)
    y_p = ops.gar_forward(*[a.cpu() for a in args])
    scale = float(y_p.abs().max()) + 1e-6
    assert float((y_k.cpu() - y_p).abs().max()) / scale < 2e-4


# gemma3-27b's GAR shapes (d 5376, d_ff 21504): gate at a low rank, gate at
# full rank and a ragged rank, down at full rank with m - r = 0; T 8 as at
# decode
GAR_PASS_CASES = [(8, 5376, 21504, 1900), (8, 5376, 21504, 5376),
                  (19, 5376, 21504, 3001), (8, 21504, 5376, 5376)]


def _gar_inputs(t, n, m, r, seed, dev):
    rng = np.random.default_rng(seed)
    x = _t(rng.standard_normal((t, n)).astype(np.float32), dev)
    v = _t((rng.standard_normal((n, r)) / math.sqrt(n)).astype(np.float32),
           dev)
    u = _t((rng.standard_normal((m - r, r)) / math.sqrt(r)).astype(
        np.float32), dev)
    return x, v, u, _t(rng.permutation(m), dev)


@pytest.mark.parametrize("t,n,m,r", GAR_PASS_CASES)
def test_gar_kernel_rank_passes_match_plain(dev, t, n, m, r):
    """gemma3's widths up to full rank: one call is two launches (z, then
    the tail and the identity copy), and the output agrees with
    ``ref.gar_matmul_ref`` (relative to the output's max)."""
    from repro_torch.kernels import gar_matmul as gk
    x, v, u, perm_inv = _gar_inputs(t, n, m, r, r, dev)
    before = gk.launches
    y = gk.gar_matmul(x, v, u, perm_inv)
    assert gk.launches - before == 2
    z, tail = ref.gar_matmul_ref(x, v, u)
    y_p = torch.cat([z, tail], dim=-1)[:, perm_inv]
    scale = float(y_p.abs().max()) + 1e-6
    assert float((y - y_p).abs().max()) / scale < 2e-4


@pytest.mark.parametrize("t", [8, 264])
@pytest.mark.parametrize("r", [2151, 5376])
def test_gar_kernel_bitwise_repeatable(dev, t, r):
    """Two calls on the same inputs give the same bits at gemma3's mlp/gate
    shapes (decode T 8, a mixed iteration's T 264): the split-K sums run in
    a fixed order, with no atomics."""
    from repro_torch.kernels import gar_matmul as gk
    x, v, u, perm_inv = _gar_inputs(t, 5376, 21504, r, t + r, dev)
    y1 = gk.gar_matmul(x, v, u, perm_inv)
    y2 = gk.gar_matmul(x, v, u, perm_inv)
    assert torch.equal(y1, y2)


def test_cluster_slots_match_the_card(dev):
    """The H100 SXM's table of blocks in flight per cluster size that the
    CPU tests tile with (``tiles.CLUSTER_SLOTS``) is what this card reports
    for the kernels of every token tile (cudaOccupancyMaxActiveClusters x
    cluster size), at two blocks an SM (token tiles 8, 32) and at one (64,
    96, 128), and the wrappers tile with the card's answer."""
    from repro_torch.kernels import lowrank_matmul as lk
    from repro_torch.kernels import tiles
    lib = lk._lib()
    for bn, want in zip(tiles.TOKEN_TILES, tiles.CLUSTER_SLOTS):
        got = tuple(lib.lowrank_cluster_slots(bn, s)
                    for s in range(1, tiles.MAX_SPLIT + 1))
        assert got == want, (bn, got)
    assert lk.card_slots() == tiles.CLUSTER_SLOTS


LOWRANK_CASES = [(1024, 768, 3072, 768, 200), (1024, 3072, 768, 768, 768),
                 (33, 17, 29, 7, 3), (33, 17, 29, 7, 0), (33, 17, 29, 7, 7),
                 (33, 17, 29, 7, None), (70, 64, 96, 48, 31),
                 (5, 300, 130, 257, 129), (40, 2560, 96, 2560, None),
                 (33, 3584, 70, 3584, 3001)]


def _lowrank_inputs(t, n, m, r, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, n)).astype(np.float32)
    v = rng.standard_normal((n, r)).astype(np.float32) / math.sqrt(n)
    u = rng.standard_normal((m, r)).astype(np.float32) / math.sqrt(r)
    return x, v, u


@pytest.mark.parametrize("t,n,m,r,rank", LOWRANK_CASES)
def test_lowrank_kernel_matches_plain(dev, t, n, m, r, rank):
    """The kernel against its plain version; relative to the output's max,
    as for GAR (two float32 summation orders)."""
    from repro_torch.kernels import lowrank_matmul as lk
    from repro_torch.kernels import ref
    x, v, u = (_t(a, dev) for a in _lowrank_inputs(t, n, m, r, t + n + r))
    before = lk.launches
    y_k = lk.lowrank_matmul(x, v, u, rank)
    # two launches a call (z, then y), at every kept rank
    assert lk.launches == before + 2
    y_p = ref.lowrank_matmul_ref(x.cpu(), v.cpu(), u.cpu(), rank)
    scale = float(y_p.abs().max()) + 1e-6
    assert float((y_k.cpu() - y_p).abs().max()) / scale < 2e-4
    if rank == 0:
        assert not y_k.any()


@pytest.mark.parametrize("t,n,m,r,rank", [(64, 96, 80, 48, 20),
                                          (33, 17, 29, 7, 7)])
def test_lowrank_backward_on_card_matches_cpu(dev, t, n, m, r, rank):
    """Autograd through ``ops.lowrank_forward`` on the card (kernel forward,
    plain backward) against the CPU (plain forward and backward)."""
    arrays = _lowrank_inputs(t, n, m, r, 7)
    dy = np.random.default_rng(8).standard_normal((t, m)).astype(np.float32)
    grads = []
    for device in (dev, torch.device("cpu")):
        x, v, u = (torch.tensor(a, device=device, requires_grad=True)
                   for a in arrays)
        y = ops.lowrank_forward(x, v, u, rank)
        y.backward(torch.as_tensor(dy, device=device))
        grads.append([y.detach().cpu()] + [a.grad.cpu() for a in (x, v, u)])
    for name, a, b in zip(("y", "dx", "dv", "du"), *grads):
        scale = float(b.abs().max()) + 1e-6
        assert float((a - b).abs().max()) / scale < 2e-4, name
    assert not grads[0][2][:, rank:].any() and not grads[0][3][:, rank:].any()


def _attn_inputs(hq, hkv, d, bs, mb, t):
    """Three slots' block tables plus a null row; pads read the null row."""
    rng = np.random.default_rng(hq * 100 + d)
    b = 3
    nb = b * mb + 1
    kp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    tables = np.concatenate([1 + rng.permutation(b * mb).reshape(b, mb),
                             np.zeros((1, mb))]).astype(np.int32)
    q = rng.standard_normal((t, hq, d)).astype(np.float32)
    sid = rng.integers(0, b + 1, size=t).astype(np.int32)
    lens = rng.integers(1, mb * bs + 1, size=t).astype(np.int32)
    lens[sid == b] = 1
    return q, kp, vp, tables, sid, lens


@pytest.mark.parametrize("hq,hkv,d,bs,mb,t", [(12, 12, 64, 16, 10, 72),
                                              (12, 12, 64, 16, 16, 8),
                                              (8, 2, 32, 8, 4, 10),
                                              (12, 4, 40, 7, 3, 10),
                                              (5, 5, 24, 3, 4, 10),
                                              (6, 2, 18, 5, 4, 12)])
def test_paged_attention_kernel_matches_plain(dev, hq, hkv, d, bs, mb, t):
    args = [_t(a, dev) for a in _attn_inputs(hq, hkv, d, bs, mb, t)]
    for softcap in (0.0, 30.0):
        y_k = ops.paged_prefill_attention_forward(*args, softcap=softcap)
        y_p = ops.paged_prefill_attention_forward(*[a.cpu() for a in args],
                                                  softcap=softcap)
        assert float((y_k.cpu() - y_p).abs().max()) < 2e-5


@pytest.mark.parametrize("hq,hkv,d,bs,mb,t", [(12, 12, 64, 16, 10, 72),
                                              (32, 16, 128, 16, 12, 20),
                                              (12, 4, 40, 7, 3, 10)])
@pytest.mark.parametrize("window", [1024, 37, 16, 1])
def test_windowed_paged_prefill_matches_plain(dev, hq, hkv, d, bs, mb, t,
                                              window):
    """Windows at and between block boundaries, one wider than every
    context, and a window of one key."""
    args = [_t(a, dev) for a in _attn_inputs(hq, hkv, d, bs, mb, t)]
    for softcap in (0.0, 30.0):
        y_k = ops.paged_prefill_attention_forward(*args, softcap=softcap,
                                                  window=window)
        y_p = ops.paged_prefill_attention_forward(
            *[a.cpu() for a in args], softcap=softcap, window=window)
        assert float((y_k.cpu() - y_p).abs().max()) < 2e-5


def _decode_inputs(hq, hkv, d, bs, mb, lens, seed):
    """One table row a slot; an idle slot (context 1) reads the null row."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    nb = b * mb + 1
    kp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    tables = (1 + rng.permutation(b * mb).reshape(b, mb)).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    tables[lens == 1] = 0
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    return q, kp, vp, tables, lens


# gpt2 (Hq = Hkv = 12, D 64) and gemma3 (32/16, D 128) decode geometries,
# contexts that fill their last block, end mid-block, or are idle
DECODE_CASES = [(12, 12, 64, 16, 16, [256, 100, 1, 17, 160, 33, 250, 64]),
                (32, 16, 128, 16, 128, [2048, 1024, 1500, 1, 1100, 1999,
                                        1025, 1234]),
                (8, 2, 32, 8, 4, [32, 17, 1]),
                (5, 5, 24, 3, 4, [12, 7, 1]),
                (6, 2, 18, 5, 4, [20, 9, 1])]   # D 18: the scalar path


@pytest.mark.parametrize("case", range(len(DECODE_CASES)))
@pytest.mark.parametrize("window", [None, 1024, 37])
def test_paged_decode_kernel_matches_plain(dev, case, window):
    from repro_torch.kernels import paged_attention as ak
    hq, hkv, d, bs, mb, lens = DECODE_CASES[case]
    args = [_t(a, dev) for a in _decode_inputs(hq, hkv, d, bs, mb, lens,
                                               case)]
    for softcap in (0.0, 30.0):
        before = ak.decode_launches
        y_k = ops.paged_attention_forward(*args, softcap=softcap,
                                          window=window)
        assert ak.decode_launches == before + 2   # units, then the merge
        y_p = ops.paged_attention_forward(*[a.cpu() for a in args],
                                          softcap=softcap, window=window)
        assert torch.isfinite(y_k).all()
        assert float((y_k.cpu() - y_p).abs().max()) < 2e-5


def test_paged_attention_kernel_repeatable(dev):
    """Fresh uploads of the same inputs give the same bits launch after
    launch, and the plain version on the CPU gives the same bits run after
    run; a failure names the side that moved and where."""
    inputs = _attn_inputs(12, 12, 64, 16, 10, 72)
    first_k = first_p = None
    for i in range(100):
        args = [_t(a, dev) for a in inputs]
        y_k = ops.paged_prefill_attention_forward(*args).cpu()
        y_p = ops.paged_prefill_attention_forward(
            *[torch.as_tensor(a) for a in inputs])
        if first_k is None:
            first_k, first_p = y_k, y_p
        for side, y, y0 in (("kernel", y_k, first_k), ("plain", y_p, first_p)):
            moved = (y != y0).any(-1).nonzero().tolist()
            assert not moved, (
                f"{side} output moved at launch {i}: (token, head) {moved[:8]}"
                f", contexts {[int(inputs[5][tok]) for tok, _ in moved[:8]]}"
                f", max diff {float((y - y0).abs().max()):.3e}")
        assert float((y_k - y_p).abs().max()) < 2e-5


def _gemma_decode_inputs(seed):
    """gemma3's decode shape: 8 slots, Hq 32, Hkv 16, D 128, BS 16, MB 128,
    contexts 1024-2048."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1024, 2049, 8)
    return _decode_inputs(32, 16, 128, 16, 128, lens, seed)


def _gemma_mixed_inputs(seed):
    """gemma3's mixed iteration: 8 decode tokens of 8 slots, then a
    256-token chunk of a ninth slot at positions start .. start + 255 (T
    264), all over tables of 128 blocks of 16 keys."""
    rng = np.random.default_rng(seed)
    b, mb, bs = 9, 128, 16
    nb = b * mb + 1
    kp, vp = (rng.standard_normal((nb, bs, 16, 128)).astype(np.float32)
              for _ in range(2))
    tables = (1 + rng.permutation(b * mb).reshape(b, mb)).astype(np.int32)
    start = int(rng.integers(0, mb * bs - 256 + 1))
    sid = np.concatenate([np.arange(8), np.full(256, 8)]).astype(np.int32)
    lens = np.concatenate([rng.integers(1024, 2049, 8),
                           start + 1 + np.arange(256)]).astype(np.int32)
    q = rng.standard_normal((264, 32, 128)).astype(np.float32)
    return q, kp, vp, tables, sid, lens


@pytest.mark.parametrize("window", [None, 1024, 1000])
def test_decode_and_flat_kernels_bit_identical(dev, window):
    """The decode kernel and the flat-token kernel with one token a slot run
    each slot's token through the same instructions: the same bits."""
    from repro_torch.kernels import paged_attention as ak
    q, kp, vp, tables, lens = (_t(a, dev) for a in _gemma_decode_inputs(3))
    sid = torch.arange(8, dtype=torch.int32, device=dev)
    for softcap in (0.0, 30.0):
        y_d = ops.paged_attention_forward(q, kp, vp, tables, lens,
                                          softcap=softcap, window=window)
        before = ak.launches
        y_f = ops.paged_prefill_attention_forward(
            q, kp, vp, tables, sid, lens, softcap=softcap, window=window)
        assert ak.launches == before + 2   # units, then the merge
        assert torch.equal(y_d, y_f), float((y_d - y_f).abs().max())


@pytest.mark.parametrize("window", [None, 1000])
def test_attention_kernels_repeat_at_gemma_shapes(dev, window):
    """Two calls of each kernel give the same bits at gemma3's decode and
    T 264 shapes, and both hold the plain version."""
    dec = [_t(a, dev) for a in _gemma_decode_inputs(4)]
    mixed = [_t(a, dev) for a in _gemma_mixed_inputs(5)]
    for fn, args in ((ops.paged_attention_forward, dec),
                     (ops.paged_prefill_attention_forward, mixed)):
        y1 = fn(*args, window=window)
        y2 = fn(*args, window=window)
        assert torch.equal(y1, y2)
        y_p = fn(*[a.cpu() for a in args], window=window)
        assert float((y1.cpu() - y_p).abs().max()) < 2e-5


# contexts that end on a split boundary (256 keys at BS 16), one key past
# it, one key, and a window of one key and one that starts mid-block
SPLIT_EDGE_LENS = [256, 257, 512, 513, 1, 255, 768, 100]


@pytest.mark.parametrize("window", [None, 1, 300, 256])
def test_attention_kernels_at_split_edges(dev, window):
    from repro_torch.kernels import paged_attention as ak
    assert ak.split_layout(64, 16) == (256, 4)
    q, kp, vp, tables, lens = _decode_inputs(32, 16, 128, 16, 64,
                                             SPLIT_EDGE_LENS, 11)
    dec = [_t(a, dev) for a in (q, kp, vp, tables, lens)]
    # the same slots as flat tokens, each slot's last key positions also
    # as a chunk: tokens of one slot with contexts around the boundaries
    chunk_lens = np.arange(250, 262, dtype=np.int32)
    sid = np.concatenate([np.arange(8), np.full(12, 6)]).astype(np.int32)
    flat_lens = np.concatenate([lens, chunk_lens]).astype(np.int32)
    fq = np.random.default_rng(12).standard_normal(
        (20, 32, 128)).astype(np.float32)
    flat = [_t(a, dev) for a in (fq, kp, vp, tables, sid, flat_lens)]
    for softcap in (0.0, 30.0):
        for fn, args in ((ops.paged_attention_forward, dec),
                         (ops.paged_prefill_attention_forward, flat)):
            y_k = fn(*args, softcap=softcap, window=window)
            y_p = fn(*[a.cpu() for a in args], softcap=softcap,
                     window=window)
            assert torch.isfinite(y_k).all()
            assert float((y_k.cpu() - y_p).abs().max()) < 2e-5, fn


def test_attention_wrappers_do_not_synchronise(dev):
    """Neither wrapper reads a device tensor on the host: under the sync
    debug mode "error" a synchronising call would raise."""
    dec = [_t(a, dev) for a in _gemma_decode_inputs(6)]
    mixed = [_t(a, dev) for a in _gemma_mixed_inputs(7)]
    from repro_torch.kernels import paged_attention as ak
    ak.paged_attention(*dec)          # built and loaded outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ak.paged_attention(*dec, window=1000)
        ak.paged_prefill_attention(*mixed, softcap=30.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("s,v", [(8, 50257), (9, 515), (3, 64), (1, 1000)])
def test_sampling_kernel_matches_plain(dev, s, v):
    rng = np.random.default_rng(s * 1000 + v)
    logits = rng.standard_normal((s, v)).astype(np.float32) * 3
    temps = np.where(rng.random(s) < 0.3, 0.0,
                     rng.uniform(0.2, 2.5, s)).astype(np.float32)
    topk = np.where(rng.random(s) < 0.5, 0,
                    rng.integers(1, min(v, 64) + 1, s)).astype(np.int64)
    u = rng.random(s).astype(np.float32)
    for k in (None, topk):
        args = [_t(a, dev) for a in (logits, temps)]
        kk = None if k is None else _t(k, dev)
        t_k, p_k = ops.topk_mask_sample_forward(*args, kk, _t(u, dev),
                                                return_probs=True)
        t_p, p_p = ops.topk_mask_sample_forward(
            *[a.cpu() for a in args], None if k is None else kk.cpu(),
            torch.as_tensor(u), return_probs=True)
        np.testing.assert_array_equal(t_k.cpu().numpy(), t_p.numpy())
        assert float((p_k.cpu() - p_p).abs().max()) < 1e-5
        t_only = ops.topk_mask_sample_forward(*args, kk, _t(u, dev))
        np.testing.assert_array_equal(t_only.cpu().numpy(), t_p.numpy())


def _sampling_call(logits, temps, topk, u, dev):
    """Card tensors (logits, temperature, threshold, u) of a call whose
    threshold is the rows' top-k cutoff (-inf where top-k is 0)."""
    args = [_t(a, dev) for a in (logits, temps)]
    z = args[0] / torch.clamp(args[1], min=1e-30)[:, None]
    thr = ref.topk_threshold_ref(z, _t(topk, dev))
    return (*args, thr, _t(u, dev))


def _random_rows(s, v, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((s, v)) * 3).astype(np.float32)
    temps = np.where(rng.random(s) < 0.3, 0.0,
                     rng.uniform(0.2, 2.5, s)).astype(np.float32)
    topk = np.where(rng.random(s) < 0.5, 0,
                    rng.integers(1, min(v, 64) + 1, s)).astype(np.int64)
    return logits, temps, topk, rng.random(s).astype(np.float32)


@pytest.mark.parametrize("s,v", [(8, 50257), (8, 262144), (4, 50257)])
def test_sampling_kernel_repeatable_in_three_launches(dev, s, v):
    """The smoke's main shapes: two calls give the same bits, tokens and
    probs, and a call is three launches (split maxima, block sums, draw)."""
    from repro_torch.kernels import sampling as sk
    args = _sampling_call(*_random_rows(s, v, s + v), dev)
    before = sk.launches
    t1, p1 = sk.topk_mask_sample(*args, return_probs=True)
    t2, p2 = sk.topk_mask_sample(*args, return_probs=True)
    t3 = sk.topk_mask_sample(*args)
    assert sk.launches - before == 9
    assert torch.equal(t1, t2) and torch.equal(t1, t3)
    assert torch.equal(p1, p2)


@pytest.mark.parametrize("v", [262144, 50257, 1025, 515, 3000])
def test_sampling_tokens_equal_plain_over_seeds(dev, v):
    """20 seeds of 8 rows (greedy, sampled, top-k or none): tokens equal
    to the plain version's on the card, probs within 1e-5."""
    from repro_torch.kernels import sampling as sk
    for seed in range(20):
        args = _sampling_call(*_random_rows(8, v, 1000 * seed + v), dev)
        tok, probs = sk.topk_mask_sample(*args, return_probs=True)
        t_ref, p_ref = ref.topk_mask_sample_ref(*args)
        assert torch.equal(tok, t_ref), (seed, tok.tolist(), t_ref.tolist())
        assert float((probs - p_ref).abs().max()) < 1e-5
        assert torch.equal(sk.topk_mask_sample(*args), t_ref)


def _edge_rows(v, s):
    """The cases of ``tests/test_torch_sampling_splits.py`` on one batch:
    greedy rows with their max on both sides of a split edge, and on two
    entries of one split and one of the next; a flat greedy row; top-k 1;
    five entries tied at top-k 3 (all kept); two tied at top-k 1; u = 0 and
    1 - 2^-24 on rows whose kept weights are all exactly 1. Returns the
    arrays and the tokens these rows must give."""
    from repro_torch.kernels import sampling as sk
    _, _, per, _ = sk.split_layout(s, v)
    edge = per * sk.BLOCK
    rng = np.random.default_rng(v)
    logits = rng.standard_normal((s, v)).astype(np.float32)
    temps = np.full(s, 0.7, np.float32)
    topk = np.zeros(s, np.int64)
    u = rng.random(s).astype(np.float32)
    one_less = np.float32(1 - 2.0**-24)
    ties = [7, edge - 1, edge, (edge + v) // 2, v - 1]
    want = {}
    logits[0, [edge - 1, edge]] = 9.0
    logits[1, [3, edge - 5, edge]] = 9.0
    logits[2, :] = 2.0
    temps[:3] = 0.0
    want.update({0: edge - 1, 1: 3, 2: 0})
    topk[3], u[3] = 1, 0.999
    want[3] = int(logits[3].argmax())
    for row, uu, tok in ((4, 0.1, ties[0]), (5, 0.9, ties[4]),
                         (6, 0.0, ties[0]), (7, one_less, ties[4])):
        logits[row, ties] = 8.0
        topk[row], u[row] = 3, uu
        want[row] = tok
    second = min(edge + 6, v - 1)
    logits[8, [10, second]] = 9.0
    topk[8], u[8] = 1, 0.7
    want[8] = second
    return (logits, temps, topk, u), want


@pytest.mark.parametrize("v", [1025, 5000, 262144])
def test_sampling_edge_cases(dev, v):
    from repro_torch.kernels import sampling as sk
    arrays, want = _edge_rows(v, 9)
    args = _sampling_call(*arrays, dev)
    tok, probs = sk.topk_mask_sample(*args, return_probs=True)
    t_ref, p_ref = ref.topk_mask_sample_ref(*args)
    assert torch.equal(tok, t_ref), (tok.tolist(), t_ref.tolist())
    assert float((probs - p_ref).abs().max()) < 1e-5
    assert {r: int(tok[r]) for r in want} == want
    t_cpu = ops.topk_mask_sample_forward(*(torch.as_tensor(a)
                                           for a in arrays))
    np.testing.assert_array_equal(
        ops.topk_mask_sample_forward(*(_t(a, dev) for a in arrays)).cpu(),
        t_cpu)


def test_sampling_and_wkv6_do_not_synchronise(dev):
    """Neither wrapper waits for the card: no host synchronisation under
    the sync debug mode "error"."""
    from repro_torch.kernels import sampling as sk
    from repro_torch.kernels import wkv6 as wk
    args = _sampling_call(*_random_rows(8, 262144, 3), dev)
    rec = [_t(a, dev) for a in _wkv_arrays(2, 40, 3, 4)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sk.topk_mask_sample(*args, return_probs=True)
        sk.topk_mask_sample(*args)
        wk.wkv6(*rec)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _wkv_arrays(b, s, h, seed):
    """r/k/v/u standard normal, w log-uniform over (1e-14, 1): some decays
    fall below the kernel's clamp of 1e-12."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, 64)).astype(np.float32)
               for _ in range(3))
    w = (10.0 ** rng.uniform(-14, 0, (b, s, h, 64))).astype(np.float32)
    u = rng.standard_normal((h, 64)).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("b,s,h", [(8, 128, 40), (3, 70, 5), (1, 1, 1),
                                   (2, 33, 3)])
def test_wkv6_kernel_matches_plain(dev, b, s, h):
    """The kernel against the chunked plain version (chunk 64, S padded)
    and the sequential one; 1e-4 of the output's max, the gap between the
    chunked and sequential forms on the CPU at these decays."""
    from repro_torch.kernels import wkv6 as wk
    arrays = _wkv_arrays(b, s, h, b * s + h)
    before = wk.launches
    y_k = ops.wkv6_forward(*(_t(a, dev) for a in arrays), chunk=64).cpu()
    assert wk.launches == before + 1
    y_p = ops.wkv6_forward(*map(torch.as_tensor, arrays), chunk=64)
    scale = float(y_p.abs().max()) + 1e-6
    assert float((y_k - y_p).abs().max()) / scale < 1e-4
    flat = [torch.as_tensor(a).transpose(1, 2).reshape(b * h, s, 64)
            for a in arrays[:4]]
    y_s = ref.wkv6_ref(*flat, torch.as_tensor(arrays[4]).repeat(b, 1))
    y_s = y_s.reshape(b, h, s, 64).transpose(1, 2)
    assert float((y_k - y_s).abs().max()) / scale < 1e-4


def _wkv_seq(arrays, dev):
    """The sequential recurrence on the card, (B, S, H, N) in and out."""
    b, s, h, n = arrays[0].shape
    flat = [_t(a, dev).transpose(1, 2).reshape(b * h, s, n)
            for a in arrays[:4]]
    y = ref.wkv6_ref(*flat, _t(arrays[4], dev).repeat(b, 1))
    return y.reshape(b, h, s, n).transpose(1, 2)


@pytest.mark.parametrize("s", [1, 31, 32, 33, 64, 70, 200])
def test_wkv6_kernel_across_chunk_edges(dev, s):
    """S on both sides of the kernel's 32-step chunks (the double-buffered
    staging): within 2e-5 of the sequential recurrence and 2e-4 of the
    chunked plain version (``chip_smoke.py``'s TOL_RECUR_SEQ and
    TOL_RECUR_CHUNKED), relative to the output's max; one launch a call."""
    from repro_torch.kernels import wkv6 as wk
    arrays = _wkv_arrays(2, s, 3, s)
    ts = [_t(a, dev) for a in arrays]
    before = wk.launches
    y = wk.wkv6(*ts)
    assert wk.launches == before + 1
    y_s = _wkv_seq(arrays, dev)
    scale = float(y_s.abs().max()) + 1e-6
    assert float((y - y_s).abs().max()) / scale < 2e-5
    y_c = ops._wkv_plain(*ts, 64)
    assert float((y - y_c).abs().max()) / scale < 2e-4


def test_wkv6_kernel_repeatable_and_unaligned(dev):
    """At rwkv6's training shape two calls give the same bits; operands
    off the 16-byte grid take the kernel's 4-byte copies and give the same
    bits as aligned ones."""
    from repro_torch.kernels import wkv6 as wk
    ts = [_t(a, dev) for a in _wkv_arrays(8, 128, 40, 1)]
    y1 = wk.wkv6(*ts)
    assert torch.equal(y1, wk.wkv6(*ts))
    small = [_t(a, dev) for a in _wkv_arrays(2, 45, 3, 2)]
    shifted = []
    for t in small:
        buf = torch.empty(t.numel() + 1, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16
        shifted.append(view)
    assert torch.equal(wk.wkv6(*small[:4], small[4]),
                       wk.wkv6(*shifted[:4], small[4]))


def _ssd_arrays(b, s, h, g, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, 64)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    bb, cc = (rng.standard_normal((b, s, g, 64)).astype(np.float32)
              for _ in range(2))
    return x, dt, a, bb, cc


@pytest.mark.parametrize("b,s,h,g", [(8, 128, 112, 1), (3, 70, 5, 1),
                                     (2, 50, 6, 2), (1, 1, 1, 1)])
def test_ssd_kernel_matches_plain(dev, b, s, h, g):
    from repro_torch.kernels import ssd as sk
    arrays = _ssd_arrays(b, s, h, g, b * s + h + g)
    before = sk.launches
    y_k = ops.ssd_forward(*(_t(a, dev) for a in arrays), chunk=128).cpu()
    assert sk.launches == before + sk.LAUNCHES_A_CALL
    y_p = ops.ssd_forward(*map(torch.as_tensor, arrays), chunk=128)
    scale = float(y_p.abs().max()) + 1e-6
    assert float((y_k - y_p).abs().max()) / scale < 1e-4


def _ssd_seq(arrays, dev):
    """The sequential recurrence on the card, (B, S, H, P) in and out."""
    x, dt, a, bb, cc = (_t(t, dev) for t in arrays)
    b, s, h, p = x.shape
    rep = h // bb.shape[2]
    bf, cf = (t.repeat_interleave(rep, 2).transpose(1, 2).reshape(
        b * h, s, 64) for t in (bb, cc))
    y = ref.ssd_ref(x.transpose(1, 2).reshape(b * h, s, p),
                    dt.transpose(1, 2).reshape(b * h, s), a.repeat(b), bf,
                    cf)
    return y.reshape(b, h, s, p).transpose(1, 2)


def _ssd_within_tolerance(arrays, dev):
    """One call of the kernel: LAUNCHES_A_CALL launches, finite, within
    2e-5 of the sequential recurrence and 2e-4 of the chunked plain
    version (``chip_smoke.py``'s TOL_RECUR_SEQ and TOL_RECUR_CHUNKED),
    relative to the output's max."""
    from repro_torch.kernels import ssd as sk
    ts = [_t(a, dev) for a in arrays]
    before = sk.launches
    y = sk.ssd(*ts)
    assert sk.launches == before + sk.LAUNCHES_A_CALL
    assert bool(torch.isfinite(y).all())
    y_s = _ssd_seq(arrays, dev)
    scale = float(y_s.abs().max()) + 1e-6
    assert float((y - y_s).abs().max()) / scale < 2e-5
    y_c = ops._ssd_plain(*ts, 128)
    assert float((y - y_c).abs().max()) / scale < 2e-4


@pytest.mark.parametrize("s", [127, 128, 129, 257])
def test_ssd_kernel_across_chunk_edges(dev, s):
    """S on both sides of the kernel's chunk of 128 steps (Q - 1, Q, Q + 1,
    2Q + 1): the ragged tail masked, the state carried across chunks."""
    _ssd_within_tolerance(_ssd_arrays(2, s, 4, 2, s), dev)


@pytest.mark.parametrize("s,h,g", [(70, 8, 2), (200, 12, 4), (33, 6, 2),
                                   (130, 7, 1)])
def test_ssd_kernel_groups_of_several_heads(dev, s, h, g):
    """G 2 and 4 with 4, 3 and 3 heads a group (a block takes two heads of
    one group, so an odd group leaves a block of one), and H 7 in one
    group."""
    _ssd_within_tolerance(_ssd_arrays(2, s, h, g, s + h), dev)


def test_ssd_kernel_large_steps(dev):
    """dt = |N(0, 1)| x 4 and a = -|N(0, 1)|: a chunk's log-decay passes
    -88.7, where the reference's masked exponent overflows; y stays
    finite and within tolerance."""
    rng = np.random.default_rng(21)
    x, _, _, bb, cc = _ssd_arrays(2, 257, 4, 2, 21)
    dt = (np.abs(rng.standard_normal((2, 257, 4))) * 4.0).astype(np.float32)
    a = -np.abs(rng.standard_normal(4)).astype(np.float32)
    assert float(np.cumsum(dt[0, :128] * a, 0).min()) < -88.7
    _ssd_within_tolerance((x, dt, a, bb, cc), dev)


def test_ssd_scan_reads_the_scores_of_its_own_call(dev):
    """The scan launch waits for the scores launch before it reads them:
    back to back at zamba2's shape, a call with other b and c (whose
    scratch takes the memory the previous call's had) matches the
    sequential recurrence on its own inputs."""
    from repro_torch.kernels import ssd as sk
    first = [_t(a, dev) for a in _ssd_arrays(8, 128, 112, 1, 3)]
    arrays = _ssd_arrays(8, 128, 112, 1, 4)
    second = [_t(a, dev) for a in arrays]
    for _ in range(3):
        sk.ssd(*first)
        y = sk.ssd(*second)
    y_s = _ssd_seq(arrays, dev)
    scale = float(y_s.abs().max()) + 1e-6
    assert float((y - y_s).abs().max()) / scale < 2e-5


def test_ssd_kernel_repeatable_unaligned_and_sync_free(dev):
    """At zamba2's training shape two calls give the same bits; operands off
    the 16-byte grid take the kernel's 4-byte copies and give the same bits
    as aligned ones; the wrapper never waits for the card."""
    from repro_torch.kernels import ssd as sk
    ts = [_t(a, dev) for a in _ssd_arrays(8, 128, 112, 1, 1)]
    y1 = sk.ssd(*ts)
    assert torch.equal(y1, sk.ssd(*ts))
    small = [_t(a, dev) for a in _ssd_arrays(2, 150, 4, 2, 2)]
    shifted = []
    for t in small:
        buf = torch.empty(t.numel() + 1, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16
        shifted.append(view)
    assert torch.equal(sk.ssd(*small), sk.ssd(*shifted))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sk.ssd(*ts)
        sk.ssd(*small)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_recurrences_backward_on_card_match_cpu(dev):
    """Autograd through ``ops.wkv6_forward`` and ``ops.ssd_forward`` on the
    card (kernel forward, plain recompute backward) against the CPU; decays
    moderate enough that the chunked form's masked exponent stays finite."""
    wkv = list(_wkv_arrays(2, 40, 3, 5))
    wkv[3] = np.clip(wkv[3], 0.3, 1.0)
    for fn, arrays in ((ops.wkv6_forward, wkv),
                       (ops.ssd_forward, _ssd_arrays(2, 40, 4, 2, 6))):
        dy = np.random.default_rng(9).standard_normal(
            arrays[0].shape).astype(np.float32)
        grads = []
        for device in (dev, torch.device("cpu")):
            ts = [torch.tensor(a, device=device, requires_grad=True)
                  for a in arrays]
            y = fn(*ts, chunk=16)
            y.backward(torch.as_tensor(dy, device=device))
            grads.append([y.detach().cpu()] + [t.grad.cpu() for t in ts])
        for i, (a, b) in enumerate(zip(*grads)):
            scale = float(b.abs().max()) + 1e-6
            assert float((a - b).abs().max()) / scale < 1e-4, (fn, i)


def test_wrappers_raise_on_cpu_mixed_devices(dev):
    x = torch.zeros(4, 8, device=dev)
    with pytest.raises(ValueError):
        from repro_torch.kernels.gar_matmul import gar_matmul
        gar_matmul(x, torch.zeros(8, 8), torch.zeros(0, 8),
                   torch.arange(8))
    from repro_torch.kernels import paged_attention as ak
    pool = torch.zeros(2, 2, 1, 4, device=dev)
    table = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    ones = torch.ones(1, dtype=torch.int32, device=dev)
    q = torch.zeros(1, 1, 4, device=dev)
    # a window launches the kernel on CUDA tensors (no plain version there)
    assert ops.paged_prefill_attention_forward(
        q, pool, pool, table, table[0], ones, window=4).is_cuda
    assert ops.paged_attention_forward(q, pool, pool, table, ones,
                                       window=4).is_cuda
    with pytest.raises(ValueError):
        ak.paged_attention(q, pool.cpu(), pool, table, ones)
    with pytest.raises(ValueError):
        ak.paged_attention(q.cpu(), pool.cpu(), pool.cpu(), table.cpu(),
                           ones.cpu())
    with pytest.raises(TypeError):
        ak.paged_attention(q, pool, pool, table.long(), ones)
    with pytest.raises(ValueError):
        ak.paged_attention(q, pool, pool, table, ones, window=0)
    with pytest.raises(ValueError):
        ak.paged_prefill_attention(q, pool, pool, table, table[0], ones,
                                   window=0)
    from repro_torch.kernels import ssd as sk
    from repro_torch.kernels import wkv6 as wk
    r = torch.zeros(1, 4, 2, 64, device=dev)
    with pytest.raises(ValueError):
        wk.wkv6(r, r, r, r, torch.zeros(2, 64))
    with pytest.raises(ValueError):
        wk.wkv6(*(torch.zeros(1, 4, 2, 32, device=dev),) * 4,
                torch.zeros(2, 32, device=dev))
    with pytest.raises(ValueError):
        sk.ssd(r, torch.zeros(1, 4, 2, device=dev),
               torch.zeros(2, device=dev),
               *(torch.zeros(1, 4, 3, 64, device=dev),) * 2)


# (label, matrices in the stack, m, n, rank): gpt2-small's 12 layers of
# mlp/up (d 768, d_ff 3072) and one deepseek-moe-16b layer's 64 experts of
# gate (d 2048, d_ff_expert 1408), at ranks of their 0.4 rows
GAR_STACKS = [("gpt2 mlp/up", 12, 3072, 768, 410),
              ("deepseek experts/gate", 64, 1408, 2048, 470)]


@pytest.mark.parametrize("label,count,m,n,r", GAR_STACKS,
                         ids=[s[0] for s in GAR_STACKS])
def test_gar_transform_of_a_stack_equals_each_matrix_on_card(
        dev, label, count, m, n, r):
    """``gar_deploy`` hands ``gar_transform`` a leaf's matrices as one
    stack. On the card its float64 products (the tail ``U_p[r:] G`` and
    ``V_r U_p[:r]^T``) are batched and may take other cuBLAS kernels than
    one matrix's: the pivots are the same, and each factor lies within
    one float32 rounding of its own call's (a float64 difference of some
    1e-15 can only move a value across a rounding boundary)."""
    from repro_torch.core.gar import gar_transform
    rng = np.random.default_rng(count + r)
    full = min(m, n)
    u = _t(rng.standard_normal((count, m, full)).astype(np.float32), dev)
    v = _t(rng.standard_normal((count, n, full)).astype(np.float32), dev)
    stack = gar_transform(u, v, r)
    for i in sorted({0, 1, count // 2, count - 1}):
        one = gar_transform(u[i], v[i], r)
        assert torch.equal(stack.perm[i], one.perm), (label, i)
        for a, b in ((stack.u_hat[i], one.u_hat),
                     (stack.v_tilde[i], one.v_tilde)):
            torch.testing.assert_close(
                a, b, rtol=2.0 ** -23,
                atol=1e-12 * float(b.abs().max()))
