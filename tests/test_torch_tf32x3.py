"""Why the low-rank kernels split their operands (3xTF32), and the tilings
their wrappers pick, on the CPU.

The two CUDA kernels (``kernels/csrc/lowrank_core.cuh``) run float32
products on the tensor cores as three TF32 products: ``big = rna(a)``,
``small = rna(a - big)``, ``big*small + small*big + big*big``. Here the
split is emulated in PyTorch on the float32 bits and run through GAR's two
products at gemma3-27b's width (T 8, n 5376). The tilings
(``gar_matmul.tiling``, ``lowrank_matmul.tiling``) are plain Python of the
shapes: these tests hold their coverage, their spread over the card's SMs
and the scratch they ask for, at the shapes ``chip_smoke.py`` times and at
ragged ones.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import gar_matmul as gk
from repro_torch.kernels import lowrank_matmul as lk
from repro_torch.kernels import tiles

TOL = 2e-4          # the kernels' tolerance, relative to the output's max


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32 bits: round the mantissa to 10 bits,
    ties away from zero (the sign bit is apart, so adding half of the 13
    dropped bits' range rounds the magnitude)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_big, b_big = tf32_rna(a), tf32_rna(b)
    a_small, b_small = tf32_rna(a - a_big), tf32_rna(b - b_big)
    return (a_big @ b_small + a_small @ b_big) + a_big @ b_big


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32_rna(a) @ tf32_rna(b)


def test_tf32_rna_rounds_to_ten_mantissa_bits():
    a = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 3.0,
                      1 + 3 * 2 ** -11], dtype=torch.float32)
    got = tf32_rna(a)
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 3.0,
                         1 + 2 * 2 ** -10], dtype=torch.float32)
    assert torch.equal(got, want)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(4096)
                        .astype(np.float32))
    big = tf32_rna(x)
    assert not bool((big.view(torch.int32) & 0x1FFF).any())
    assert float(((x - big).abs() / x.abs()).max()) <= 2 ** -11


@pytest.mark.parametrize("r", [512, 1024])
def test_tf32x3_meets_the_kernel_tolerance_where_tf32_does_not(r):
    """GAR's two products, z = x @ v_tilde and tail = z @ u_hat^T, at T 8
    and n 5376 against float64: the split stays within 2e-4 of the
    output's max, plain TF32 does not."""
    t, n, mt = 8, 5376, r
    rng = np.random.default_rng(r)
    x = torch.as_tensor(rng.standard_normal((t, n)).astype(np.float32))
    v = torch.as_tensor((rng.standard_normal((n, r)) / math.sqrt(n))
                        .astype(np.float32))
    u = torch.as_tensor((rng.standard_normal((mt, r)) / math.sqrt(r))
                        .astype(np.float32))
    z64 = x.double() @ v.double()
    y64 = torch.cat([z64, z64 @ u.double().T], dim=1)
    scale = float(y64.abs().max())
    errs = {}
    for name, mm in (("3xTF32", mm_tf32x3), ("TF32", mm_tf32)):
        z = mm(x, v)
        y = torch.cat([z, mm(z, u.T.contiguous())], dim=1)
        errs[name] = float((y.double() - y64).abs().max()) / scale
    assert errs["3xTF32"] < TOL / 100
    assert errs["TF32"] > TOL


# (t, n, r, m) of GAR calls: gpt2-small's projections at the serving T
# (decode 8, mixed 72) over ranks of its budget rows, gemma3-27b's mlp
# (gate at the 0.4 row and at full rank, down at full rank) at T 8 and 264,
# and the ragged shapes chip_smoke.py checks
GAR_SHAPES = (
    [(t, n, r, m) for t in (8, 72) for n, m in ((768, 768), (768, 3072),
                                                (3072, 768))
     for r in (1, 96, 410, 768) if r <= min(n, m)]
    + [(t, 5376, r, 21504) for t in (8, 264) for r in (2151, 5376)]
    + [(t, 21504, 5376, 5376) for t in (8, 264)]
    + [(33, 17, 7, 29), (100, 96, 40, 80), (5, 64, 64, 64),
       (19, 3072, 301, 768), (19, 5376, 3001, 21504), (5, 21504, 5376, 5376)])

# (t, n, kr, m) of low-rank calls: gpt2-small's projections at T 1024 over
# kept ranks, rwkv6-3b's channel/k and zamba2-7b's widest projection at
# full rank, and the ragged shapes (kept rank 0 among them)
LOWRANK_SHAPES = (
    [(1024, n, kr, m) for n, m in ((768, 768), (768, 3072), (3072, 768))
     for kr in (1, 200, 768)]
    + [(1024, 2560, 2560, 8960), (1024, 3584, 3584, 14336)]
    + [(33, 17, kr, 29) for kr in (0, 3, 7)]
    + [(70, 300, 129, 130), (45, 3584, 3001, 77), (40, 2560, 2560, 96)])


def _check_stage(st: tiles.Stage):
    """Every (weight column, token) of the stage lies in exactly one tile,
    and the splits of each tile cover the reduction exactly once; the grid
    fits the launch (clusters of up to 16, non-portable above 8; reduction
    chunks of whole pipeline steps)."""
    assert 1 <= st.split <= tiles.MAX_SPLIT and st.rows < 65536
    assert st.k_chunk % tiles.BK == 0
    assert (st.split - 1) * st.k_chunk < max(st.k, 1) <= st.split * st.k_chunk \
        or st.k == 0
    cover = np.zeros((st.m, st.t), np.int64)
    steps = {}
    for rows, toks, ks in st.tiles():
        steps.setdefault((rows.start, toks.start), []).append(ks)
        if ks.start == 0:
            cover[rows.start:rows.stop, toks.start:toks.stop] += 1
    assert (cover == 1).all()
    for ranges in steps.values():
        seen = np.zeros(st.k, np.int64)
        for ks in ranges:
            seen[ks.start:ks.stop] += 1
        assert (seen == 1).all()
    assert st.bn in tiles.TOKEN_TILES and st.bn * st.n_tiles >= st.t


@pytest.mark.parametrize("t,n,r,m", GAR_SHAPES)
def test_gar_tiling_covers_every_output_once(t, n, r, m):
    """Stage 1 covers z's r columns, stage 2 the m - r tail rows; with the
    identity copy (every block a share of ceil(t/8) x m work items, as the
    kernel strides them) each output of y is written exactly once; the
    scratch holds z and the tail's columns as the kernel indexes them."""
    plan = gk.tiling(t, n, r, m)
    mt = m - r
    assert (plan.stage1.m, plan.stage1.k, plan.stage2.m, plan.stage2.k) == \
        (r, n, mt, r)
    _check_stage(plan.stage1)
    _check_stage(plan.stage2)
    perm_inv = np.random.default_rng(t + r).permutation(m)
    writes = np.zeros((t, m), np.int64)
    tail_col = np.empty(mt, np.int64)
    tail_col[perm_inv[perm_inv >= r] - r] = np.nonzero(perm_inv >= r)[0]
    for rows, toks, ks in plan.stage2.tiles():
        if ks.start == 0:
            writes[toks.start:toks.stop, tail_col[rows.start:rows.stop]] += 1
    threads = plan.stage2.blocks * tiles.THREADS
    items = np.arange(-(-t // 8) * m)
    assert len(np.unique(items % threads)) == min(threads, len(items))
    for w in items:
        j, t0 = w % m, (w // m) * 8
        if perm_inv[j] < r:
            writes[t0:min(t, t0 + 8), j] += 1
    assert (writes == 1).all()
    assert plan.ldz % 4 == 0 and plan.ldz >= r
    assert plan.scratch_floats == t * plan.ldz + mt
    assert plan.scratch(torch.device("cpu")).numel() == \
        max(plan.scratch_floats, 1)


@pytest.mark.parametrize("t,n,kr,m", LOWRANK_SHAPES)
def test_lowrank_tiling_covers_every_output_once(t, n, kr, m):
    """Stage 1 covers the kr kept columns of z over n, stage 2 the m outputs
    over kr; the scratch holds z (t x ldz)."""
    plan = lk.tiling(t, n, kr, m)
    assert (plan.stage1.m, plan.stage1.k, plan.stage2.m, plan.stage2.k) == \
        (kr, n, m, kr)
    _check_stage(plan.stage1)
    _check_stage(plan.stage2)
    assert plan.ldz % 4 == 0 and plan.ldz >= kr
    assert plan.scratch_floats == t * plan.ldz
    assert plan.scratch(torch.device("cpu")).numel() == \
        max(plan.scratch_floats, 1)


@pytest.mark.parametrize("n,r,m", [(5376, 2151, 21504), (5376, 5376, 21504),
                                   (21504, 5376, 5376)])
def test_gemma_decode_streams_through_every_sm(n, r, m):
    """At a decode batch of 8, each product of gemma3's mlp spreads its
    weights over at least as many blocks as the H100 has SMs (132)."""
    plan = gk.tiling(8, n, r, m)
    assert plan.stage1.product_blocks >= tiles.SMS
    if m > r:
        assert plan.stage2.product_blocks >= tiles.SMS


def test_token_tiles():
    """Up to 64 tokens the least tile that holds them; above, 96 or 128 by
    the modelled time: gpt2-small's T 1024 stages take 96 (mlp/gate's first
    stage: 66 tiles split 2 ways fill the 132 SMs, where 48 tiles of 128
    leave 36 idle),
    rwkv6-3b's channel/k 128, gemma3's T 264 96 (3 tiles, not 3 mostly
    empty ones of 128)."""
    gate = [(768, 768), (3072, 768)]
    assert [tiles.token_tile(t, gate) for t in (1, 8, 9, 32, 33, 64)] == \
        [8, 8, 32, 32, 64, 64]
    assert tiles.token_tile(1024, gate) == 96
    assert tiles.token_tile(1024, [(768, 3072), (768, 768)]) == 96
    assert tiles.token_tile(1024, [(2560, 2560), (8960, 2560)]) == 128
    assert tiles.token_tile(264, [(5376, 5376), (16128, 5376)]) == 96


def test_split_keeps_clusters_that_fit_the_card():
    """The split of the reduction is the one of fewest modelled waves x
    steps, with the card's cluster occupancy: gemma3's decode gate at full
    rank splits 5 ways (210 blocks in one wave), not 6 (252 blocks of
    clusters of 6, of which 234 fit at once)."""
    st = gk.tiling(8, 5376, 5376, 21504).stage1
    assert (st.split, st.blocks) == (5, 210)
    assert len(tiles.CLUSTER_SLOTS) == len(tiles.TOKEN_TILES)
    for bn, slots in zip(tiles.TOKEN_TILES, tiles.CLUSTER_SLOTS):
        bps = 2 if bn <= 32 else 1
        assert len(slots) == tiles.MAX_SPLIT
        assert slots[0] == tiles.SMS * bps
        assert all(s <= tiles.SMS * bps for s in slots)


def test_split_follows_the_cards_occupancy():
    """The tiling follows the occupancy it is given (on the card, the
    card's own answer): a card that holds no cluster above 8 blocks gets
    no split above 8, and the same shapes still cover every output once."""
    small = tuple(tuple(s if c <= 8 else 0 for c, s in enumerate(row, 1))
                  for row in tiles.CLUSTER_SLOTS)
    for t, n, r, m in GAR_SHAPES:
        plan = gk.tiling(t, n, r, m, small)
        for st in (plan.stage1, plan.stage2):
            assert st.split <= 8
            _check_stage(st)
    assert gk.tiling(8, 21504, 5376, 5376).stage1.split > 8
    assert gk.tiling(8, 21504, 5376, 5376, small).stage1.split <= 8
