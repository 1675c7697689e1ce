"""Tilings of the two low-rank kernels (``csrc/lowrank_core.cuh``).

Plain Python of the shapes alone, so the CPU tests reach it. A stage
computes ``C[i, t] = sum_k A[i, k] B[t, k]`` for ``M`` weight columns ``i``,
``T`` tokens ``t`` and a reduction of ``K``; its grid is (token tiles, rows
of 128 weight columns, splits of the reduction), a cluster per tile of
(1, 1, split). The split is the one of least modelled time: the waves of
blocks the card runs (its cluster occupancy, ``slots``, at once) times the
steps of 32 a block takes, plus ``OVERHEAD_STEPS`` for its pipeline fill
and split-K sum; each split keeps at least ``MIN_KSTEPS`` steps. On the
card the wrappers pass the card's own occupancy
(``lowrank_matmul.card_slots``); ``CLUSTER_SLOTS``, an H100 SXM's, is the
default the CPU tests tile with.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Sequence, Tuple

import torch

BM = 128           # weight columns of a block tile (csrc/lowrank_core.cuh)
BK = 32            # reduction steps of a pipeline stage
THREADS = 256
MAX_SPLIT = 16     # blocks of a cluster (non-portable above 8)
SMS = 132          # streaming multiprocessors of an H100 SXM
TOKEN_TILES = (8, 32, 64, 96, 128)
# A card's cluster occupancy: slots[i][s - 1] blocks of clusters of s blocks
# of the kernel of token tile TOKEN_TILES[i] that it holds at once
# (cudaOccupancyMaxActiveClusters times s; a cluster's blocks share a GPC,
# so sizes that divide its SMs badly leave SMs idle).
Slots = Tuple[Tuple[int, ...], ...]
# An H100 SXM's: two blocks an SM at token tiles 8 and 32, one from 64 (the
# shared memory of a wgmma tile; tests/test_torch_cuda_kernels.py holds it
# against the card's answer)
_ONE = (132, 132, 117, 120, 110, 102, 105, 120, 81, 70, 77, 84, 91, 98, 105,
        112)
_TWO = (264, 264, 237, 248, 235, 234, 224, 240, 207, 210, 176, 192, 182, 196,
        210, 224)
CLUSTER_SLOTS: Slots = (_TWO, _TWO, _ONE, _ONE, _ONE)
MIN_KSTEPS = 2
OVERHEAD_STEPS = 4


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def token_tile(t: int, shapes: Sequence[Tuple[int, int]],
               slots: Slots = CLUSTER_SLOTS) -> int:
    """The token tile of a call of ``t`` tokens whose stages compute
    ``shapes`` ((m, k) each): the least tile that holds ``t`` up to 64
    tokens; above, 96 or 128, whichever the modelled time (``cost``)
    prefers (128 on a tie)."""
    if t <= 64:
        return next(bn for bn in TOKEN_TILES if t <= bn)
    return min((128, 96), key=lambda bn: sum(
        cost(stage(m, k, t, bn, slots=slots), slots) for m, k in shapes))


@dataclasses.dataclass(frozen=True)
class Stage:
    """One launch: M weight columns by T tokens over a reduction of K."""
    m: int
    k: int
    t: int
    bn: int
    rows: int          # grid rows; those past the tiles do no product
    split: int
    k_chunk: int

    @property
    def m_tiles(self) -> int:
        return cdiv(self.m, BM)

    @property
    def n_tiles(self) -> int:
        return cdiv(self.t, self.bn)

    @property
    def blocks(self) -> int:
        return self.n_tiles * self.rows * self.split

    @property
    def product_blocks(self) -> int:
        """Blocks that stream weights (the others only copy)."""
        return self.n_tiles * min(self.rows, self.m_tiles) * self.split

    def tiles(self) -> Iterator[Tuple[range, range, range]]:
        """(weight columns, tokens, reduction range) of each product
        block, as the kernel derives them from its block index."""
        for z in range(self.split):
            k0 = z * self.k_chunk
            for y in range(min(self.rows, self.m_tiles)):
                for x in range(self.n_tiles):
                    yield (range(y * BM, min(self.m, (y + 1) * BM)),
                           range(x * self.bn, min(self.t, (x + 1) * self.bn)),
                           range(k0, min(self.k, k0 + self.k_chunk)))


def _waves_steps(tiles: int, ksteps: int, split: int, bn: int,
                 slots: Slots) -> float:
    """Waves of blocks the card runs, times the steps a block takes
    (infinite where the card holds no cluster of ``split``)."""
    held = slots[TOKEN_TILES.index(bn)][split - 1]
    if held < split:
        return math.inf
    return cdiv(tiles * split, held) * (cdiv(ksteps, split) + OVERHEAD_STEPS)


def cost(st: Stage, slots: Slots = CLUSTER_SLOTS) -> float:
    """Modelled time of a stage, in steps of a 128-token tile (a step of a
    narrower tile costs half a step plus its share of the other half)."""
    tiles = st.n_tiles * st.m_tiles
    if tiles == 0:
        return 0.0
    steps = _waves_steps(tiles, cdiv(st.k, BK), st.split, st.bn, slots)
    return steps * (0.5 + 0.5 * st.bn / 128)


def stage(m: int, k: int, t: int, bn: int, min_blocks: int = 1,
          slots: Slots = CLUSTER_SLOTS) -> Stage:
    """The tiling of one stage; ``min_blocks``: grid blocks wanted even
    where the product has fewer tiles (GAR's identity copy)."""
    n_tiles, m_tiles = cdiv(t, bn), cdiv(m, BM)
    tiles = n_tiles * m_tiles
    ksteps = cdiv(k, BK)
    most = max(1, min(MAX_SPLIT, ksteps // MIN_KSTEPS))
    split = min(range(1, most + 1), key=lambda s: _waves_steps(
        tiles, ksteps, s, bn, slots)) if tiles else 1
    k_chunk = cdiv(ksteps, split) * BK if ksteps else BK
    split = max(1, cdiv(k, k_chunk))
    rows = max(1, m_tiles, cdiv(min_blocks, n_tiles * split))
    return Stage(m, k, t, bn, rows, split, k_chunk)


def copy_blocks(t: int, m: int) -> int:
    """Blocks for GAR's identity copy: a work item is 8 tokens of one
    output column; some 8 items a thread, at most two blocks an SM."""
    return min(SMS * 2, cdiv(cdiv(t, 8) * m, THREADS * 8))


@dataclasses.dataclass(frozen=True)
class Tiling:
    """The two launches of a call and the scratch between them: stage 1
    writes z (t x ldz floats) into it; GAR's stage 1 also writes the tail's
    output columns (int32) after z."""
    stage1: Stage
    stage2: Stage
    ldz: int               # row stride of z in the scratch
    scratch_floats: int

    def scratch(self, device) -> torch.Tensor:
        """The scratch buffer a call allocates (at least one element, so
        that its pointer is valid)."""
        return torch.empty(max(self.scratch_floats, 1), dtype=torch.float32,
                           device=device)
