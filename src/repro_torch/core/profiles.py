"""Nested rank profiles: the (K, L) table of retained ranks per budget row
and factorized layer group, nested (``table[k-1] <= table[k]``
componentwise) by construction. Host-side numpy, as in the reference; the
rank masks are tensors on the device asked for (the table's, for
``masks_for_index``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import threefry
from repro_torch.core.dp_select import Profile


@dataclasses.dataclass(frozen=True)
class ProfileTable:
    """K nested budget profiles over named layer groups."""

    layer_names: Tuple[str, ...]
    table: np.ndarray            # (K, L) int32, nested: rows ascending
    budgets: Tuple[float, ...]   # relative sizes, ascending, len K
    max_ranks: Tuple[int, ...]   # (L,) full rank per layer group

    def __post_init__(self):
        t = self.table
        if t.ndim != 2 or t.shape[1] != len(self.layer_names):
            raise ValueError(f"table shape {t.shape} does not match "
                             f"{len(self.layer_names)} layer groups")
        if not np.all(np.diff(t, axis=0) >= 0):
            raise ValueError("profiles must be nested")
        if not np.all(t[-1] <= np.asarray(self.max_ranks)):
            raise ValueError("rank exceeds max")
        if not np.all(t >= 1):
            raise ValueError("every layer keeps at least rank 1")

    @property
    def num_budgets(self) -> int:
        return self.table.shape[0]

    def ranks_for(self, k: int) -> Dict[str, int]:
        return dict(zip(self.layer_names, self.table[k].tolist()))


def table_from_profiles(layer_names: Sequence[str],
                        profiles: Sequence[Profile],
                        budgets: Sequence[float],
                        max_ranks: Sequence[int]) -> ProfileTable:
    """Assemble a ProfileTable from DP ``Profile``s (already nested)."""
    rows = sorted(profiles, key=lambda p: sum(p.ranks))
    table = np.asarray([p.ranks for p in rows], np.int32)
    return ProfileTable(layer_names=tuple(layer_names), table=table,
                        budgets=tuple(budgets),
                        max_ranks=tuple(int(r) for r in max_ranks))


def uniform_table(layer_names: Sequence[str], max_ranks: Sequence[int],
                  budgets: Sequence[float]) -> ProfileTable:
    """Baseline: the same relative rank everywhere (no DP), rows made
    nested by a running maximum. ``--mode flexrank`` trains on it."""
    rows = [[max(1, int(round(b * r))) for r in max_ranks] for b in budgets]
    table = np.maximum.accumulate(np.asarray(rows, np.int32), axis=0)
    return ProfileTable(tuple(layer_names), table, tuple(budgets),
                        tuple(int(r) for r in max_ranks))


def rank_mask(rank: Union[torch.Tensor, int], full_rank: int,
              dtype=torch.float32, device=None) -> torch.Tensor:
    """0/1 mask over rank columns: ``mask[i] = 1`` iff ``i < rank``, on
    ``device`` (default: a tensor ``rank``'s)."""
    if device is None and isinstance(rank, torch.Tensor):
        device = rank.device
    return (torch.arange(full_rank, device=device) < rank).to(dtype)


def sample_profile_index(rng: threefry.Key, num_budgets: int,
                         weights: Optional[Sequence[float]] = None) -> int:
    """Sample a budget index k ~ alpha (paper Eq. 6), on the host, bit for
    bit the JAX package's draw for the same key: without weights
    ``jax.random.randint(rng, (), 0, num_budgets)``; with them
    ``jax.random.choice(rng, num_budgets, p=weights / sum)``, whose
    float32 arithmetic is redone here: the cumulative sums (each a
    sequential float32 sum, as XLA's windowed reduction forms them), ``r =
    total * (1 - u)`` for the key's uniform ``u``, and the first index
    whose cumulative sum reaches ``r``."""
    if weights is None:
        return threefry.randint(rng, 0, num_budgets)
    p = np.asarray(weights, np.float32)
    if p.shape != (num_budgets,):
        raise ValueError(f"{p.shape[0]} weights for {num_budgets} budgets")
    total = np.float32(0.0)
    for x in p:
        total = np.float32(total + x)
    p_cuml = np.cumsum(p / total, dtype=np.float32)
    u = np.float32(threefry.uniform(rng, ()).item())
    r = np.float32(p_cuml[-1] * np.float32(np.float32(1.0) - u))
    return int(np.searchsorted(p_cuml, r, side="left"))


def masks_for_index(table: torch.Tensor, k: Union[torch.Tensor, int],
                    max_ranks: Sequence[int]) -> List[torch.Tensor]:
    """Per-layer-group masks for budget index ``k`` of the (K, L) rank
    ``table`` (a tensor; the masks on its device), each of shape
    ``(max_ranks[l],)``."""
    ranks = table[k]
    return [rank_mask(ranks[l], full) for l, full in enumerate(max_ranks)]


def rank_slice(u: torch.Tensor, v: torch.Tensor, rank: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static truncation of a factor pair to its first ``rank`` columns."""
    return u[..., :rank], v[..., :rank]


def profile_param_cost(table: ProfileTable,
                       costs_per_rank: Sequence[float]) -> np.ndarray:
    """Retained factor parameters per budget row: ``sum_l r_{k,l} * (m_l +
    n_l)`` with ``costs_per_rank[l] = m_l + n_l``."""
    c = np.asarray(costs_per_rank, np.float64)
    return (table.table.astype(np.float64) * c[None, :]).sum(axis=1)
