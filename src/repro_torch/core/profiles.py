"""Nested rank profiles: the (K, L) table of retained ranks per budget row
and factorized layer group, nested (``table[k-1] <= table[k]``
componentwise) by construction. Host-side numpy, as in the reference."""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

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
