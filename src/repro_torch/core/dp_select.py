"""Dynamic-programming nested rank selection (paper Algorithms 2 & 3).

Solves the Multi-Choice Knapsack relaxation of Eq. (4): given, per layer,
candidate rank reductions ``(saving, error, rank)`` from independent layer
probing, find — for *every* attainable total saving — the minimum total
(additive) error assignment, Pareto-prune, backtrack the per-layer ranks, and
finally keep a componentwise-nested chain so masks satisfy
``m_{k-1} <= m_k`` (§3.2 "Nestedness").

Everything here is host-side numpy: it runs once per model, not per step.
Complexity O(L * K * |frontier|); the KeepMinErrorPerSaving compaction bounds
the frontier by the number of distinct attainable savings.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LayerCandidate:
    """One probed option for a layer: keep ``rank`` columns.

    saving: parameters saved vs the densest option (>= 0, integer-ish).
    error:  additive probe error incurred (>= 0).
    """

    saving: float
    error: float
    rank: int


@dataclasses.dataclass
class Profile:
    """A selected configuration: per-layer ranks + its totals."""

    ranks: Tuple[int, ...]
    saving: float
    error: float

    def dominates(self, other: "Profile") -> bool:
        return (self.saving >= other.saving and self.error <= other.error
                and (self.saving > other.saving or self.error < other.error))


def make_layer_candidates(
    error_curve: np.ndarray,
    cost_per_rank: float,
    *,
    num_levels: int,
    min_rank: int = 1,
) -> List[LayerCandidate]:
    """Build a layer's candidate list from its truncation error curve.

    ``error_curve[r-1]`` = probe error when keeping rank r (r = 1..R).
    ``cost_per_rank`` = parameters per retained rank column (m + n for a
    factorized linear). Candidates are ``num_levels`` rank levels spread
    uniformly in [min_rank, R] (the paper's ``U(r_l, K)`` grid), always
    including full rank (saving 0, error ~ 0).
    """
    full = len(error_curve)
    levels = np.unique(np.linspace(min_rank, full, num_levels).round().astype(int))
    out = []
    for r in levels:
        out.append(
            LayerCandidate(
                saving=float((full - r) * cost_per_rank),
                error=float(error_curve[r - 1]),
                rank=int(r),
            )
        )
    return out


# ---------------------------------------------------------------------------
# Algorithm 2/3 subroutines
# ---------------------------------------------------------------------------

def _expand_layer(frontier, cands):
    """EXPANDLAYER: cross every frontier state with every layer candidate."""
    out = []
    for i, (s_i, e_i) in enumerate(frontier):
        for c in cands:
            out.append((s_i + c.saving, e_i + c.error, i, c.rank))
    return out


def _keep_min_error_per_saving(states, *, quantize: float = 1.0):
    """KEEPMINERRORPERSAVING: one surviving state per distinct total saving.

    ``quantize`` buckets savings (in parameters) so float jitter can't blow up
    the frontier; 1.0 = exact integer parameter counts.
    """
    best: Dict[int, Tuple[float, float, int, int]] = {}
    for st in states:
        key = int(round(st[0] / quantize))
        if key not in best or st[1] < best[key][1]:
            best[key] = st
    return list(best.values())


def _pareto_prune(states):
    """PARETOPRUNE: keep states with strictly decreasing error as saving grows.

    Returns the pruned frontier [(saving, error)] (sorted by saving) and the
    per-state backpointers [(prev_index, rank)].
    """
    states = sorted(states, key=lambda st: st[0])
    frontier, back = [], []
    best_err = np.inf
    for st in reversed(states):  # scan from largest saving
        s, e, i, r = st
        if e < best_err:
            frontier.append((s, e))
            back.append((i, r))
            best_err = e
    frontier.reverse()
    back.reverse()
    return frontier, back


def _backtrack(frontier, backpointers_per_layer):
    """BACKTRACK: reconstruct per-layer rank vectors for each final state."""
    profiles = []
    num_layers = len(backpointers_per_layer)
    for idx, (s, e) in enumerate(frontier):
        ranks = [0] * num_layers
        h = idx
        for layer in range(num_layers - 1, -1, -1):
            h, r = backpointers_per_layer[layer][h]
            ranks[layer] = r
        profiles.append(Profile(ranks=tuple(ranks), saving=s, error=e))
    return profiles


def _pareto_filter(profiles: List[Profile]) -> List[Profile]:
    """PARETOFILTER: drop dominated (saving, error) profiles."""
    profiles = sorted(profiles, key=lambda p: p.saving)
    out, best_err = [], np.inf
    for p in reversed(profiles):
        if p.error < best_err:
            out.append(p)
            best_err = p.error
    out.reverse()
    return out


def _nested_chain(profiles: List[Profile]) -> List[Profile]:
    """NESTEDCHAIN: greedy componentwise-nested subsequence.

    Scan by increasing total rank; keep a profile iff its rank vector
    dominates (componentwise >=... note: *smaller* models keep fewer ranks, so
    chain is built from the smallest model upward requiring monotone growth).
    """
    profiles = sorted(profiles, key=lambda p: sum(p.ranks))
    chain: List[Profile] = []
    for p in profiles:
        if not chain or all(a <= b for a, b in zip(chain[-1].ranks, p.ranks)):
            chain.append(p)
    return chain


def dp_rank_selection(
    layer_candidates: Sequence[Sequence[LayerCandidate]],
    *,
    quantize: float = 1.0,
    max_frontier: int = 4096,
) -> List[Profile]:
    """Algorithm 2: full DP over layers -> componentwise-nested Pareto chain.

    ``max_frontier`` caps the frontier between layers (keep the lowest-error
    state in ``max_frontier`` uniform saving buckets) so worst-case growth is
    bounded on very deep models; the paper's exactness claim holds whenever
    the cap is not hit.
    """
    frontier = [(0.0, 0.0)]
    backpointers = []
    for cands in layer_candidates:
        expanded = _expand_layer(frontier, cands)
        compact = _keep_min_error_per_saving(expanded, quantize=quantize)
        if len(compact) > max_frontier:
            savings = np.array([st[0] for st in compact])
            lo, hi = savings.min(), savings.max()
            width = max((hi - lo) / max_frontier, quantize)
            compact = _keep_min_error_per_saving(compact, quantize=width)
        frontier, back = _pareto_prune(compact)
        backpointers.append(back)
    profiles = _backtrack(frontier, backpointers)
    profiles = _pareto_filter(profiles)
    return _nested_chain(profiles)


def select_profiles(chain: Sequence[Profile], budgets: Sequence[float], total_cost: float) -> List[Profile]:
    """SELECTPROFILES: best nested profile meeting each relative budget.

    ``budgets`` are relative sizes in (0, 1]; a profile meets budget b iff its
    retained cost ``total_cost - saving <= b * total_cost``. Picks the
    largest (lowest error) qualifying profile per budget.
    """
    out = []
    for b in budgets:
        feasible = [p for p in chain if total_cost - p.saving <= b * total_cost + 1e-9]
        if not feasible:
            feasible = [min(chain, key=lambda p: total_cost - p.saving)]
        out.append(min(feasible, key=lambda p: p.error))
    return out


def brute_force_selection(
    layer_candidates: Sequence[Sequence[LayerCandidate]],
) -> List[Profile]:
    """Exhaustive K^L reference used by tests to certify DP exactness."""
    import itertools

    profiles = []
    for combo in itertools.product(*layer_candidates):
        profiles.append(
            Profile(
                ranks=tuple(c.rank for c in combo),
                saving=sum(c.saving for c in combo),
                error=sum(c.error for c in combo),
            )
        )
    return _pareto_filter(profiles)
