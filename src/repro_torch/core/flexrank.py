"""FlexRank orchestrator: paper Algorithm 1 end to end.

  1. ``factorized_spec``     - rewrite eligible dense leaves to (u, v) pairs
  2. ``collect_moments``     - calibration pass with activation taps
  3. ``decompose``           - DataSVD init of every factor pair (plain SVD
                               where no moment was recorded)
  4. ``build_table``         - DP nested rank selection over the curves
  5. ``make_consolidation_loss`` - stochastic nested-mask distillation
  6. ``gar_deploy``          - gauge-aligned deploy params at one budget

Rank granularity: a factorized *group* covers all the layers of a stacked
leaf with one rank; gpt2-small gives every layer its own segment, so every
linear is its own group.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch import threefry
from repro_torch.core import datasvd, distill, dp_select
from repro_torch.core.covariance import sqrt_and_inv_sqrt
from repro_torch.core.gar import gar_transform
from repro_torch.core.profiles import ProfileTable, table_from_profiles
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm

PyTree = Any

_SCAN_AXIS = cm.LAYERS


def _eligible(cfg: ModelConfig):
    excl = cfg.flexrank.exclude

    def predicate(path: str, spec) -> bool:
        return not any(tok in path for tok in excl)

    return predicate


def factorized_spec(cfg: ModelConfig) -> PyTree:
    fr = cfg.flexrank
    return cm.factorize_spec(tfm.model_spec(cfg), predicate=_eligible(cfg),
                             max_rank_fn=lambda p, s: fr.max_rank)


@dataclasses.dataclass
class GroupInfo:
    path: str
    scan_dims: Tuple[int, ...]   # leading LAYERS-axis dims (rank leaf shape)
    lead_dims: Tuple[int, ...]   # all leading dims of the dense leaf
    m: int                       # d_out
    n: int                       # d_in
    full_rank: int
    col: int                     # DP column index


def group_infos(cfg: ModelConfig) -> List[GroupInfo]:
    infos: List[GroupInfo] = []

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            if {"u", "v"} <= set(tree.keys()) and cm.is_spec(tree.get("u")):
                u, v = tree["u"], tree["v"]
                scan_dims = []
                for dim, ax in zip(u.shape, u.axes):
                    if ax != _SCAN_AXIS:
                        break
                    scan_dims.append(dim)
                infos.append(GroupInfo(
                    path=prefix, scan_dims=tuple(scan_dims),
                    lead_dims=tuple(u.shape[:-2]), m=u.shape[-2],
                    n=v.shape[-2], full_rank=u.shape[-1], col=len(infos)))
                return
            for k, v_ in tree.items():
                walk(v_, f"{prefix}/{k}" if prefix else k)
        elif isinstance(tree, (list, tuple)):
            for i, v_ in enumerate(tree):
                walk(v_, f"{prefix}/{i}" if prefix else str(i))

    walk(factorized_spec(cfg))
    return infos


def _lead_indices(lead: Tuple[int, ...]):
    return np.ndindex(*lead) if lead else [()]


def collect_moments(params: PyTree, cfg: ModelConfig,
                    batches: Sequence[Dict], *,
                    frontend_fn: Optional[Callable] = None
                    ) -> Dict[str, list]:
    """Calibration pass: the forward over each batch's inputs with the taps
    on; returns ``{tap_key: [moment, count]}``, the moments float32 on the
    parameters' device. Tap keys are parameter paths with the layer index
    inside a segment marked "@l" ("segments/0/@3/attn/q").

    ``frontend_fn(batch)`` gives the batch's frontend embeddings (numpy or
    a tensor) for the audio and vision families; without it (the
    launchers) calibration is text-only: the encoder and the cross blocks
    record no moment, and ``decompose`` gives their groups plain SVD.
    ``frontend_proj`` records none either way, as in the reference."""
    store: Dict[str, list] = {}
    device = cm.tree_leaves(params)[0].device
    with torch.no_grad(), cm.tap_recording(store):
        for batch in batches:
            tokens = torch.as_tensor(np.asarray(batch["tokens"])[:, :-1],
                                     device=device)
            frontend = None
            if frontend_fn is not None:
                frontend = frontend_fn(batch)
                if not isinstance(frontend, torch.Tensor):
                    frontend = torch.from_numpy(np.asarray(frontend))
                frontend = frontend.to(device)
            tfm.forward(params, cfg, tokens, frontend=frontend)
    return store


def plain_svd_groups(cfg: ModelConfig, moments: Dict[str, list]
                     ) -> List[str]:
    """The factorized groups that no recorded moment covers: ``decompose``
    gives them plain SVD (a text-only calibration's encoder, cross blocks
    and ``frontend_proj``)."""
    covered = set(_index_moments(moments))
    return [i.path for i in group_infos(cfg) if i.path not in covered]


_AT = re.compile(r"^@(\d+)$")


def _index_moments(store: Dict[str, list]
                   ) -> Dict[str, Dict[Tuple[int, ...], list]]:
    """tap key -> (group path, layer index tuple) inverted index."""
    out: Dict[str, Dict[Tuple[int, ...], list]] = {}
    for key, ent in store.items():
        toks, idx = [], []
        for t in key.split("/"):
            m = _AT.match(t)
            if m:
                idx.append(int(m.group(1)))
            else:
                toks.append(t)
        out.setdefault("/".join(toks), {})[tuple(idx)] = ent
    return out


def decompose(dense_params: PyTree, cfg: ModelConfig,
              moments: Optional[Dict[str, list]] = None, *,
              damping: float = 1e-6
              ) -> Tuple[PyTree, Dict[str, np.ndarray]]:
    """DataSVD-initialized factorized params from dense params, on the
    device of the dense leaves; plain SVD per leaf where no moment was
    recorded. Returns (factorized params, error curves):
    ``curves[group_path][r-1]`` is the whitened tail energy of keeping rank
    r, summed over the group's layers (the DP's input). The arithmetic of
    the curve is the reference's, in numpy on the host. The leaves that
    share one moment (the experts of an MoE layer: the tap flattens
    (B, E, C, d)) share its whitening, computed once."""
    params = cm.tree_map(lambda x: x, dense_params)
    midx = _index_moments(moments or {})
    curves: Dict[str, np.ndarray] = {}
    for info in group_infos(cfg):
        w = cm.tree_get(dense_params, info.path)["w"].to(torch.float32)
        lead = info.lead_dims
        r_full = info.full_rank
        u_out = torch.zeros(lead + (info.m, r_full), dtype=torch.float32,
                            device=w.device)
        v_out = torch.zeros(lead + (info.n, r_full), dtype=torch.float32,
                            device=w.device)
        curve = np.zeros(r_full, np.float64)
        group_moments = midx.get(info.path, {})
        white_key, whitening = None, None
        for idx in _lead_indices(lead):
            key = tuple(idx[: len(info.scan_dims)])
            ent = group_moments.get(key)
            w_paper = w[idx].T                     # (m, n): y = W x
            if ent is not None:
                if key != white_key:
                    white_key, whitening = key, sqrt_and_inv_sqrt(
                        ent[0].to(w.device), ent[1], damping=damping)
                f = datasvd.datasvd_factors(w_paper, whitening,
                                            max_rank=r_full)
            else:
                f = datasvd.plain_svd_factors(w_paper, max_rank=r_full)
            rr = f.u.shape[1]
            u_out[idx][:, :rr] = f.u
            v_out[idx][:, :rr] = f.v
            u_np = f.u.cpu().numpy()
            # |u_j|^2 = lambda_j (sqrt(lambda) absorbed symmetrically; the v
            # columns carry Sigma^{-1/2} and are not orthonormal)
            lam2 = ((u_np * u_np).sum(0)) ** 2
            tail = lam2[::-1].cumsum()[::-1]
            c = np.zeros(r_full)
            c[:rr] = np.concatenate([tail[1:], [0.0]])
            curve += c
        cm.tree_set(params, info.path, {"u": u_out, "v": v_out})
        curves[info.path] = curve
    return params, curves


def build_table(cfg: ModelConfig, curves: Dict[str, np.ndarray]
                ) -> Tuple[ProfileTable, List[GroupInfo]]:
    """DP nested rank selection over the curves -> profile table."""
    infos = group_infos(cfg)
    cands, names, max_ranks, costs = [], [], [], []
    for info in infos:
        n_lead = int(np.prod(info.lead_dims)) if info.lead_dims else 1
        cost_per_rank = float((info.m + info.n) * n_lead)
        cands.append(dp_select.make_layer_candidates(
            curves[info.path], cost_per_rank,
            num_levels=cfg.flexrank.rank_levels))
        names.append(info.path)
        max_ranks.append(info.full_rank)
        costs.append(cost_per_rank)
    chain = dp_select.dp_rank_selection(cands)
    total = float(np.dot(costs, max_ranks))
    picked = dp_select.select_profiles(chain, cfg.flexrank.budgets, total)
    seen, rows = set(), []
    for p in picked:                  # dedupe, keeping nestedness and order
        if p.ranks not in seen:
            rows.append(p)
            seen.add(p.ranks)
    table = table_from_profiles(names, rows,
                                cfg.flexrank.budgets[: len(rows)], max_ranks)
    return table, infos


def table_host(table: ProfileTable) -> np.ndarray:
    """The profile table as the training loop reads it: a host int array,
    so a row's ranks are Python ints and no projection syncs with the
    card (the reference's ``table_device`` keeps it on the device for
    ``jit``)."""
    return np.asarray(table.table, np.int32)


def ranks_tree(cfg: ModelConfig, infos: List[GroupInfo],
               table_rows: np.ndarray, k: int) -> Dict:
    """Nested ranks tree (mirrors the params) for budget row ``k``: one
    Python int per factorized group, shared by the group's layers."""
    row = table_rows[int(k)]
    tree: Dict = {}
    for info in infos:
        _nested_set(tree, info.path, int(row[info.col]))
    return tree


def _nested_set(tree: Dict, path: str, value) -> None:
    toks = path.split("/")
    cur = tree
    for a, b in zip(toks[:-1], toks[1:]):
        child = [] if b.isdigit() else {}
        if isinstance(cur, list):
            i = int(a)
            while len(cur) <= i:
                cur.append(None)
            if cur[i] is None:
                cur[i] = child
            cur = cur[i]
        else:
            cur = cur.setdefault(a, child)
    last = toks[-1]
    if isinstance(cur, list):
        while len(cur) <= int(last):
            cur.append(None)
        cur[int(last)] = value
    else:
        cur[last] = value


def budget_draw(rng: threefry.Key, num_k: int) -> int:
    """The budget row of one consolidation step:
    ``jax.random.randint(rng, (), 0, num_k)``, bit for bit, on the host."""
    return threefry.randint(rng, 0, num_k)


def make_consolidation_loss(cfg: ModelConfig, infos: List[GroupInfo],
                            table_rows: np.ndarray, teacher_params: PyTree
                            ) -> Callable:
    """Returns ``loss_fn(params, batch, rng) -> (loss, metrics)``: draw a
    budget row k from the host key ``rng``, run the student at row k's
    ranks and the teacher (under ``no_grad``), and distill (Eq. 5/6).
    ``batch['tokens']``: (B, S + 1) on the params' device."""
    num_k = table_rows.shape[0]

    def loss_fn(params, batch, rng):
        tokens = batch["tokens"][:, :-1]
        labels = batch["tokens"][:, 1:]
        k = budget_draw(rng, num_k)
        ranks = ranks_tree(cfg, infos, table_rows, k)
        student_logits, aux = tfm.forward(params, cfg, tokens, ranks=ranks)
        with torch.no_grad():
            teacher_logits, _ = tfm.forward(teacher_params, cfg, tokens)
        loss = distill.consolidation_loss(
            student_logits, teacher_logits, labels,
            kd_weight=cfg.flexrank.kd_weight,
            temperature=cfg.flexrank.kd_temperature, vocab=cfg.vocab_size)
        return loss + aux, {"loss": loss.detach(), "budget_k": k}

    return loss_fn


def eval_budget_loss(params, cfg, infos, table_rows, batch, k: int) -> float:
    """Cross-entropy of budget row ``k`` on one batch (no gradients)."""
    tokens = batch["tokens"][:, :-1]
    labels = batch["tokens"][:, 1:]
    ranks = ranks_tree(cfg, infos, table_rows, k)
    with torch.no_grad():
        logits, _ = tfm.forward(params, cfg, tokens, ranks=ranks)
        return float(distill.cross_entropy(logits, labels,
                                           vocab=cfg.vocab_size))


# float64 bytes of a GAR transform call's working copies (some 3 m r for U
# and 2 n r for V a matrix): a group's layers, or an MoE layer's experts,
# are transformed in stacks of at most this much, so small matrices share
# one pivot loop and large ones stay within memory
_GAR_BATCH_BYTES = 4 << 30


def gar_deploy(params_fact: PyTree, cfg: ModelConfig,
               infos: List[GroupInfo], table: ProfileTable, k: int) -> PyTree:
    """Deployable params at budget row ``k``: every factorized leaf becomes
    ``{u_hat, v_tilde, perm_inv}`` (stacked over its lead dims; ``perm_inv``
    int64), computed on the device of the factors, the leaf's matrices in
    batches of ``gar_transform``. ``common.linear`` dispatches on
    ``u_hat``."""
    params = cm.tree_map(lambda x: x, params_fact)
    row = table.table[k]
    for info in infos:
        leaf = cm.tree_get(params_fact, info.path)
        lead = info.lead_dims
        u = leaf["u"].reshape((-1,) + leaf["u"].shape[-2:])
        v = leaf["v"].reshape((-1,) + leaf["v"].shape[-2:])
        r = int(row[info.col])
        step = max(1, _GAR_BATCH_BYTES
                   // max((3 * info.m + 2 * info.n) * r * 8, 1))
        parts = [gar_transform(u[i:i + step], v[i:i + step], r)
                 for i in range(0, u.shape[0], step)]
        cm.tree_set(params, info.path, {
            "u_hat": torch.cat([g.u_hat for g in parts]).reshape(
                lead + (info.m - r, r)),
            "v_tilde": torch.cat([g.v_tilde for g in parts]).reshape(
                lead + (info.n, r)),
            "perm_inv": torch.cat([torch.argsort(g.perm, dim=-1)
                                   for g in parts]).reshape(lead + (info.m,))})
    return params


def is_nested_prefix(table: ProfileTable, draft_row: int,
                     target_row: int) -> bool:
    """True iff ``draft_row``'s ranks are a componentwise prefix of
    ``target_row``'s."""
    t = table.table
    return bool(np.all(t[draft_row] <= t[target_row]))


def nested_prefix_row(table: ProfileTable, target_row: int, budget: float,
                      cost_table: Optional[np.ndarray] = None
                      ) -> Optional[int]:
    """Largest row strictly below ``target_row`` whose deployed cost stays
    within ``budget`` (fraction of the top row) and whose ranks are a nested
    prefix of the target row's; ``None`` when none fits."""
    if target_row <= 0:
        return None
    if cost_table is None:
        cost_table = table.table.sum(axis=1)
    cost_table = np.asarray(cost_table, np.float64)
    full = float(cost_table[-1])
    for row in range(target_row - 1, -1, -1):
        if not is_nested_prefix(table, row, target_row):
            continue
        if cost_table[row] <= budget * full + 1e-9:
            return row
    return None


def deployed_param_count(cfg: ModelConfig, infos: List[GroupInfo],
                         table: ProfileTable, k: int) -> int:
    """Parameters of the budget-k realization (GAR form, identity not
    stored)."""
    dense_total = cm.param_count(tfm.model_spec(cfg))
    fact_full = 0
    fact_at_k = 0
    for info in infos:
        n_lead = int(np.prod(info.lead_dims)) if info.lead_dims else 1
        r = int(table.table[k][info.col])
        fact_full += n_lead * info.m * info.n
        fact_at_k += n_lead * (info.m + info.n - r) * r
    return dense_total - fact_full + fact_at_k
