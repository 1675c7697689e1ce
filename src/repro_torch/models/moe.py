"""Mixture-of-Experts FFN: top-k routing, capacity-bounded gather dispatch,
shared experts and the load-balancing aux loss.

Dispatch is the reference's, sort-free: top-k routing picks expert ids
per token, a running count per expert (token-major over the ``S * K``
(token, choice) pairs) assigns capacity slots, and the pairs past an
expert's capacity are dropped. Capacity is a host int from the shape,
``max(ceil(S * top_k * cf / E), 4)``, per batch row. Every step is a
device op on device indices (comparisons, ``cumsum``, ``gather``,
``index_put_``): nothing is read back to the host.

The shared experts are cut over 'model' as a dense FFN is
(``models/tp.py``); the router is held whole.

Expert weights carry a leading ``experts`` axis; FlexRank factorizes each
expert's (d_in, d_out) pair along it, so a factorized or GAR leaf holds
one factor pair per expert. The expert products are batched ``einsum``s,
as the reference leaves them to XLA; the shared experts go through
``common.linear`` like every other projection.

``moe_apply`` runs a 'model' rank's ``E / n`` experts as XLA partitions
the reference's global dispatch (the cached steps' path): every rank
routes all tokens, runs its experts' slots and the routed output is
summed over the axis.

``moe_apply_ep`` is the reference's expert-parallel path, which the
attention block takes for every uncached call of more than one token:
each rank of the 'model' axis routes its own contiguous chunk of the
sequence, two all-to-alls carry the (expert, slot) buffers to the ranks
that hold the experts and back, and each rank runs its ``E / n_model``
experts (``distributed.collectives`` has the backward of each step).
Without a mesh, or where the sizes do not divide, it is ``moe_apply``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.meshctx import data_axes, get_current_mesh
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import tp
from repro_torch.models.common import ParamSpec, linear


def moe_spec(cfg: ModelConfig) -> Dict:
    assert cfg.moe is not None
    d, m = cfg.d_model, cfg.moe
    spec: Dict = {
        "router": {"w": ParamSpec((d, m.num_experts), (cm.EMBED, None))},
        "experts": {
            "gate": {"w": ParamSpec((m.num_experts, d, m.d_ff_expert),
                                    (cm.EXPERTS, cm.EMBED, cm.MLP))},
            "up": {"w": ParamSpec((m.num_experts, d, m.d_ff_expert),
                                  (cm.EXPERTS, cm.EMBED, cm.MLP))},
            "down": {"w": ParamSpec((m.num_experts, m.d_ff_expert, d),
                                    (cm.EXPERTS, cm.MLP, cm.EMBED))},
        },
    }
    if m.num_shared:
        f_sh = m.d_ff_shared or m.d_ff_expert
        spec["shared"] = {
            "gate": {"w": ParamSpec((d, m.num_shared * f_sh),
                                    (cm.EMBED, cm.MLP))},
            "up": {"w": ParamSpec((d, m.num_shared * f_sh),
                                  (cm.EMBED, cm.MLP))},
            "down": {"w": ParamSpec((m.num_shared * f_sh, d),
                                    (cm.MLP, cm.EMBED))},
        }
    return spec


def expert_linear(p: Dict, x: torch.Tensor, *, rank: Optional[int] = None,
                  tap: Optional[str] = None) -> torch.Tensor:
    """Batched per-expert linear: x (B, E, C, d_in) @ W (E, d_in, d_out).

    dense:      p = {'w': (E, d_in, d_out)}
    factorized: p = {'v': (E, d_in, r), 'u': (E, d_out, r)}; columns >=
                ``rank`` (a Python int) are masked out
    gar:        p = {'v_tilde': (E, d_in, r), 'u_hat': (E, d_out - r, r),
                 'perm_inv': (E, d_out)}
    """
    cm.record_tap(tap, x)
    if "w" in p:
        return torch.einsum("becd,edf->becf", x, p["w"].to(x.dtype))
    if "u_hat" in p:
        z = torch.einsum("becd,edr->becr", x, p["v_tilde"].to(x.dtype))
        tail = torch.einsum("becr,efr->becf", z, p["u_hat"].to(x.dtype))
        y = torch.cat([z, tail], dim=-1)
        perm = p["perm_inv"][None, :, None, :].expand(y.shape)
        return torch.gather(y, -1, perm)
    z = torch.einsum("becd,edr->becr", x, p["v"].to(x.dtype))
    if rank is not None:
        keep = torch.arange(z.shape[-1], device=z.device) < rank
        z = z * keep.to(z.dtype)
    return torch.einsum("becr,efr->becf", z, p["u"].to(x.dtype))


def _shared(p: Dict, x: torch.Tensor, cfg: ModelConfig, r: Dict
            ) -> torch.Tensor:
    """The shared experts: one gated MLP of ``num_shared`` experts' width,
    cut over 'model' as the dense FFN is (``models/tp.py``)."""
    m = cfg.moe
    with cm.tap_scope("shared"):
        return attn.ffn_apply(
            p, x, d_ff=m.num_shared * (m.d_ff_shared or m.d_ff_expert),
            ranks=r.get("shared"))


def capacity(cfg: ModelConfig, s: int) -> int:
    """Slots per expert of one batch row of ``s`` tokens."""
    m = cfg.moe
    return max(int(math.ceil(s * m.top_k * m.capacity_factor
                             / m.num_experts)), 4)


def route(probs: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the ``top_k`` largest values
    and their indices, the lower index first among equal values (a stable
    descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :top_k], idx[..., :top_k]


def assign_slots(top_e: torch.Tensor, num_experts: int, cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity slots of a batch of routed pairs. top_e: (B, S, K) expert
    ids. Returns (flat_slot, keep), each (B, S * K): the pair's place in
    its expert's queue (pairs token-major: a running count per expert)
    and whether it is within ``cap``."""
    b = top_e.shape[0]
    flat_e = top_e.reshape(b, -1)
    onehot = (flat_e[..., None] == torch.arange(
        num_experts, device=top_e.device)).to(torch.int32)      # (B, SK, E)
    counts = torch.cumsum(onehot, dim=1)
    flat_slot = torch.gather(counts, -1, flat_e[..., None])[..., 0] - 1
    return flat_slot, flat_slot < cap


def moe_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
              ranks: Optional[Dict] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss). x: (B, S, D).

    Dispatch is row-local: every batch row assigns its own capacity
    slots, so in the paged forward's flat batch (1, T, D) the tokens of
    one iteration (pads last) compete for the same slots. A dropped pair
    is scattered to a sentinel row past the slots and gathered back from
    slot 0 with a gate of 0.

    The expert leaves may hold a 'model' rank's ``E / n`` experts (the
    reference's placement, which XLA partitions at the dispatch): every
    rank routes and dispatches over all E alike, runs its experts' slice
    of the slots, combines the pairs those served (the others at a gate
    of 0) and sums the routed output over the axis; the gates and the
    dispatched tokens take their gradient summed over it."""
    m = cfg.moe
    r = ranks or {}
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    dev = x.device
    held = cm.tree_leaves(p["experts"])[0].shape[0]
    group, n, i = tp.axis()
    if held != e and held * n != e:
        raise ValueError(f"moe_apply holds {held} of {e} experts on {n} "
                         "'model' ranks: neither all nor a rank's part")
    lo = i * held if held != e else 0

    gate_logits = linear(p["router"], x.float())                # (B, S, E)
    probs = torch.softmax(gate_logits, dim=-1)
    top_p, top_e = route(probs, k)                              # (B, S, K)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    cap = capacity(cfg, s)
    flat_e = top_e.reshape(b, s * k)
    flat_slot, keep = assign_slots(top_e, e, cap)
    flat_gate = top_p.reshape(b, s * k) * keep.to(top_p.dtype)

    # dispatch: ex_in[b, e, c] = x[b, the token assigned to (e, c)]
    sentinel = e * cap
    dest = flat_e * cap + torch.where(keep, flat_slot,
                                      torch.full_like(flat_slot, cap))
    token_idx = torch.arange(s * k, device=dev) // k            # (SK,)
    src = torch.index_select(x, 1, token_idx)                   # (B, SK, D)
    rows = torch.arange(b, device=dev)[:, None]
    ex_in = torch.zeros((b, sentinel + 1, d), dtype=x.dtype, device=dev)
    ex_in[rows, torch.where(keep, dest, torch.full_like(dest, sentinel))] = src
    ex_in = ex_in[:, :-1].reshape(b, e, cap, d)
    if held != e:
        # this rank's experts' slots; the pairs of the others' at a gate
        # of 0
        ex_in = C.reduce_grad(ex_in, group)[:, lo:lo + held]
        mine = (flat_e >= lo) & (flat_e < lo + held)
        flat_gate = C.reduce_grad(flat_gate, group) * mine.to(
            flat_gate.dtype)
        dest = torch.where(mine, dest - lo * cap, torch.zeros_like(dest))

    h = cm.swiglu(
        expert_linear(p["experts"]["gate"], ex_in,
                      rank=cm.rget(r, "experts", "gate"), tap="experts/gate"),
        expert_linear(p["experts"]["up"], ex_in,
                      rank=cm.rget(r, "experts", "up"), tap="experts/up"))
    ex_out = expert_linear(p["experts"]["down"], h,
                           rank=cm.rget(r, "experts", "down"),
                           tap="experts/down")
    ex_out = ex_out.reshape(b, held * cap, d)

    # combine: gather back per (token, choice) pair and sum over choices
    back = torch.where(keep, dest, torch.zeros_like(dest))
    gathered = torch.gather(ex_out, 1, back[..., None].expand(b, s * k, d))
    gathered = gathered * flat_gate[..., None].to(ex_out.dtype)
    out = gathered.reshape(b, s, k, d).sum(dim=2)
    if held != e:
        out = C.reduce_from(out, group)
    out = out.to(x.dtype)

    if m.num_shared:
        out = out + _shared(p["shared"], x, cfg, r)

    # load-balance aux (Switch-style): E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))                                 # (E,)
    ce = (top_e[..., 0, None] == torch.arange(e, device=dev)).float().mean(
        dim=(0, 1))
    aux = e * torch.sum(me * ce) * m.router_aux_weight
    return out, aux


# ---------------------------------------------------------------------------
# the expert-parallel path
# ---------------------------------------------------------------------------

def _moe_inner(x_col: torch.Tensor, router_w: torch.Tensor, experts: Dict,
               ranks: Dict, cfg: ModelConfig, group
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's per-rank body. x_col: (Tc, d), this rank's tokens;
    ``experts``: this rank's ``E / n`` experts; ``group``: the 'model'
    ranks (None for one). Returns (out (Tc, d), aux: the mean over the
    ranks of each one's load-balancing loss)."""
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    tc, d = x_col.shape
    n = 1 if group is None else torch.distributed.get_world_size(group)
    e_loc = e // n

    probs = torch.softmax(x_col.float() @ router_w, dim=-1)       # (Tc, E)
    top_p, top_e = route(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # capacity of this slice's tokens, not of a batch row
    cap = max(int(math.ceil(tc * k * m.capacity_factor / e)), 4)
    flat_e = top_e.reshape(-1)                                    # (Tc*K,)
    slot, keep = (t[0] for t in assign_slots(top_e[None], e, cap))
    gate = top_p.reshape(-1) * keep.to(top_p.dtype)
    dest = flat_e * cap + torch.where(keep, slot, torch.full_like(slot, cap))
    token_idx = torch.arange(tc * k, device=x_col.device) // k
    ex_in = torch.zeros((e * cap + 1, d), dtype=x_col.dtype,
                        device=x_col.device)
    ex_in[torch.where(keep, dest, torch.full_like(dest, e * cap))] = \
        x_col[token_idx]
    ex_in = ex_in[:-1].reshape(e, cap, d)

    # exchange: (E, C, d) -> (E_loc, C * n, d), rank j's slots j-th
    ex_in = C.all_to_all(ex_in, group).reshape(n, e_loc, cap, d)
    ex_in = ex_in.transpose(0, 1).reshape(1, e_loc, n * cap, d)
    h = cm.swiglu(
        expert_linear(experts["gate"], ex_in, rank=ranks.get("gate")),
        expert_linear(experts["up"], ex_in, rank=ranks.get("up")))
    ex_out = expert_linear(experts["down"], h, rank=ranks.get("down"))
    # return exchange: (E_loc, C * n, d) -> (E, C, d)
    ex_out = ex_out.reshape(e_loc, n, cap, d).transpose(0, 1)
    ex_out = C.all_to_all(ex_out.contiguous(), group).reshape(e * cap, d)

    back = torch.where(keep, dest, torch.zeros_like(dest))
    gathered = ex_out[back] * gate[:, None].to(ex_out.dtype)
    out = gathered.reshape(tc, k, d).sum(dim=1)

    me = probs.mean(dim=0)
    ce = (top_e[:, 0, None] == torch.arange(e, device=x_col.device)
          ).float().mean(dim=0)
    aux = C.mean(e * torch.sum(me * ce) * m.router_aux_weight, group)
    return out.to(x_col.dtype), aux


def moe_apply_ep(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                 ranks: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel MoE of the current mesh (training and prefill).
    x: (B, S, D), this rank's batch rows; the expert leaves of ``p`` hold
    this rank's ``E / n_model`` experts. Tokens split over 'model' by
    contiguous sequence chunks, each chunk's (B, S / n_model) tokens one
    slice; the shared experts run on the full ``x``. Returns (output,
    aux_loss). Falls back to ``moe_apply`` (over the rank's experts where
    they are cut) without a mesh or a 'model' axis, or where the sizes do
    not divide, as the reference does."""
    mesh = get_current_mesh()
    m = cfg.moe
    b, s, d = x.shape
    if mesh is None or "model" not in mesh.axis_names:
        return moe_apply(p, x, cfg, ranks=ranks)
    n_model = mesh.shape["model"]
    n_data = mesh.size(data_axes(mesh))
    group = mesh.group("model")
    # the reference's guard, over its global batch (b * n_data rows). Its
    # in_specs split s itself over 'model', so a shape that passes with
    # s % n_model != 0 fails there as here: the tests hold shapes where
    # both divide
    if m.num_experts % n_model or (b * n_data * s) % (n_data * n_model):
        return moe_apply(p, x, cfg, ranks=ranks)
    if s % n_model:
        raise ValueError(f"sequence {s} does not split over {n_model} "
                         "'model' ranks")
    held = cm.tree_leaves(p["experts"])[0].shape[0]
    if held * n_model != m.num_experts:
        raise ValueError(f"moe_apply_ep runs this rank's {m.num_experts} / "
                         f"{n_model} experts, not {held}")
    r = ranks or {}
    x_col = C.scatter(x, 1, group)                    # (B, S / n, D)
    bl, sl, _ = x_col.shape
    out, aux = _moe_inner(
        x_col.reshape(bl * sl, d),
        C.reduce_grad(p["router"]["w"].float(), group), p["experts"],
        {k: cm.rget(r, "experts", k) for k in ("gate", "up", "down")},
        cfg, group)
    out = C.gather(out.reshape(bl, sl, d), 1, group)
    if m.num_shared:
        out = out + _shared(p["shared"], x, cfg, r)
    return out, aux
