"""Mixture-of-Experts FFN: top-k routing, capacity-bounded gather dispatch,
shared experts and the load-balancing aux loss.

Dispatch is the reference's, sort-free: top-k routing picks expert ids
per token, a running count per expert (token-major over the ``S * K``
(token, choice) pairs) assigns capacity slots, and the pairs past an
expert's capacity are dropped. Capacity is a host int from the shape,
``max(ceil(S * top_k * cf / E), 4)``, per batch row. Every step is a
device op on device indices (comparisons, ``cumsum``, ``gather``,
``index_put_``): nothing is read back to the host.

Expert weights carry a leading ``experts`` axis; FlexRank factorizes each
expert's (d_in, d_out) pair along it, so a factorized or GAR leaf holds
one factor pair per expert. The expert products are batched ``einsum``s,
as the reference leaves them to XLA; the shared experts go through
``common.linear`` like every other projection.

The reference's expert-parallel ``moe_apply_ep`` falls back to
``moe_apply`` without a mesh, so one card runs ``moe_apply`` wherever the
reference calls either.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
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
    slot 0 with a gate of 0."""
    m = cfg.moe
    r = ranks or {}
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    dev = x.device

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

    h = cm.swiglu(
        expert_linear(p["experts"]["gate"], ex_in,
                      rank=cm.rget(r, "experts", "gate"), tap="experts/gate"),
        expert_linear(p["experts"]["up"], ex_in,
                      rank=cm.rget(r, "experts", "up"), tap="experts/up"))
    ex_out = expert_linear(p["experts"]["down"], h,
                           rank=cm.rget(r, "experts", "down"),
                           tap="experts/down")
    ex_out = ex_out.reshape(b, sentinel, d)

    # combine: gather back per (token, choice) pair and sum over choices
    back = torch.where(keep, dest, torch.zeros_like(dest))
    gathered = torch.gather(ex_out, 1, back[..., None].expand(b, s * k, d))
    gathered = gathered * flat_gate[..., None].to(ex_out.dtype)
    out = gathered.reshape(b, s, k, d).sum(dim=2).to(x.dtype)

    if m.num_shared:
        sh = cm.swiglu(
            linear(p["shared"]["gate"], x, rank=cm.rget(r, "shared", "gate"),
                   tap="shared/gate"),
            linear(p["shared"]["up"], x, rank=cm.rget(r, "shared", "up"),
                   tap="shared/up"))
        out = out + linear(p["shared"]["down"], sh,
                           rank=cm.rget(r, "shared", "down"),
                           tap="shared/down")

    # load-balance aux (Switch-style): E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))                                 # (E,)
    ce = (top_e[..., 0, None] == torch.arange(e, device=dev)).float().mean(
        dim=(0, 1))
    aux = e * torch.sum(me * ce) * m.router_aux_weight
    return out, aux
