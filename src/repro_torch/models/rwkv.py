"""RWKV6 "Finch" block: data-dependent-decay linear attention.

Time-mix: token-shift interpolation with data-dependent mixing (ddlerp
LoRAs), r/k/v/g projections, per-channel decay ``w_t = exp(-exp(w0 +
lora_w(x)))``, and the WKV linear recurrence with in-place bonus ``u``:

    y_t = r_t^T (S + u .o (k_t v_t^T))        S <- diag(w_t) S + k_t v_t^T

The recurrence goes through ``kernels.ops.wkv6_forward``: the ``wkv6`` CUDA
kernel on the card, ``wkv_chunked`` (the reference's chunk-parallel form)
on the CPU and in the backward. Channel-mix is the squared-ReLU gated FFN
of the RWKV family.

FlexRank: the r/k/v/g/o and channel-mix projections are dense leaves ->
factorizable; the token-shift/decay LoRAs are already rank <= 64 and stay
dense (``cfg.flexrank.exclude`` covers 'decay'/'mix').

With a carried decode state (``rwkv_apply(state=...)``, prefill and
decode) the block runs the reference's stateful branch: the token shifts
continue from the carried last inputs and the recurrence is ``wkv_chunked``
from the carried WKV state. As in the reference, that branch is the plain
chunked form on every device, not the ``wkv6`` kernel (which starts from a
zero state and returns y only). Its steps must be a multiple of the chunk
when they exceed it (the reference's contract).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models import tp as tensor_parallel
from repro_torch.models.common import ParamSpec, linear

_TARGETS = ("w", "k", "v", "r", "g")


def rwkv_spec(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    rw = cfg.rwkv
    nt = len(_TARGETS)
    return {
        "ln_t": ParamSpec((d,), (None,), "zeros"),
        "ln_c": ParamSpec((d,), (None,), "zeros"),
        "time": {
            # ddlerp token-shift mixers
            "mix_base": ParamSpec((d,), (None,), "zeros"),
            "mix_bias": ParamSpec((nt, d), (None, None), "zeros"),
            "mix_lora_a": ParamSpec((d, nt * rw.mix_lora), (cm.EMBED, None)),
            "mix_lora_b": ParamSpec((nt, rw.mix_lora, d), (None, None, None),
                                    "zeros"),
            # data-dependent decay
            "decay_base": ParamSpec((d,), (None,), "zeros"),
            "decay_lora_a": ParamSpec((d, rw.decay_lora), (cm.EMBED, None)),
            "decay_lora_b": ParamSpec((rw.decay_lora, d), (None, None),
                                      "zeros"),
            "bonus": ParamSpec((d,), (None,), "zeros"),  # u
            "r": {"w": ParamSpec((d, d), (cm.EMBED, cm.HEADS))},
            "k": {"w": ParamSpec((d, d), (cm.EMBED, cm.HEADS))},
            "v": {"w": ParamSpec((d, d), (cm.EMBED, cm.HEADS))},
            "g": {"w": ParamSpec((d, d), (cm.EMBED, cm.HEADS))},
            "o": {"w": ParamSpec((d, d), (cm.HEADS, cm.EMBED))},
            "ln_x": ParamSpec((d,), (None,), "zeros"),
        },
        "channel": {
            "mix_k": ParamSpec((d,), (None,), "zeros"),
            "mix_r": ParamSpec((d,), (None,), "zeros"),
            "k": {"w": ParamSpec((d, cfg.d_ff), (cm.EMBED, cm.MLP))},
            "v": {"w": ParamSpec((cfg.d_ff, d), (cm.MLP, cm.EMBED))},
            "r": {"w": ParamSpec((d, d), (cm.EMBED, cm.HEADS))},
        },
    }


def _token_shift(x: torch.Tensor,
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_{t-1}. x: (B, S, D); ``prev``: the input before x (B, D), zero
    when None."""
    if x.shape[1] == 1 and prev is not None:
        return prev[:, None, :]
    shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
    if prev is not None:
        shifted = torch.cat([prev[:, None, :], shifted[:, 1:]], dim=1)
    return shifted


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, *, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel WKV6 recurrence (the reference's ``wkv_chunked``)
    from ``initial_state`` (B, H, N, N), float32, or zeros: within a chunk
    a strictly lower-triangular decay tensor from cumulative log-decays,
    across chunks a loop carries the (N, N) state.

    r/k/v: (B, S, H, N); w: (B, S, H, N) decays in (0, 1); u: (H, N) bonus.
    Returns (y (B, S, H, N), final_state (B, H, N, N)).

    The decay tensor is ``exp`` of the log-decays masked to ``-inf`` above
    the diagonal, where the reference takes ``where(mask, exp(rel), 0)``:
    the same values, but the reference's masked exponent (up to chunk x
    27.6) can overflow to ``inf``, and autograd's gradient of that form is
    then 0 x inf = NaN; here it is 0.
    """
    bb, s, h, n = r.shape
    q = min(chunk, s)
    nc = s // q
    assert s % q == 0, (s, q)
    f32 = torch.float32
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=r.device),
                     diagonal=-1)[None, :, :, None, None]
    uf = u.to(f32)
    state = (initial_state if initial_state is not None
             else torch.zeros((bb, h, n, n), dtype=f32, device=r.device))
    ys = []
    for c in range(nc):
        sl = slice(c * q, (c + 1) * q)
        r_c, k_c, v_c = (t[:, sl].to(f32) for t in (r, k, v))
        logw = torch.log(torch.clamp(w[:, sl].to(f32), min=1e-12))
        cum = torch.cumsum(logw, dim=1)              # inclusive (B,Q,H,N)
        cum_prev = cum - logw                        # exclusive
        rel = cum_prev[:, :, None] - cum[:, None]    # (B,Qi,Qj,H,N)
        decay_ij = torch.exp(rel.masked_fill(~tri, -torch.inf))
        att = torch.einsum("bihn,bijhn,bjhn->bijh", r_c, decay_ij, k_c)
        diag = torch.einsum("bihn,hn,bihn->bih", r_c, uf, k_c)
        y_c = torch.einsum("bijh,bjhm->bihm", att, v_c)
        y_c = y_c + diag[..., None] * v_c
        y_c = y_c + torch.einsum("bihn,bihn,bhnm->bihm", r_c,
                                 torch.exp(cum_prev), state)
        to_end = torch.exp(cum[:, -1:] - cum)
        s_c = torch.einsum("bjhn,bjhn,bjhm->bhnm", to_end, k_c, v_c)
        state = state * torch.exp(cum[:, -1])[..., None] + s_c
        ys.append(y_c.to(r.dtype))
    return torch.cat(ys, dim=1), state


def _ddlerp(x: torch.Tensor, x_prev: torch.Tensor, p: Dict,
            rw) -> Dict[str, torch.Tensor]:
    """Data-dependent token-shift interpolation for all five targets."""
    dx = x_prev - x
    base = x + dx * p["mix_base"].to(x.dtype)
    lora = torch.tanh(base @ p["mix_lora_a"].to(x.dtype))
    lora = lora.reshape(*x.shape[:2], len(_TARGETS), rw.mix_lora)
    adj = torch.einsum("bstr,trd->bstd", lora, p["mix_lora_b"].to(x.dtype))
    return {t: x + dx * (p["mix_bias"][i].to(x.dtype) + adj[:, :, i])
            for i, t in enumerate(_TARGETS)}


def rwkv_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
               ranks: Optional[Dict] = None,
               state: Optional[Dict] = None
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full RWKV6 block (time-mix + channel-mix, each pre-norm residual).
    x: (B, S, d). Without ``state`` the recurrence is ``ops.wkv6_forward``
    (the ``wkv6`` kernel on the card) and the result is (out, None). With
    ``state`` = {'shift_t', 'shift_c': (B, d), 'wkv': (B, H, N, N)}
    (prefill and decode) the shifts and the recurrence continue from the
    carried state through ``wkv_chunked``, as the reference does; returns
    (out, {'shift_t', 'shift_c', 'wkv'}) with new tensors."""
    tensor_parallel.require_whole(p, lambda: rwkv_spec(cfg), "rwkv")
    rw = cfg.rwkv
    r_ = ranks or {}
    d = cfg.d_model
    n = rw.head_dim
    h = d // n
    bsz, seqlen, _ = x.shape
    tp = p["time"]

    # ---- time mix ----
    x_res = x
    x = cm.rms_norm(x, p["ln_t"], eps=cfg.norm_eps)
    shift_t_out = x[:, -1]
    prev_t = None if state is None else state["shift_t"].to(x.dtype)
    mixed = _ddlerp(x, _token_shift(x, prev_t), tp, rw)

    def proj(name):
        return linear(tp[name], mixed[name], rank=cm.rget(r_, "time", name),
                      tap=f"time/{name}")

    rr = proj("r").reshape(bsz, seqlen, h, n)
    kk = proj("k").reshape(bsz, seqlen, h, n)
    vv = proj("v").reshape(bsz, seqlen, h, n)
    gg = proj("g")

    decay_in = tp["decay_base"].to(x.dtype) + torch.tanh(
        mixed["w"] @ tp["decay_lora_a"].to(x.dtype)) \
        @ tp["decay_lora_b"].to(x.dtype)
    w = torch.exp(-torch.exp(decay_in.float())).reshape(bsz, seqlen, h, n)
    u = tp["bonus"].reshape(h, n)

    if state is None:
        y = ops.wkv6_forward(rr, kk, vv, w.to(x.dtype), u, chunk=rw.chunk)
    else:
        y, new_wkv = wkv_chunked(rr, kk, vv, w.to(x.dtype), u,
                                 chunk=rw.chunk, initial_state=state["wkv"])
    y = y.reshape(bsz, seqlen, d)
    y = cm.rms_norm(y, tp["ln_x"], eps=cfg.norm_eps)  # group-norm stand-in
    y = y * F.silu(gg)
    x = x_res + linear(tp["o"], y, rank=cm.rget(r_, "time", "o"),
                       tap="time/o")

    # ---- channel mix ----
    cp = p["channel"]
    x_res = x
    x = cm.rms_norm(x, p["ln_c"], eps=cfg.norm_eps)
    shift_c_out = x[:, -1]
    prev_c = None if state is None else state["shift_c"].to(x.dtype)
    dxc = _token_shift(x, prev_c) - x
    xk = x + dxc * cp["mix_k"].to(x.dtype)
    xr = x + dxc * cp["mix_r"].to(x.dtype)
    kk_c = torch.square(F.relu(linear(cp["k"], xk,
                                      rank=cm.rget(r_, "channel", "k"),
                                      tap="channel/k")))
    rr_c = torch.sigmoid(linear(cp["r"], xr, rank=cm.rget(r_, "channel", "r"),
                                tap="channel/r"))
    out = x_res + rr_c * linear(cp["v"], kk_c,
                                rank=cm.rget(r_, "channel", "v"),
                                tap="channel/v")
    if state is None:
        return out, None
    return out, {"shift_t": shift_t_out, "shift_c": shift_c_out,
                 "wkv": new_wkv}


def init_rwkv_state(cfg: ModelConfig, batch: int, *, num_instances: int,
                    dtype=torch.float32, device=None) -> Dict:
    """Zero decode states of ``num_instances`` stacked RWKV6 blocks:
    {'shift_t', 'shift_c': (L, B, d) in ``dtype``, 'wkv': (L, B, H, N, N)
    float32}."""
    rw = cfg.rwkv
    d = cfg.d_model
    h = d // rw.head_dim
    return {
        "shift_t": torch.zeros((num_instances, batch, d), dtype=dtype,
                               device=device),
        "shift_c": torch.zeros((num_instances, batch, d), dtype=dtype,
                               device=device),
        "wkv": torch.zeros((num_instances, batch, h, rw.head_dim,
                            rw.head_dim), dtype=torch.float32,
                           device=device),
    }
