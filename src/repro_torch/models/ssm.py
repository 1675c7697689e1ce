"""Mamba2 (SSD) block: chunked selective state-space scan.

The sequence is split into chunks of Q tokens; within a chunk the
recurrence is a (Q x Q) lower-triangular "attention" against decay weights,
across chunks a loop carries the (H, N, P) state (``ssd_chunked``, the
reference's pure-array path). The scan of the forward goes through
``kernels.ops.ssd_forward``: the ``ssd`` CUDA kernel on the card,
``ssd_chunked`` on the CPU and in the backward.

FlexRank: in/out projections are ordinary dense leaves -> factorizable.
The conv, decay (a_log, dt_bias) and skip (d_skip) params are excluded
(not matmul weights).

With a carried decode state (``mamba_apply(state=...)``, prefill and
decode) the block runs the reference's stateful branch: the conv continues
from the last K-1 inputs and the scan is ``ssd_chunked`` as a single chunk
of the whole step from the carried SSD state. As in the reference, that
branch is the plain chunked form on every device, not the ``ssd`` kernel
(which starts from a zero state and returns y only).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models import tp
from repro_torch.models.common import ParamSpec, linear


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return s, d_inner, n_heads


def mamba_spec(cfg: ModelConfig) -> Dict:
    s, d_inner, n_heads = _dims(cfg)
    d = cfg.d_model
    conv_dim = d_inner + 2 * s.num_groups * s.state_dim
    return {
        "in_proj": {"w": ParamSpec(
            (d, 2 * d_inner + 2 * s.num_groups * s.state_dim + n_heads),
            (cm.EMBED, cm.MLP))},
        "conv": ParamSpec((s.conv_width, conv_dim), (cm.CONV, cm.MLP),
                          "normal"),
        "a_log": ParamSpec((n_heads,), (cm.HEADS,), "zeros"),
        "dt_bias": ParamSpec((n_heads,), (cm.HEADS,), "zeros"),
        "d_skip": ParamSpec((n_heads,), (cm.HEADS,), "ones"),
        "gate_norm": ParamSpec((d_inner,), (cm.MLP,), "zeros"),
        "out_proj": {"w": ParamSpec((d_inner, d), (cm.MLP, cm.EMBED))},
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of width K, then SiLU. x: (B, S, C); w: (K, C);
    ``state``: the K-1 inputs before x (B, K-1, C), zeros when None.
    Returns (y, new_state) with new_state the last K-1 inputs (the decode
    carry)."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i] for i in range(k))
    return F.silu(y), xp[:, xp.shape[1] - (k - 1):]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, *, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked selective-state-space scan (the reference's
    ``ssd_chunked``), from ``initial_state`` (B, H, N, P) or zeros.

    x: (B, S, H, P) inputs per head; dt: (B, S, H) positive step sizes
    (post-softplus); a: (H,) negative decay rates (-exp(a_log)); b, c:
    (B, S, G, N) input/output projections (G groups broadcast over H).
    Returns (y (B, S, H, P), final_state (B, H, N, P)).

    The decay matrix is ``exp`` of the cumulative log-decays masked to
    ``-inf`` above the diagonal, where the reference takes ``where(mask,
    exp(rel), 0)``: the same values, but the reference's masked exponent
    (the sum of up to Q - 1 step sizes, which zamba2's chunk of 128 can
    take past 88.7) overflows to ``inf``, and autograd's gradient of that
    form is then 0 x inf = NaN; here it is 0.
    """
    bb, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    q = min(chunk, s)
    nc = s // q
    assert s % q == 0, (s, q)
    rep = h // g
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    b_h = b.repeat_interleave(rep, dim=2)
    c_h = c.repeat_interleave(rep, dim=2)
    state = (initial_state if initial_state is not None
             else torch.zeros((bb, h, n, p), dtype=x.dtype, device=x.device))
    ys = []
    for ci in range(nc):
        sl = slice(ci * q, (ci + 1) * q)
        x_c, dt_c, b_c, c_c = x[:, sl], dt[:, sl], b_h[:, sl], c_h[:, sl]
        da = dt_c * a                                  # (B,Q,H) log-decay
        cum = torch.cumsum(da, dim=1)                  # inclusive
        xdt = x_c * dt_c[..., None]
        rel = cum[:, :, None, :] - cum[:, None, :, :]  # (B,Qi,Qj,H)
        l_mat = torch.exp(rel.masked_fill(~tri, -torch.inf)).to(x.dtype)
        scores = torch.einsum("bihn,bjhn->bijh", c_c, b_c)
        y_c = torch.einsum("bijh,bijh,bjhp->bihp", scores, l_mat, xdt)
        # the carried state may be wider than x (a float32 state under
        # bfloat16 weights): the product promotes, as ``jnp.einsum`` does
        wide = torch.promote_types(x.dtype, state.dtype)
        decay_in = torch.exp(cum).to(wide)
        y_c = y_c + torch.einsum("bihn,bih,bhnp->bihp", c_c.to(wide),
                                 decay_in, state.to(wide))
        to_end = torch.exp(cum[:, -1:, :] - cum).to(x.dtype)
        s_c = torch.einsum("bjh,bjhn,bjhp->bhnp", to_end, b_c, xdt)
        state = state * torch.exp(cum[:, -1, :])[:, :, None, None].to(
            state.dtype) + s_c.to(state.dtype)
        ys.append(y_c.to(x.dtype))
    return torch.cat(ys, dim=1), state


def mamba_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                ranks: Optional[Dict] = None,
                state: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Mamba2 block. x: (B, S, d). Without ``state`` the scan is
    ``ops.ssd_forward`` (the ``ssd`` kernel on the card) and the result is
    (out, None). With ``state`` = {'conv': (B, K-1, C), 'ssd': (B, H, N,
    P)} (prefill and decode) the conv continues from the carried inputs and
    the scan runs ``ssd_chunked`` as one chunk of all S steps from the
    carried SSD state, as the reference does; returns (out, {'conv',
    'ssd'}) with new tensors."""
    tp.require_whole(p, lambda: mamba_spec(cfg), "mamba")
    s, d_inner, n_heads = _dims(cfg)
    r = ranks or {}
    bsz, seqlen, _ = x.shape
    gn = s.num_groups * s.state_dim

    zxbcdt = linear(p["in_proj"], x, rank=r.get("in_proj"), tap="in_proj")
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * gn, n_heads],
                             dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv"],
                                 None if state is None else state["conv"])
    xs, b, c = torch.split(xbc, [d_inner, gn, gn], dim=-1)

    xs = xs.reshape(bsz, seqlen, n_heads, s.head_dim)
    b = b.reshape(bsz, seqlen, s.num_groups, s.state_dim)
    c = c.reshape(bsz, seqlen, s.num_groups, s.state_dim)
    dt = F.softplus(dt.float() + p["dt_bias"]).to(x.dtype)
    a = -torch.exp(p["a_log"].float()).to(x.dtype)

    if state is None:
        y = ops.ssd_forward(xs, dt, a, b, c, chunk=s.chunk)
        new_state = None
    else:
        y, final = ssd_chunked(xs, dt, a, b, c, chunk=seqlen,
                               initial_state=state["ssd"])
        new_state = {"conv": new_conv, "ssd": final}
    y = y + xs * p["d_skip"][:, None].to(y.dtype)
    y = y.reshape(bsz, seqlen, d_inner)
    y = cm.rms_norm(y * F.silu(z), p["gate_norm"], eps=cfg.norm_eps)
    return linear(p["out_proj"], y, rank=r.get("out_proj"),
                  tap="out_proj"), new_state


def init_mamba_state(cfg: ModelConfig, batch: int, *, num_instances: int,
                     dtype=torch.float32, device=None) -> Dict:
    """Zero decode states of ``num_instances`` stacked Mamba2 blocks:
    {'conv': (L, B, K-1, C), 'ssd': (L, B, H, N, P)}."""
    s, d_inner, n_heads = _dims(cfg)
    conv_dim = d_inner + 2 * s.num_groups * s.state_dim
    return {
        "conv": torch.zeros((num_instances, batch, s.conv_width - 1,
                             conv_dim), dtype=dtype, device=device),
        "ssd": torch.zeros((num_instances, batch, n_heads, s.state_dim,
                            s.head_dim), dtype=dtype, device=device),
    }
