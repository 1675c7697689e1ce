"""Public wrappers around the kernels, dispatching on where the tensors lie.

A CPU tensor takes the plain PyTorch version (``ref``); a CUDA tensor
launches the hand-written kernel, or the kernel's wrapper raises. There is
no knob and no fallback from a failed launch to the plain version.

Under a step trace (``launch/trace_analysis.py``) each entry reports the
work of the plain version it stands for: counted as it runs where the
plain version runs, replayed on ``meta`` where the kernel launches.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import gar_matmul as _gar
from repro_torch.kernels import lowrank_matmul as _lr
from repro_torch.kernels import paged_attention as _attn
from repro_torch.kernels import sampling as _samp
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels import wkv6 as _wkv
from repro_torch.launch import trace_analysis as TA


def gar_forward(x: torch.Tensor, v_tilde: torch.Tensor, u_hat: torch.Tensor,
                perm_inv: torch.Tensor) -> torch.Tensor:
    """Full GAR linear: y = P^{-1} [z ; z @ u_hat^T], x: (..., n). At full
    rank ``u_hat`` is (0, r) and ``z`` is the whole output."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    v_tilde, u_hat = v_tilde.to(x.dtype), u_hat.to(x.dtype)
    if x.is_cuda:
        TA.count_kernel("gar_matmul", _gar_plain, xf, v_tilde, u_hat,
                        perm_inv)
        y = _gar.gar_matmul(xf.contiguous(), v_tilde.contiguous(),
                            u_hat.contiguous(), perm_inv.contiguous())
        return y.reshape(*lead, -1)
    with TA.plain_kernel("gar_matmul"):
        y = _gar_plain(xf, v_tilde, u_hat, perm_inv)
    return y.reshape(*lead, -1)


def _gar_plain(xf, v_tilde, u_hat, perm_inv):
    z, tail = ref.gar_matmul_ref(xf, v_tilde, u_hat)
    return torch.cat([z, tail], dim=-1)[:, perm_inv]


def gar_tail(z: torch.Tensor, u_hat: torch.Tensor) -> torch.Tensor:
    """GAR's second stage on a given z: ``z @ u_hat^T``, z: (..., r)."""
    lead = z.shape[:-1]
    zf = z.reshape(-1, z.shape[-1])
    u_hat = u_hat.to(z.dtype)
    if z.is_cuda:
        TA.count_kernel("gar_tail", ref.gar_tail_ref, zf, u_hat)
        tail = _gar.gar_tail(zf.contiguous(), u_hat.contiguous())
        return tail.reshape(*lead, -1)
    with TA.plain_kernel("gar_tail"):
        tail = ref.gar_tail_ref(zf, u_hat)
    return tail.reshape(*lead, -1)


def lowrank_2d(x: torch.Tensor, v: torch.Tensor, u: torch.Tensor,
               rank: Optional[int]) -> torch.Tensor:
    """``((x @ v) * [col < rank]) @ u^T`` of 2-d ``x``, outside autograd:
    the kernel on CUDA tensors, its plain version on CPU tensors."""
    if x.is_cuda:
        TA.count_kernel("lowrank_matmul", ref.lowrank_matmul_ref, x, v, u,
                        rank)
        return _lr.lowrank_matmul(x.contiguous(), v.contiguous(),
                                  u.contiguous(), rank)
    with TA.plain_kernel("lowrank_matmul"):
        return ref.lowrank_matmul_ref(x, v, u, rank)


def lowrank_grads(x, v, u, kr: int, dy, needs):
    """The gradients (dx, dv, du) of ``lowrank_2d`` at ``dy``, each where
    ``needs`` (three flags) asks for it: the masked products in plain
    PyTorch, as the reference has no backward kernel and leaves its
    gradients to XLA's products of the plain branch. The masked columns of
    ``z`` are zero, so the products run over the kept columns only and the
    gradients of the masked factor columns are zero: ``dz = dy @ u_k``,
    ``dx = dz @ v_k^T``, ``dv_k = x^T @ dz``, ``du_k = dy^T @ (x @ v_k)``
    with ``_k`` the first kr columns."""
    v_k, u_k = v[:, :kr], u[:, :kr]
    dx = dv = du = None
    if needs[0] or needs[1]:
        dz = dy @ u_k
    if needs[0]:
        dx = dz @ v_k.T
    if needs[1]:
        dv = torch.zeros_like(v)
        dv[:, :kr] = x.T @ dz
    if needs[2]:
        du = torch.zeros_like(u)
        du[:, :kr] = dy.T @ (x @ v_k)
    return dx, dv, du


class _LowRank(torch.autograd.Function):
    """Masked low-rank linear on 2-d ``x``: the forward is ``lowrank_2d``,
    the backward ``lowrank_grads``."""

    @staticmethod
    def forward(ctx, x, v, u, rank):
        ctx.save_for_backward(x, v, u)
        ctx.kr = _lr.kept_rank(v.shape[1], rank)
        return lowrank_2d(x, v, u, rank)

    @staticmethod
    def backward(ctx, dy):
        x, v, u = ctx.saved_tensors
        return (*lowrank_grads(x, v, u, ctx.kr, dy,
                               ctx.needs_input_grad[:3]), None)


def lowrank_forward(x: torch.Tensor, v: torch.Tensor, u: torch.Tensor,
                    rank: Optional[int] = None) -> torch.Tensor:
    """Masked low-rank linear (the training path): ``y = ((x @ v) * [col <
    rank]) @ u^T`` over the last axis, x: (..., n) -> (..., m). ``rank`` is
    a Python int (``None`` keeps all r columns). Differentiable in x, v
    and u."""
    lead = x.shape[:-1]
    y = _LowRank.apply(x.reshape(-1, x.shape[-1]), v.to(x.dtype),
                       u.to(x.dtype), rank)
    return y.reshape(*lead, -1)


def _pad_steps(t: torch.Tensor, chunk: int, value: float = 0.0):
    """Pad axis 1 (the steps) of ``t`` up to a multiple of ``chunk``."""
    pad = (-t.shape[1]) % chunk if t.shape[1] > chunk else 0
    if pad == 0:
        return t
    width = [0, 0] * (t.dim() - 2) + [0, pad]
    return torch.nn.functional.pad(t, width, value=value)


def _wkv_plain(r, k, v, w, u, chunk):
    """``models.rwkv.wkv_chunked`` on any S: the steps are padded to a chunk
    multiple with ``w = 1`` and zero r/k/v (no-op steps at the end), as the
    reference's ``ops.wkv6_forward`` pads for its kernel."""
    from repro_torch.models.rwkv import wkv_chunked   # models import ops
    s = r.shape[1]
    y, _ = wkv_chunked(*(_pad_steps(t, chunk) for t in (r, k, v)),
                       _pad_steps(w, chunk, 1.0), u, chunk=chunk)
    return y[:, :s]


def _ssd_plain(x, dt, a, b, c, chunk):
    """``models.ssm.ssd_chunked`` on any S: zero-padded steps at the end
    (``dt = 0``: no decay and no input), as the reference's
    ``ops.ssd_forward`` pads for its kernel."""
    from repro_torch.models.ssm import ssd_chunked     # models import ops
    s = x.shape[1]
    y, _ = ssd_chunked(*(_pad_steps(t, chunk) for t in (x, dt)), a,
                       *(_pad_steps(t, chunk) for t in (b, c)), chunk=chunk)
    return y[:, :s]


class _Recurrence(torch.autograd.Function):
    """A linear recurrence from a zero state whose forward is a CUDA kernel
    on CUDA tensors and the chunked plain version on CPU tensors, and whose
    backward recomputes the chunked plain version under autograd and
    backpropagates through it: the reference has no backward kernel and
    takes ``jax.grad`` of its chunked form."""

    @staticmethod
    def forward(ctx, name, kernel, plain, chunk, *args):
        ctx.plain, ctx.chunk = plain, chunk
        ctx.save_for_backward(*args)
        if args[0].is_cuda:
            TA.count_kernel(name, plain, *args, chunk)
            return kernel(*(t.contiguous() for t in args))
        with TA.plain_kernel(name):
            return plain(*args, chunk)

    @staticmethod
    def backward(ctx, dy):
        args = [t.detach().requires_grad_(need) for t, need in
                zip(ctx.saved_tensors, ctx.needs_input_grad[4:])]
        wanted = [t for t in args if t.requires_grad]
        with torch.enable_grad():
            y = ctx.plain(*args, ctx.chunk)
            grads = iter(torch.autograd.grad(y, wanted, dy))
        return (None, None, None, None,
                *(next(grads) if t.requires_grad else None for t in args))


def wkv6_forward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, *,
                 chunk: int = 64) -> torch.Tensor:
    """RWKV6 WKV recurrence from a zero state. r/k/v/w: (B, S, H, N), w the
    decays in (0, 1); u: (H, N). Returns y (B, S, H, N). ``chunk`` is the
    plain version's chunk length. Differentiable in every input."""
    return _Recurrence.apply("wkv6", _wkv.wkv6, _wkv_plain, chunk, r, k, v,
                             w, u)


def ssd_forward(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, *,
                chunk: int = 128) -> torch.Tensor:
    """Mamba2 SSD scan from a zero state, without the skip term. x:
    (B, S, H, P); dt: (B, S, H) step sizes; a: (H,) negative decay rates;
    b/c: (B, S, G, N) with G dividing H. Returns y (B, S, H, P). ``chunk``
    is the plain version's chunk length. Differentiable in every input."""
    return _Recurrence.apply("ssd", _ssd.ssd, _ssd_plain, chunk, x, dt, a,
                             b, c)


def paged_attention_forward(q, k_pool, v_pool, block_tables, context_lens,
                            *, softcap: float = 0.0,
                            window: Optional[int] = None):
    """Paged decode attention, one query token a slot. q: (B, Hq, D);
    pools: (NB, BS, Hkv, D); block_tables: (B, MB); context_lens: (B,).
    ``window`` (sliding-window lookback) keeps keys ``[ctx - window, ctx)``.
    Returns (B, Hq, D)."""
    if q.is_cuda:
        i32 = torch.int32
        TA.count_kernel("paged_attention", ref.paged_attention_ref, q,
                        k_pool, v_pool, block_tables, context_lens,
                        softcap=softcap, window=window)
        return _attn.paged_attention(
            q.contiguous(), k_pool, v_pool, block_tables.to(i32).contiguous(),
            context_lens.to(i32).contiguous(), softcap=softcap,
            window=window)
    with TA.plain_kernel("paged_attention"):
        return ref.paged_attention_ref(q, k_pool, v_pool, block_tables,
                                       context_lens, softcap=softcap,
                                       window=window)


def paged_prefill_attention_forward(q, k_pool, v_pool, block_tables,
                                    slot_ids, context_lens, *,
                                    softcap: float = 0.0,
                                    window: Optional[int] = None):
    """Flat-token paged attention. q: (T, Hq, D); pools: (NB, BS, Hkv, D);
    block_tables: (B, MB); slot_ids/context_lens: (T,). ``window`` as for
    ``paged_attention_forward``. Returns (T, Hq, D)."""
    if q.is_cuda:
        i32 = torch.int32
        TA.count_kernel("paged_prefill_attention",
                        ref.paged_prefill_attention_ref, q, k_pool, v_pool,
                        block_tables, slot_ids, context_lens,
                        softcap=softcap, window=window)
        return _attn.paged_prefill_attention(
            q.contiguous(), k_pool, v_pool, block_tables.to(i32).contiguous(),
            slot_ids.to(i32).contiguous(), context_lens.to(i32).contiguous(),
            softcap=softcap, window=window)
    with TA.plain_kernel("paged_prefill_attention"):
        return ref.paged_prefill_attention_ref(
            q, k_pool, v_pool, block_tables, slot_ids, context_lens,
            softcap=softcap, window=window)


def topk_mask_sample_forward(logits, temperature, top_k, u, *,
                             return_probs: bool = False):
    """Temperature/top-k warp + one categorical draw per logits row.

    logits: (S, V); temperature: (S,) (``<= 0`` = greedy argmax); top_k:
    (S,) int (0 = no truncation) or ``None`` when no row truncates, which
    skips the threshold sort; u: (S,) uniforms in [0, 1). Returns tokens
    (S,) int32, plus the warped probs (S, V) when ``return_probs``."""
    temperature = temperature.float()
    u = u.float()
    if top_k is None:
        threshold = None
    else:
        z = logits.float() / torch.clamp(temperature, min=1e-30)[:, None]
        threshold = ref.topk_threshold_ref(z, top_k)
    if logits.is_cuda:
        thr = (threshold if threshold is not None
               else torch.full(logits.shape[:1], -math.inf,
                               dtype=torch.float32, device=logits.device))
        TA.count_kernel("topk_mask_sample", ref.topk_mask_sample_ref,
                        logits, temperature, threshold, u,
                        return_probs=return_probs)
        return _samp.topk_mask_sample(logits.float().contiguous(),
                                      temperature.contiguous(),
                                      thr.contiguous(), u.contiguous(),
                                      return_probs=return_probs)
    with TA.plain_kernel("topk_mask_sample"):
        tokens, probs = ref.topk_mask_sample_ref(
            logits, temperature, threshold, u, return_probs=return_probs)
    return (tokens, probs) if return_probs else tokens
