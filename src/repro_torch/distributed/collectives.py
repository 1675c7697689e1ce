"""Collectives over one axis of a ``Mesh``, with the backward that each
needs where a value is computed the same way on every rank of the axis.

On a rank of a 'model' group the dense layers run on the same rows as on
its peers, so a value that leaves the replicated part (``scatter``) has
as its gradient the gradient of that rank's part only, and the full
gradient is the concatenation of every rank's (an all-gather). The value
that comes back (``gather``) is the same on every rank, and so is its
gradient: each rank keeps its own part. ``torch.distributed.nn``'s
all-gather sums its gradient instead, which would count the replicated
part once for each rank. ``reduce_grad`` marks a replicated leaf used on
each rank's part only (the router's weight): identity forward, gradient
summed over the axis. ``mean`` is the reference's ``pmean`` of a value
that each rank then uses alike: its gradient is 1/n on each rank.
``all_reduce_mean_`` averages tensors in place outside autograd (the
gradients), ``all_reduce`` sums or takes the maximum of a tensor outside
autograd (the merge of attention over a cache whose rows are cut),
``reduce_host`` a number of the host (a loss, a flag).

The tensor-parallel products (``models/tp.py``) use Megatron's pair:
``reduce_grad`` (its f: identity forward, the gradient summed over the
axis) where a replicated value enters a product of which each rank
computes a part, and ``reduce_from`` (its g: the sum over the axis
forward, identity backward) where the ranks' partial results become one
replicated value.
``reduce_scatter`` sums over the axis and keeps this rank's part (the
backward of a factor gathered for a product of which each rank computes
a part).

An axis of one rank (no group) makes every function the identity.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(_group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _own_chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _group_size(group)
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of every rank's ``x``, this rank's equal part along
    ``dim`` (one ``reduce_scatter_tensor`` along the leading dimension)."""
    n = _group_size(group)
    lead = x.movedim(dim, 0).contiguous()
    out = torch.empty((lead.shape[0] // n,) + tuple(lead.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, lead, group=group)
    return out.movedim(0, dim)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own_chunk(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_cat(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own_chunk(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = _group_size(group)
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's equal part of ``x`` along ``dim``; backward: the
    all-gather of every rank's gradient."""
    return x if group is None else _Scatter.apply(x, dim, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order;
    backward: this rank's part of the gradient."""
    return x if group is None else _Gather.apply(x, dim, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Part ``j`` of ``x`` along dim 0 to rank ``j``; part ``j`` of the
    result from rank ``j``. Its backward is the same exchange."""
    return x if group is None else _AllToAll.apply(x, group)


def reduce_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; backward: the gradient summed over the group."""
    return x if group is None else _ReduceGrad.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x``; backward: the gradient as it is, the
    same on every rank (Megatron's g)."""
    return x if group is None else _ReduceFrom.apply(x, group)


def mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the group; backward: the gradient over n."""
    return x if group is None else _Mean.apply(x, group)


@torch.no_grad()
def all_reduce_mean_(tensors: Any, group) -> None:
    """Replace each tensor of the list by its mean over the group, in
    place, with one all-reduce of a flat float32 buffer."""
    n = _group_size(group)
    if n == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= n
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


@torch.no_grad()
def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (``op`` 'sum') or the elementwise maximum ('max') of every
    rank's ``x`` over the group, a new tensor, outside autograd."""
    if group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return out


def reduce_host(value: float, group, op: str = "mean") -> float:
    """A host number's ``op`` ('mean', 'sum' or 'max') over the group's
    ranks, placed on this rank's card where the group's backend is NCCL
    (which moves no host tensors); ``group`` None is one rank."""
    if group is None:
        return value
    t = torch.tensor([float(value)], dtype=torch.float64)
    if dist.get_backend(group) == "nccl":
        t = t.cuda()
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    out = float(t.item())
    return out / _group_size(group) if op == "mean" else out


@torch.no_grad()
def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of every rank's ``x``, this rank's equal part along
    ``dim``, outside autograd."""
    return x if group is None else _reduce_scatter(x, dim, group)


@torch.no_grad()
def own_chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's equal part of ``x`` along ``dim``, outside autograd."""
    return x if group is None else _own_chunk(x, dim, group)


@torch.no_grad()
def all_gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, outside autograd."""
    return x if group is None else _gather_cat(x, dim, group)
