"""Tensor parallelism over 'model': a rank's part of each product, the
counterpart of what XLA's SPMD partitioner derives from the reference's
``param_shardings`` (``distributed/sharding.py:rank_dims``).

A rank holds each leaf as the placement cuts it: a dense ``w`` by its
output columns (heads, kv-heads, MLP, vocabulary: column-parallel) or its
input rows (heads or MLP in, embed out: row-parallel); a factorized pair
with ``u`` (out, rank) cut by out and ``v`` (in, rank) by rank where the
output is split, ``v`` cut by in and ``u`` by rank where the input is;
where neither side takes 'model' (``frontend_proj``) both factors are
cut by rank. The split comes from the leaf's shape alone: a module gives
the product's whole (d_in, d_out) and a dimension a factor ``n`` smaller
is this rank's part; anything else raises.

The activations between blocks (the residual stream) are whole and the
same on every rank, and so is each one's gradient. A product whose rank
computes part of its output takes its input through ``reduce_grad``
(Megatron's f: the input's gradient summed over the ranks); one that
leaves a partial sum on each rank ends in ``reduce_from`` (g: an
all-reduce), in the parameters' type: a bfloat16 model sums in
bfloat16, as XLA's partitioned program does; a float32 model's
row-parallel product of a bfloat16 input (the attention's output over a
bfloat16 cache) sums its parts in float32 and rounds once, as one device
rounds the whole product once. Summed in bfloat16 there, a float32
model's decode over a bfloat16 cache on four ranks parts from one rank's
past the bfloat16 tie bound from the first token on (gemma3-smoke's cell
of ``tests/test_torch_tp.py``); that cell is the one caller today, since
the dry run's models are bfloat16 and ``dist_check.py``'s decode cache
is float32. A factor cut by rank where the other is not is gathered
for the product (``_Gathered``): autograd saves the shard, the backward
gathers it again, and its gradient is reduce-scattered (summed where
each rank computed a part) or cut (where each rank computed the whole).
Two factors both cut by rank need no gather: ``y = sum_i ((x v_i) *
mask_i) u_i^T`` with the nested mask's columns offset by the rank's
first column. In every case ``kernels.ops`` runs the low-rank kernel on
the rank's shards, at the global ``rank`` of the nested mask.

The GAR form ``y = [z, z u_hat^T][:, perm_inv]``, ``z = x v_tilde``
(``_gar_linear``): ``param_shardings`` cuts ``v_tilde`` (n, r) by its
input rows where the input side takes 'model' (row-parallel), else by
its rank columns; ``u_hat`` (m - r, r) by its rows where the output side
does (column-parallel), else by its rank columns; a dimension that does
not divide leaves that leaf whole, whatever the other's cut. ``perm_inv``
is never cut: it permutes all m outputs, not the rank's. Stage 1 on a
rank gives its columns of z, a partial sum of all of z (an input cut by
rows), or all of z; z is made whole where stage 2 needs it (a gather of
columns, an all-reduce of partials) and stage 2 gives the tail's rows,
a partial sum of the tail from the rank's columns of z, or the whole
tail, which is made whole the same way. Then the permutation, and a
column-parallel product keeps the rank's output columns (where they
divide: its heads or MLP columns, as the dense layer's). Where both
factors are cut by rank (``frontend_proj``) one fused call gives the
rank's columns of z and a partial tail. No weight crosses the ranks,
only z (T x r) and the tail (T x (m - r)); each stage runs on the GAR
kernel's entries (``ops.gar_forward`` with no tail and the identity
permutation for stage 1 alone, ``ops.gar_tail`` for stage 2 on a given
z), with the collectives' backward for training.

The attention (``models/attention.py``) runs each rank's own heads where
its q and k/v columns are whole heads (and the GQA map holds on them);
where the split falls inside a head (gpt2-small's 12 heads on 16 ranks,
llama4's 8 kv heads on 16) the product's output is gathered to every
head first. The vocabulary: an embedding cut by rows looks up the
rank's rows (zero elsewhere) and sums over the ranks; the logits are cut
by the vocabulary, and the losses (``core/distill.py``) combine the
shards' maxima, sums and label logits without gathering them.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.meshctx import get_current_mesh
from repro_torch.kernels import ops
from repro_torch.kernels.lowrank_matmul import kept_rank


LOW_PRECISION = (torch.bfloat16, torch.float16)


def axis() -> Tuple[object, int, int]:
    """(group, size, this rank's index) of the current mesh's 'model'
    axis; (None, 1, 0) without a mesh, an axis or a second rank."""
    mesh = get_current_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return None, 1, 0
    group = mesh.group("model")
    if group is None:
        return None, 1, 0
    return group, mesh.shape["model"], mesh.index("model")


def is_part(local: int, whole: int, n: int, what: str) -> bool:
    """Whether a dimension of ``local`` entries is a rank's part of one of
    ``whole`` over ``n`` ranks (False where it is whole); raises where it
    is neither."""
    if local == whole:
        return False
    if n > 1 and local * n == whole:
        return True
    raise ValueError(f"{what}: {local} of {whole} entries on {n} 'model' "
                     "ranks is neither whole nor a rank's part")


def _fit_input(x: torch.Tensor, n_in: int, split_in: bool, group,
               n: int) -> torch.Tensor:
    """``x`` cut to this rank's columns where the product's input is
    split, gathered where it is whole; as it is where it already fits."""
    w = x.shape[-1]
    if split_in and w == n_in:
        return C.scatter(x, -1, group)
    if not split_in and w * n == n_in and n > 1:
        return C.gather(x, -1, group)
    if w != (n_in // n if split_in else n_in):
        raise ValueError(f"an input of {w} columns for a product of "
                         f"{n_in} inputs on {n} 'model' ranks")
    return x


class _Gathered(torch.autograd.Function):
    """The masked low-rank product of 2-d ``x`` with ``v`` and/or ``u``
    gathered over the group along their rank dimension. Autograd keeps
    the shards; the backward gathers them again. A gathered factor's
    gradient is reduce-scattered where ``summed`` (each rank computed a
    part of the product), else cut to this rank's part."""

    @staticmethod
    def forward(ctx, x, v, u, rank, gather_v, gather_u, summed, group):
        ctx.save_for_backward(x, v, u)
        ctx.how = (rank, gather_v, gather_u, summed, group)
        vw = C.all_gather_along(v, -1, group) if gather_v else v
        uw = C.all_gather_along(u, -1, group) if gather_u else u
        return ops.lowrank_2d(x, vw, uw, rank)

    @staticmethod
    def backward(ctx, dy):
        x, v, u = ctx.saved_tensors
        rank, gather_v, gather_u, summed, group = ctx.how
        vw = C.all_gather_along(v, -1, group) if gather_v else v
        uw = C.all_gather_along(u, -1, group) if gather_u else u
        dx, dv, du = ops.lowrank_grads(x, vw, uw,
                                       kept_rank(vw.shape[1], rank), dy,
                                       ctx.needs_input_grad[:3])
        part = C.reduce_scatter if summed else C.own_chunk
        if gather_v and dv is not None:
            dv = part(dv, -1, group)
        if gather_u and du is not None:
            du = part(du, -1, group)
        return dx, dv, du, None, None, None, None, None


def _param_dtype(p: Dict[str, torch.Tensor]) -> torch.dtype:
    return next(t.dtype for t in p.values() if t.is_floating_point())


def _layout(p: Dict[str, torch.Tensor], whole: Sequence[int], n: int):
    """How a dense or factorized leaf is cut over ``n`` ranks: (input
    cut, output cut, v gathered, u gathered, both factors cut by rank)."""
    n_in, n_out = whole[0], whole[1]
    if "w" in p:
        split_in = is_part(p["w"].shape[-2], n_in, n, "w rows")
        split_out = is_part(p["w"].shape[-1], n_out, n, "w columns")
        rank_cut = gather_v = gather_u = False
    else:
        v, u = p["v"], p["u"]
        split_in = is_part(v.shape[-2], n_in, n, "v rows")
        split_out = is_part(u.shape[-2], n_out, n, "u rows")
        rv, ru = v.shape[-1], u.shape[-1]
        rank_cut = (rv == ru and not (split_in or split_out)
                    and len(whole) > 2
                    and is_part(rv, whole[2], n, "factor rank"))
        gather_v = rv < ru and is_part(rv, ru, n, "v rank")
        gather_u = ru < rv and is_part(ru, rv, n, "u rank")
    if split_in and split_out:
        raise ValueError("a leaf cut by both its input and its output")
    return split_in, split_out, gather_v, gather_u, rank_cut


@dataclasses.dataclass(frozen=True)
class _GarCut:
    """How a GAR leaf is cut over the ranks (module note): ``v_tilde`` by
    its input rows or its rank columns, ``u_hat`` by its output rows or
    its rank columns. ``perm_inv`` is never cut."""
    v_in: bool
    v_rank: bool
    u_out: bool
    u_rank: bool

    @property
    def column(self) -> bool:
        """The product's output side takes 'model' (heads, MLP): the
        rank keeps its output columns where they divide."""
        return self.u_out or (self.v_rank and not self.u_rank)


def _gar_layout(p: Dict[str, torch.Tensor], whole: Sequence[int],
                n: int) -> _GarCut:
    """The cut of a GAR leaf from its shapes. ``whole``: (d_in, d_out),
    and a third entry where neither side takes 'model' (both factors may
    be cut by rank: ``frontend_proj``). There the whole rank is m less
    u_hat's rows, which are never cut; elsewhere the larger of the two
    factors' rank widths, as only one of them can be cut by rank."""
    n_in, m = whole[0], whole[1]
    is_part(p["perm_inv"].shape[-1], m, 1, "GAR perm_inv")
    a, b = p["v_tilde"].shape[-1], p["u_hat"].shape[-1]
    rows = p["u_hat"].shape[-2]
    r = m - rows if len(whole) > 2 else max(a, b)
    cut = _GarCut(v_in=is_part(p["v_tilde"].shape[-2], n_in, n,
                               "GAR v_tilde rows"),
                  v_rank=is_part(a, r, n, "GAR v_tilde rank"),
                  u_out=is_part(rows, m - r, n, "GAR u_hat rows"),
                  u_rank=is_part(b, r, n, "GAR u_hat rank"))
    if (cut.v_in and cut.v_rank) or (cut.u_out and cut.u_rank):
        raise ValueError("a GAR factor cut by two of its dimensions")
    return cut


def enter(x: torch.Tensor, products) -> Tuple[torch.Tensor, bool]:
    """``x`` as the input of ``products`` ((leaf, whole) pairs): through
    one ``reduce_grad`` where each of them computes a part of its output
    from the whole ``x`` (Megatron's f once for q, k and v, or gate and
    up), then ``(x, True)``; else ``(x, False)`` and each product takes
    its own."""
    group, n, _ = axis()
    if group is None or x.shape[-1] != products[0][1][0] or any(
            "u_hat" in p for p, _ in products):
        return x, False
    for p, whole in products:
        split_in, split_out, _, _, rank_cut = _layout(p, whole, n)
        if split_in or not (split_out or rank_cut):
            return x, False
    return C.reduce_grad(x, group), True


def linear(p: Dict[str, torch.Tensor], x: torch.Tensor,
           whole: Sequence[int], rank: Optional[int],
           plain: Callable, entered: bool = False) -> torch.Tensor:
    """``common.linear`` of a leaf that may be this rank's part (module
    note). ``whole``: the product's (d_in, d_out), and for a factorized
    pair whose both factors may be cut by rank, its whole rank third (a
    GAR leaf reads only that there is one: ``_gar_layout``). ``x`` may
    hold the whole input or this rank's columns of it; ``entered``: it
    went through ``enter`` already. Returns the whole output, or this
    rank's columns of it where the leaf is cut by its output.
    ``plain(p, x, rank)`` is the one-device product."""
    group, n, i = axis()
    if group is None:
        return plain(p, x, rank)
    if "u_hat" in p:
        return _gar_linear(p, x, whole, group, n, i)
    split_in, split_out, gather_v, gather_u, rank_cut = _layout(p, whole, n)
    x = _fit_input(x, whole[0], split_in, group, n)
    if (split_out or rank_cut) and not entered:
        x = C.reduce_grad(x, group)
    if "w" not in p and "v" in p and (rank_cut or gather_v or gather_u):
        v, u = p["v"].to(x.dtype), p["u"].to(x.dtype)
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if rank_cut:
            # both factors cut by rank: each rank's columns of z, summed
            lo = i * v.shape[-1]
            local = None if rank is None else max(
                0, min(int(rank) - lo, v.shape[-1]))
            y = ops.lowrank_forward(x2, v, u, local)
        else:
            y = _Gathered.apply(x2, v, u, rank, gather_v, gather_u,
                                split_in or split_out, group)
        y = y.reshape(*lead, -1)
    elif split_in and x.dtype in LOW_PRECISION and _param_dtype(p) \
            == torch.float32:
        # a float32 model's product of a bfloat16 input: the ranks' parts
        # summed in float32 and rounded once, as one device rounds the
        # whole product once
        wide = {k: t.to(x.dtype).float() if t.is_floating_point() else t
                for k, t in p.items()}
        return C.reduce_from(plain(wide, x.float(), rank), group).to(x.dtype)
    else:
        y = plain(p, x, rank)
    return C.reduce_from(y, group) if split_in or rank_cut else y


# ------------------------------------------------------------ GAR

@functools.lru_cache(maxsize=256)
def _identity(k: int, device: torch.device) -> torch.Tensor:
    return torch.arange(k, device=device)


def _stage1(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """z = x @ v on the GAR kernel: its fused call with no tail and the
    identity permutation."""
    return ops.gar_forward(x, v, v.new_empty((0, v.shape[-1])),
                           _identity(v.shape[-1], v.device))


def _gar_linear(p: Dict[str, torch.Tensor], x: torch.Tensor,
                whole: Sequence[int], group, n: int, i: int
                ) -> torch.Tensor:
    """``y = [z, z u_hat^T][:, perm_inv]``, ``z = x v_tilde``, on this
    rank's parts of the GAR leaf (module note). Every product runs on the
    GAR kernel's entries; only z and the tail cross the ranks. Returns
    this rank's output columns where the product is column-parallel and
    they divide, else the whole output."""
    cut = _gar_layout(p, whole, n)
    m = whole[1]
    x = _fit_input(x, whole[0], cut.v_in, group, n)
    v, u = p["v_tilde"].to(x.dtype), p["u_hat"].to(x.dtype)
    perm = p["perm_inv"]
    if not (cut.v_in or cut.v_rank or cut.u_out or cut.u_rank):
        return ops.gar_forward(x, v, u, perm)
    if cut.v_rank and cut.u_rank:
        # rank-parallel: the rank's columns of z and a partial tail in one
        # fused call
        rl = v.shape[-1]
        y = ops.gar_forward(C.reduce_grad(x, group), v, u,
                            _identity(rl + u.shape[-2], v.device))
        z = C.gather(y[..., :rl], -1, group)
        tail = C.reduce_from(y[..., rl:], group)
    else:
        if cut.v_rank:
            z = C.gather(_stage1(C.reduce_grad(x, group), v), -1, group)
        elif cut.v_in:
            z = C.reduce_from(_stage1(x, v), group)
        else:
            z = _stage1(x, v)
        if cut.u_rank:
            tail = C.reduce_from(ops.gar_tail(C.scatter(z, -1, group), u),
                                 group)
        elif cut.u_out:
            tail = C.gather(ops.gar_tail(C.reduce_grad(z, group), u), -1,
                            group)
        else:
            tail = ops.gar_tail(z, u)
    w = torch.cat([z, tail], dim=-1)
    if cut.column and m % n == 0:
        # the output permutation does not follow the head split: the
        # rank's output columns are picked from the whole [z, tail]
        cols = m // n
        return C.reduce_grad(w, group)[..., perm[i * cols:(i + 1) * cols]]
    return w[..., perm]


# ------------------------------------------------------------ heads

def heads(y: torch.Tensor, count: int, hd: int) -> Tuple[torch.Tensor, int]:
    """A q/k/v product's output (B, S, cols) as (B, S, h, hd) heads and
    the index of its first head: this rank's heads where its columns are
    whole heads of a head count the axis divides, else every head (the
    rank's columns gathered first)."""
    group, n, i = axis()
    b, s, cols = y.shape
    if cols == count * hd:
        return y.reshape(b, s, count, hd), 0
    is_part(cols, count * hd, n, "head columns")
    if count % n == 0:
        return y.reshape(b, s, count // n, hd), i * (count // n)
    return C.gather(y, -1, group).reshape(b, s, count, hd), 0


def own_heads(t: torch.Tensor, count: int, first: int, want: int
              ) -> Tuple[torch.Tensor, int]:
    """(B, S, h, D) heads from head ``first`` laid out as ``want`` heads:
    this rank's ``count / n`` from a whole ``t``, every head gathered from
    a rank's part, or ``t`` as it is. Returns (heads, first head)."""
    group, n, i = axis()
    h = t.shape[2]
    if h == want:
        return t, first
    if want == count and h * n == count:
        return C.gather(t, 2, group), 0
    if h == count and want * n == count:
        return C.scatter(t, 2, group), i * want
    raise ValueError(f"{h} heads from {first} cannot be laid out as "
                     f"{want} of {count}")


def kv_for(q_heads: int, q0: int, k: torch.Tensor, v: torch.Tensor,
           k0: int, group_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k/v heads that query heads ``q0 .. q0 + q_heads - 1`` read
    (GQA: query head h reads k/v head ``h // group_size``), out of the
    held heads ``k0 ..``: a contiguous run where every held query group
    is whole, else one k/v head a query head."""
    hk = k.shape[2]
    first, last = q0 // group_size, (q0 + q_heads - 1) // group_size
    if first < k0 or last >= k0 + hk:
        raise ValueError(f"query heads {q0}..{q0 + q_heads - 1} read k/v "
                         f"heads {first}..{last}, not among {k0}.."
                         f"{k0 + hk - 1}")
    if q0 % group_size == 0 and q_heads % group_size == 0:
        if first == k0 and last == k0 + hk - 1:
            return k, v
        return k[:, :, first - k0:last - k0 + 1], \
            v[:, :, first - k0:last - k0 + 1]
    idx = (torch.arange(q_heads, device=k.device) + q0) // group_size - k0
    return k[:, :, idx], v[:, :, idx]


# -------------------------------------------------------- vocabulary

def embed(table: torch.Tensor, tokens: torch.Tensor,
          vocab: int) -> torch.Tensor:
    """``table[tokens]`` of an embedding that may be cut by its rows: a
    rank looks up the ids among its rows (zero for the others) and the
    ranks' rows are summed."""
    group, n, i = axis()
    if not is_part(table.shape[0], vocab, n, "embedding rows"):
        return table[tokens]
    rows = table.shape[0]
    local = tokens.long() - i * rows
    mine = (local >= 0) & (local < rows)
    e = table[torch.where(mine, local, torch.zeros_like(local))]
    return C.reduce_from(e * mine[..., None].to(e.dtype), group)


def tied_logits(x: torch.Tensor, table: torch.Tensor,
                vocab: int) -> torch.Tensor:
    """``x @ table^T``: this rank's vocabulary columns where the table is
    cut by rows."""
    group, n, _ = axis()
    if is_part(table.shape[0], vocab, n, "embedding rows"):
        x = C.reduce_grad(x, group)
    return x @ table.to(x.dtype).T


def vocab_group(logits: torch.Tensor, vocab: Optional[int]):
    """The 'model' group whose ranks hold the vocabulary columns of
    ``logits``, None where they are whole."""
    if vocab is None:
        return None
    group, n, _ = axis()
    return group if is_part(logits.shape[-1], vocab, n, "logits") else None


def whole_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Logits whole over the vocabulary (gathered from the ranks' columns
    where they are cut), outside autograd."""
    group = vocab_group(logits, vocab)
    return logits if group is None else C.all_gather_along(logits, -1,
                                                           group)


# ---------------------------------------------------- deferred blocks

def _walk(p, spec, path: str):
    """(path, param node, spec node) of every product or leaf of a block:
    a dict holding 'w' in ``spec`` pairs with the param's dense,
    factorized or GAR form."""
    if isinstance(spec, dict):
        if "w" in spec and len(spec) == 1:
            yield path, p, spec["w"]
            return
        for k in spec:
            yield from _walk(p[k], spec[k], f"{path}/{k}")
    else:
        yield path, p, spec


def require_whole(p, spec_of: Callable[[], Dict], what: str) -> None:
    """Raise where a block that the rank program runs whole (MLA's
    attention, the recurrent blocks: ``distributed.sharding.deferred``)
    is given a leaf cut over 'model': each product's input and output
    widths and factor ranks must be the whole ones of ``spec_of()`` (the
    block's dense ``ParamSpec`` tree, one layer), built only under a
    'model' axis. No check without one."""
    if axis()[0] is None:
        return
    for path, node, s in _walk(p, spec_of(), what):
        n_in, n_out = s.shape[-2:] if len(s.shape) >= 2 else (None, None)
        if not isinstance(node, dict):
            got = [(tuple(node.shape), tuple(s.shape))]
        elif "w" in node:
            got = [(tuple(node["w"].shape[-2:]), (n_in, n_out))]
        elif "u_hat" in node:
            r = node["v_tilde"].shape[-1]
            got = [(node["v_tilde"].shape[-2], n_in),
                   (node["perm_inv"].shape[-1], n_out),
                   (node["u_hat"].shape[-1], r),
                   (node["u_hat"].shape[-2] + r, n_out)]
        else:
            got = [((node["v"].shape[-2], node["u"].shape[-2]),
                    (n_in, n_out)),
                   (node["v"].shape[-1], node["u"].shape[-1])]
        for have, want in got:
            if have != want:
                raise ValueError(
                    f"{path}: {have} where the whole leaf is {want}: this "
                    "block runs whole on every 'model' rank, and a leaf "
                    "cut over the axis cannot run here")
