"""The training launcher's mesh path on the ranks of one machine: phase 21
of ``chip_smoke.py`` on one card, and its rehearsal on the CPU.

  PYTHONPATH=src python dist_check.py SPEC.json RANK

(``run_pair`` starts both ranks; ``chip_smoke.py`` and
``tests/test_torch_dist.py`` call it.)

Every run is two steps of ``launch/train.py:run`` (``--mode dense``,
AdamW) from the same seeded dense weights, at no drop and no aux loss:
the function that every mesh computes alike (the per-slice capacity and
the per-slice aux are the expert-parallel path's own).

Rank 0 runs (a) alone: the run without a process group, then the same
in a world of one started as the launcher starts it
(``distributed.init_world_from_env``, which must choose ``backend_a``:
NCCL on the card, gloo on the CPU) at mesh 1 x 1,
which takes ``moe_apply_ep`` with one 'model' rank: losses and parameters
bit for bit. It then writes ``a_done`` in the spec's directory and joins
a world of two over gloo, which the caller starts rank 1 into: (b) the
runs at (2, 1) and (1, 2), each held against (a)'s run without a group
(the whole batch on one rank): losses within ``tol_loss`` relative; each
parameter leaf (every leaf cut over 'model' gathered: at (1, 2) the
experts, and tensor-parallel the heads, the shared experts' and the
dense FFN's columns and the vocabulary) within ``tol_param`` of its scale,
the larger of its max and the learning rates summed (a leaf that starts
at zero, a norm's offset, has a max of about that sum), but for at most
``ceil(leaf_share * size)`` entries of the leaf (an entry whose gradient
is rounding noise around zero takes Adam's normalised step of either
sign, as phase 19 (d) of ``chip_smoke.py`` allows), which stay within
twice the learning rates summed, the most two runs' Adam steps can part
by; every leaf with an entry past its bound is reported; the whole
leaves of every rank of a 'model' group bit for bit alike (by a digest of
their bits); at (1, 2) each rank's bytes of parameters and AdamW moments
equal to the dry run's ``placed`` for the same cell and mesh
(``launch/dryrun.py``, float32 parameters; ``placed`` counts the
reference's int32 step too, which the port keeps as a Python int); then
the model's logits under (1, 2), every leaf split, gathered over the
vocabulary, against the forward without a mesh, within ``tol_logits`` of
their max, and the two all-to-alls of that MoE call timed at its shapes.

With ``decode`` in the spec, (d), after (b) in the world of two: the
model's prefill and greedy decode over this rank's part of the decode
cache (``launch/specs.py:cache_specs(mesh=)``, float32) at (1, 2), each
rank with half of every cut leaf (the experts among them: the cached
step's ``moe_apply`` runs its E / 2) and the cache's heads, and at (2, 1)
at a batch of one, the cache's sequence cut over 'data': a prompt of
``decode["prompt"]`` tokens into ``decode["cache"]`` positions, then
``decode["steps"]`` steps, each the argmax of the last logits. Held
against the same on rank 0 without a mesh: logits within
``tol_logits`` of their max, greedy tokens equal; each rank's bytes of
parameters and cache equal to the dry run's ``placed`` for the decode
cell; at (2, 1) each rank holding half the cache, the rows written
where they fall (the prompt and the first steps on rank 0, the rest on
rank 1).

With ``gar`` in the spec, (e), after (d) in the world of two: the same
model in the GAR form (``--mode gar``'s parameters at their default
budget, drawn by ``launch/dryrun.py:_make`` from ``gar["seed"]`` on every
rank: valid permutations, no deploy), a prompt of ``decode["prompt"]``
tokens and ``decode["steps"]`` greedy steps at (1, 2), each rank with
its part of ``v_tilde`` and ``u_hat`` as placed (``perm_inv`` whole) and
of the decode cache, held against rank 0's decode without a mesh on the
whole tree: logits within ``tol_logits`` of their max, greedy tokens
equal; each rank's bytes of parameters and cache equal to the dry run's
``placed`` for the gar decode cell; each rank's GAR products
(``kernels/ops.py``: ``gar_forward``, ``gar_tail``) counted with their
weight operands' shapes, which must be the rank's parts, and on the card
``gar_matmul``'s launches of both entries above zero.

``merge_check`` holds the merge of a decode attention over the rows of a
cache cut into shards (``models/attention.py``: the row maxima, the
sums of exponentials, the float32 products) against whole
``chunked_attend``, with the collectives replaced by the maxima and sums
of the shards' parts in rank order, in one process.

With ``lowrank`` in the spec, (c): ``lowrank["arch"]`` at
``lowrank["layers"]`` layers, ``--mode flexrank`` (calibration, DataSVD
and DP on each rank, then two steps of the uniform table's rows), run
without a group on rank 0 before the world of two and at (1, 2) in it,
held as (b) holds its runs; each rank counts the low-rank products it
runs (``kernels/ops.py:lowrank_2d``), their operand shapes and, on the
card, ``lowrank_matmul``'s launches.

A failed check raises, so the rank exits non-zero; rank 0 writes
``result.json`` (losses, step, all-reduce and all-to-all ms, each rank's
peak memory) into the spec's directory.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import distributed as D
from repro_torch.configs import Segment, get_config
from repro_torch.data import make_source
from repro_torch.distributed import collectives as C
from repro_torch.configs import ShapeConfig
from repro_torch.kernels import lowrank_matmul, ops
from repro_torch.launch import dryrun
from repro_torch.launch import specs as SP
from repro_torch.launch import train
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import tp
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw

LR = 1e-3                      # the launcher's default, which run takes
NAMES = ("data", "model")
TIMEOUT = datetime.timedelta(seconds=60)


def config(spec: dict):
    """The spec's arch (cut to its dense layer 0 and one MoE layer with
    ``cut``) at no drop and no aux loss."""
    cfg = get_config(spec["arch"], smoke=spec["smoke"])
    if spec["cut"]:
        cfg = dataclasses.replace(cfg, num_layers=2, segments=(
            Segment("attn_dense", 1), Segment("attn", 1)))
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=float(m.num_experts), router_aux_weight=0.0))


def lowrank_config(spec: dict):
    """(c)'s config: ``lowrank["arch"]`` cut to ``lowrank["layers"]``
    blocks of its one segment."""
    lr = spec["lowrank"]
    cfg = get_config(lr["arch"], smoke=spec["smoke"])
    seg = cfg.segments[0]
    return dataclasses.replace(cfg, num_layers=lr["layers"], segments=(
        dataclasses.replace(seg, count=lr["layers"]),))


@contextlib.contextmanager
def lowrank_calls():
    """The (x, v, u) shapes of every low-rank product run, and the kernel's
    launches over the block."""
    shapes = []
    real = ops.lowrank_2d

    def counting(x, v, u, rank):
        shapes.append((tuple(x.shape), tuple(v.shape), tuple(u.shape)))
        return real(x, v, u, rank)
    ops.lowrank_2d = counting
    before = lowrank_matmul.launches
    box = {"shapes": shapes}
    try:
        yield box
    finally:
        ops.lowrank_2d = real
        box["launches"] = lowrank_matmul.launches - before


@contextlib.contextmanager
def gar_calls():
    """The weight operands' shapes of every GAR product run (the fused
    call's ``v_tilde`` and ``u_hat``, the stage-2 entry's ``u_hat``), and
    the launches of both entries over the block."""
    from repro_torch.kernels import gar_matmul
    shapes = []
    fused, tail = ops.gar_forward, ops.gar_tail

    def counting_fused(x, v_tilde, u_hat, perm_inv):
        shapes.append(("fused", tuple(v_tilde.shape), tuple(u_hat.shape)))
        return fused(x, v_tilde, u_hat, perm_inv)

    def counting_tail(z, u_hat):
        shapes.append(("tail", tuple(u_hat.shape)))
        return tail(z, u_hat)
    ops.gar_forward, ops.gar_tail = counting_fused, counting_tail
    before = (gar_matmul.launches, gar_matmul.tail_launches)
    box = {"shapes": shapes}
    try:
        yield box
    finally:
        ops.gar_forward, ops.gar_tail = fused, tail
        box["launches"] = gar_matmul.launches - before[0]
        box["tail_launches"] = gar_matmul.tail_launches - before[1]


@contextlib.contextmanager
def ep_calls():
    """The 'model' group size of every ``moe_apply_ep`` body call."""
    sizes = []
    real = moe._moe_inner

    def counting(x_col, router_w, experts, ranks, cfg, group):
        sizes.append(1 if group is None else dist.get_world_size(group))
        return real(x_col, router_w, experts, ranks, cfg, group)
    moe._moe_inner = counting
    try:
        yield sizes
    finally:
        moe._moe_inner = real


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _train(cfg, dense, spec, mesh, mode="dense"):
    source = make_source(cfg.vocab_size, spec["seq"], spec["batch"], seed=0)
    return train.run(cfg, dense, source, steps=spec["steps"], lr=LR,
                     mode=mode, eval_before=False, mesh=mesh,
                     log=lambda m: None)


def _host(tree) -> dict:
    return {p: t.detach().cpu() for p, t in cm.tree_items(tree)}


def _digest(t: torch.Tensor) -> tuple:
    """The sum of a float32 tensor's bits as int64, and its float64 sum:
    equal for equal tensors, and unequal for a change of any bit but by
    the rarest chance."""
    return (int(t.detach().contiguous().view(torch.int32).sum(
        dtype=torch.int64)), float(t.detach().double().sum()))


def _peak(dev) -> float:
    return (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else 0.0)


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def run_a(spec, cfg, dense, dev, out) -> tuple:
    """(a): returns the run without a group's losses and parameters (on
    the host)."""
    with ep_calls() as calls:
        plain = _train(cfg, dense, spec, None)
    if set(calls) != {1}:
        raise AssertionError(f"(a) no group: EP calls {calls}")
    losses, params = plain.losses, _host(plain.params)
    out["a_step_ms"] = [s * 1e3 for s in plain.step_seconds]
    del plain
    # the launcher's own start: the backend chosen from the card's id
    env = dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(spec["port_a"]))
    os.environ.update(env)
    try:
        backend = D.init_world_from_env(dev, timeout=TIMEOUT)
    finally:
        for k in env:
            os.environ.pop(k)
    try:
        if backend != spec["backend_a"]:
            raise AssertionError(f"(a) a world of one on {dev} chose "
                                 f"{backend}, not {spec['backend_a']}")
        out["a_backend"] = backend
        mesh = D.elastic_remesh((1, 1), NAMES)
        with ep_calls() as calls:
            one = _train(cfg, dense, spec, mesh)
        if not calls or set(calls) != {1}:
            raise AssertionError(f"(a) world of one: EP calls {calls}")
        if one.losses != losses:
            raise AssertionError(f"(a) losses {one.losses} against "
                                 f"{losses} without a group")
        for p, t in _host(one.params).items():
            if not torch.equal(t, params[p]):
                raise AssertionError(f"(a) {p} differs from the run "
                                     "without a group")
        out["a_losses"] = losses
        out["a_world_step_ms"] = [s * 1e3 for s in one.step_seconds]
        del one
    finally:
        D.shutdown_world()
    return losses, params


def _travel(spec) -> tuple:
    """(the learning rates summed, the most two runs' Adam steps can part
    by: each step at most lr in size, of either sign)."""
    steps = spec["steps"]
    opt = adamw.AdamWConfig(lr=LR, warmup_steps=min(100, steps // 10 + 1),
                            total_steps=steps)
    lr_sum = sum(adamw.schedule_lr(opt, k) for k in range(1, steps + 1))
    return lr_sum, 2.0 * lr_sum * (1 + 1e-3)


def _split(res) -> dict:
    """Each parameter path of a run: whether its leaf is cut over
    'model' on this mesh."""
    n = res.mesh.size("model")
    return {p: n > 1 and d is not None for (p, _), d in zip(
        cm.tree_items(res.params), D.sharding.dim_leaves(res.shard_dims))}


def _held(spec, key, res, ref, rank, out) -> dict:
    """Hold a run of the world of two against ``ref`` (rank 0's losses and
    parameters of the run without a group): the whole leaves alike on
    both ranks, losses and the gathered parameters (module note). Returns
    the figures (on rank 0; empty elsewhere)."""
    lr_sum, travel = _travel(spec)
    digests = [None, None]
    dist.all_gather_object(digests, {
        p: _digest(t) for p, t in cm.tree_items(res.params)})
    split = _split(res)
    whole, _ = res.full_state()
    if rank != 0:
        return {}
    for p, dg in digests[0].items():
        if not split[p] and digests[1][p] != dg:
            raise AssertionError(f"{key}: {p} differs across the ranks")
    losses, params = ref
    err = float(np.max(np.abs(np.subtract(res.losses, losses))
                       / np.abs(losses)))
    if err > spec["tol_loss"]:
        raise AssertionError(f"{key}: losses {res.losses} against "
                             f"{losses} ({err:.3e})")
    past, worst, name = {}, 0.0, ""
    for p, t in cm.tree_items(whole):
        diff = (t.detach().cpu() - params[p]).abs()
        if float(diff.max()) > travel:
            raise AssertionError(
                f"{key}: {p} moved {float(diff.max()):.3e} from the "
                f"one-rank run, past Adam's travel {travel:.3e}")
        scale = max(float(params[p].abs().max()), lr_sum)
        n_past = int((diff > spec["tol_param"] * scale).sum())
        allowed = math.ceil(spec["leaf_share"] * diff.numel())
        if n_past:
            past[p] = [n_past, allowed]
        if n_past > allowed:
            raise AssertionError(
                f"{key}: {p}: {n_past} of {diff.numel()} entries past "
                f"{spec['tol_param']} of its scale {scale:.3e} (at most "
                f"{allowed}; worst {float(diff.max()) / scale:.3e})")
        if float(diff.max()) / scale > worst:
            worst, name = float(diff.max()) / scale, p
    return {"losses": res.losses, "loss_err": err, "param_err": worst,
            "param_leaf": name, "past": past,
            "split": sorted(p for p, c in split.items() if c),
            "step_ms": [s * 1e3 for s in res.step_seconds],
            "allreduce_ms": [s * 1e3 for s in res.sync_seconds]}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in cm.tree_leaves(tree))


def placed_check(spec, cfg, res, mesh) -> dict:
    """This rank's bytes of parameters and AdamW moments against the dry
    run's ``placed`` for the cell at ``mesh``: its bfloat16 parameters
    count 2 bytes an entry, the rank's float32 ones 4."""
    pspecs, paxes = SP.model_param_specs(cfg, mode="dense")
    cell = ShapeConfig("dist", spec["seq"], spec["batch"], "train")
    want = dict(dryrun.placed(cfg, cell, mesh, pspecs, paxes, "dense",
                              fsdp=False)["bytes_per_device"])
    want["params"] = want["params"] * 4 // 2
    have = {"params": _nbytes(res.params),
            "optimizer": _nbytes(res.opt_state.mu)
            + _nbytes(res.opt_state.nu)}
    # placed counts the reference's int32 step beside the moments
    if have["params"] != want["params"] or \
            have["optimizer"] != want["optimizer"] - 4:
        raise AssertionError(f"bytes {have} against placed {want}")
    return {"have": have, "placed": {k: want[k] for k in have}}


def run_b(spec, cfg, dense, dev, rank, ref, out, ref_c=None) -> None:
    """(b) on this rank of the gloo world of two (``ref``: (a)'s losses and
    parameters on rank 0, None elsewhere), then (c) where the spec asks
    (``ref_c``: its run without a group on rank 0)."""
    D.init_world("gloo", device=dev, rank=rank, world_size=2,
                 init_method=f"tcp://127.0.0.1:{spec['port_b']}",
                 timeout=TIMEOUT)
    try:
        for shape in ((2, 1), (1, 2)):
            key = f"{shape[0]}x{shape[1]}"
            mesh = D.elastic_remesh(shape, NAMES)
            _reset_peak(dev)
            with ep_calls() as calls:
                res = _train(cfg, dense, spec, mesh)
            if set(calls) != {shape[1]}:
                raise AssertionError(f"(b) {key}: EP calls {calls}")
            peaks = [None, None]
            dist.all_gather_object(peaks, _peak(dev))
            sizes = [None, None]
            dist.all_gather_object(sizes, placed_check(spec, cfg, res, mesh)
                                   if shape[1] > 1 else None)
            held = _held(spec, f"(b) {key}", res, ref, rank, out)
            if rank == 0:
                out[key] = dict(held, peak_gb=peaks, bytes=sizes)
            del res
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        logits_check(spec, cfg, dense, dev, rank, out)
        if "decode" in spec:
            decode_check(spec, cfg, dense, dev, rank, out)
        if "gar" in spec:
            gar_check(spec, cfg, dev, rank, out)
        if "lowrank" in spec:
            lowrank_check(spec, dev, rank, ref_c, out)
    finally:
        D.shutdown_world()


def lowrank_run(spec, dev, mesh):
    """(c)'s run on ``mesh`` (None: without a group), counting its
    low-rank products."""
    cfg = lowrank_config(spec)
    dense = train.dense_init(cfg, 0, dev)
    with lowrank_calls() as box:
        res = _train(cfg, dense, spec, mesh, mode="flexrank")
    return res, box


def lowrank_check(spec, dev, rank, ref_c, out) -> None:
    """(c) at (1, 2): held against the run without a group; each rank's
    product count, shapes and launches."""
    mesh = D.elastic_remesh((1, 2), NAMES)
    res, box = lowrank_run(spec, dev, mesh)
    counts = [None, None]
    dist.all_gather_object(counts, {
        "calls": len(box["shapes"]), "launches": box["launches"],
        "shapes": sorted({str(s) for s in box["shapes"]})})
    held = _held(spec, "(c) 1x2", res, ref_c, rank, out)
    if rank == 0:
        # every factorized product runs on each rank, through the kernel
        # on the card, as often as it does on one rank without a group
        one = out["c_one"]
        got = [(c["calls"], c["launches"]) for c in counts]
        if got != [(one["calls"], one["launches"])] * 2 or (
                dev.type == "cuda" and one["launches"] == 0):
            raise AssertionError(
                f"(c) 1x2: (products, lowrank_matmul launches) a rank "
                f"{got}, one rank without a group "
                f"{(one['calls'], one['launches'])}")
        out["c"] = dict(held, ranks=counts)


def logits_check(spec, cfg, dense, dev, rank, out) -> None:
    """The forward's logits under (1, 2), each rank with its half of every
    cut leaf, gathered over the vocabulary, against the forward without a
    mesh; then the two all-to-alls of that MoE call at its shapes,
    timed."""
    mesh = D.elastic_remesh((1, 2), NAMES)
    dims = D.rank_dims(cfg, mesh, cm.axes_tree(tfm.model_spec(cfg)), dense)
    part = D.shard_tree(dense, dims, mesh)
    tokens = torch.as_tensor(make_source(
        cfg.vocab_size, spec["seq"], spec["batch"], seed=0).batch_at(0)[
            "tokens"][:, :-1], device=dev)
    with torch.no_grad():
        with D.mesh_context(mesh):
            got, _ = tfm.forward(part, cfg, tokens)
            got = tp.whole_vocab(got, cfg.vocab_size)
        if rank == 0:
            want, _ = tfm.forward(dense, cfg, tokens)
            err = float((got - want).abs().max() / want.abs().max())
            if err > spec["tol_logits"]:
                raise AssertionError(f"(b) logits under (1, 2): {err:.3e} "
                                     "of their max")
            out["logits_err"] = err
    del part, got
    m = cfg.moe
    tc = spec["batch"] * spec["seq"] // 2
    cap = int(np.ceil(tc * m.top_k * m.capacity_factor / m.num_experts))
    group = mesh.group("model")
    x = torch.randn(m.num_experts, cap, cfg.d_model, device=dev)
    times = {"dispatch": [], "return": []}
    for _ in range(4):
        for name in times:
            y = x if name == "dispatch" else x.reshape(
                m.num_experts // 2, 2, cap, cfg.d_model).transpose(
                    0, 1).contiguous()
            _sync(dev)
            dist.barrier(group)
            t0 = time.perf_counter()
            C.all_to_all(y, group)
            _sync(dev)
            times[name].append((time.perf_counter() - t0) * 1e3)
    out["a2a_ms"] = {k: v[1:] for k, v in times.items()}
    out["a2a_bytes"] = x.numel() * x.element_size()


def _greedy(cfg, params, cell, prompt, steps, mesh):
    """A prompt through ``prefill`` into a float32 decode cache of
    ``cell`` (this rank's part of it under ``mesh``), then ``steps``
    greedy decode steps. Returns (logits (B, steps + 1, V) whole over the
    vocabulary, the tokens chosen, the state, each step's ms)."""
    dev = prompt.device
    step = SP.make_decode_step(cfg)
    times = []
    with torch.no_grad(), D.mesh_context(mesh):
        state = SP.cache_specs(cfg, cell, dtype=torch.float32, device=dev,
                               mesh=mesh)
        lg, state = tfm.prefill(params, cfg, state, prompt)
        logits = [tp.whole_vocab(lg[:, -1], cfg.vocab_size)]
        tokens = []
        for _ in range(steps):
            tokens.append(logits[-1].argmax(-1, keepdim=True))
            _sync(dev)
            t0 = time.perf_counter()
            lg, state = step(params, state, {"tokens": tokens[-1]})
            _sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            logits.append(lg)
    return torch.stack(logits, 1), torch.cat(tokens, 1), state, times


def _written_rows(state) -> int:
    """The rows of the first attention layer's K that hold a write."""
    k = state["segments"][0]["k"][0]
    return int((k.abs().sum(dim=(0, 2, 3)) != 0).sum())


def decode_check(spec, cfg, dense, dev, rank, out) -> None:
    """(d) (module note)."""
    dc = spec["decode"]
    t0 = time.perf_counter()
    pspecs, paxes = SP.model_param_specs(cfg, mode="dense")
    tokens = torch.as_tensor(make_source(
        cfg.vocab_size, dc["prompt"], spec["batch"], seed=1).batch_at(0)[
            "tokens"][:, :dc["prompt"]], device=dev)
    res = {}
    for shape, b in (((1, 2), spec["batch"]), ((2, 1), 1)):
        key = f"{shape[0]}x{shape[1]}"
        mesh = D.elastic_remesh(shape, NAMES)
        part = D.shard_tree(dense, D.rank_dims(cfg, mesh, paxes, pspecs),
                            mesh)
        cell = ShapeConfig("decode", dc["cache"], b, "decode")
        logits, chosen, state, ms = _greedy(cfg, part, cell, tokens[:b],
                                            dc["steps"], mesh)
        want = dryrun.placed(cfg, cell, mesh, pspecs, paxes, "dense",
                             fsdp=False)["bytes_per_device"]
        have = {"params": _nbytes(part), "cache": _nbytes(
            [t for t in cm.tree_leaves(state) if isinstance(t, torch.Tensor)])}
        # float32 where placed counts the reference's bfloat16
        want = {k: want[k] * 2 for k in have}
        if have != want:
            raise AssertionError(f"(d) {key}: rank {rank} holds {have}, "
                                 f"placed {want}")
        mine = {"bytes": have, "rows": _written_rows(state),
                "tokens": chosen.tolist(), "step_ms": ms}
        ranks = [None, None]
        dist.all_gather_object(ranks, mine)
        if rank == 0:
            one_logits, one_tokens, one_state, one_ms = _greedy(
                cfg, dense, cell, tokens[:b], dc["steps"], None)
            err = float((logits - one_logits).abs().max()
                        / one_logits.abs().max())
            if err > spec["tol_logits"]:
                raise AssertionError(f"(d) {key}: logits {err:.3e} of "
                                     "their max from one rank's")
            if any(r["tokens"] != one_tokens.tolist() for r in ranks):
                raise AssertionError(f"(d) {key}: greedy tokens "
                                     f"{[r['tokens'] for r in ranks]}, one "
                                     f"rank's {one_tokens.tolist()}")
            whole = _nbytes([t for t in cm.tree_leaves(one_state)
                             if isinstance(t, torch.Tensor)])
            res[key] = {"logits_err": err, "ranks": ranks,
                        "one_step_ms": one_ms, "one_cache": whole,
                        "one_rows": _written_rows(one_state)}
        del part, state
    if rank == 0:
        half = dc["cache"] // 2
        wrote = [r["rows"] for r in res["2x1"]["ranks"]]
        end = dc["prompt"] + dc["steps"]
        if wrote != [min(end, half), max(end - half, 0)] or any(
                2 * r["bytes"]["cache"] != res["2x1"]["one_cache"]
                for r in res["2x1"]["ranks"]):
            raise AssertionError(f"(d) 2x1: rows written {wrote}, cache "
                                 f"bytes {[r['bytes'] for r in res['2x1']['ranks']]}"
                                 f" of {res['2x1']['one_cache']} whole")
        out["d"] = res
        out["d_s"] = time.perf_counter() - t0


def _leaf_shapes(tree) -> set:
    """The shapes of one layer's slice of every GAR factor of ``tree``
    (stacked leaves carry the layers first, experts' the experts too)."""
    out = set()
    for path, t in cm.tree_items(tree):
        if path.endswith(("/v_tilde", "/u_hat")):
            out.add(tuple(t.shape[-2:]))
    return out


def gar_check(spec, cfg, dev, rank, out) -> None:
    """(e) (module note)."""
    dc = spec["decode"]
    t0 = time.perf_counter()
    pspecs, paxes = SP.model_param_specs(cfg, mode="gar")
    whole = dryrun._make(pspecs, torch.float32, dev,
                         torch.Generator().manual_seed(spec["gar"]["seed"]))
    mesh = D.elastic_remesh((1, 2), NAMES)
    part = D.shard_tree(whole, D.rank_dims(cfg, mesh, paxes, pspecs), mesh)
    if rank != 0:
        del whole
    tokens = torch.as_tensor(make_source(
        cfg.vocab_size, dc["prompt"], spec["batch"], seed=2).batch_at(0)[
            "tokens"][:, :dc["prompt"]], device=dev)
    cell = ShapeConfig("decode", dc["cache"], spec["batch"], "decode")
    with gar_calls() as box:
        logits, chosen, state, ms = _greedy(cfg, part, cell, tokens,
                                            dc["steps"], mesh)
    want = dryrun.placed(cfg, cell, mesh, pspecs, paxes, "gar",
                         fsdp=False)["bytes_per_device"]
    have = {"params": _nbytes(part), "cache": _nbytes(
        [t for t in cm.tree_leaves(state) if isinstance(t, torch.Tensor)])}
    # float32 and int64 where placed counts bfloat16 and int32
    if have != {k: want[k] * 2 for k in have}:
        raise AssertionError(f"(e) 1x2: rank {rank} holds {have}, placed "
                             f"{ {k: want[k] for k in have} }")
    weights = {s for c in box["shapes"] for s in c[1:] if s[0] > 0}
    mine = {"bytes": have, "tokens": chosen.tolist(), "step_ms": ms,
            "products": len(box["shapes"]),
            "tails": sum(c[0] == "tail" for c in box["shapes"]),
            "launches": box["launches"],
            "tail_launches": box["tail_launches"],
            "foreign": sorted(str(s) for s in weights - _leaf_shapes(part))}
    if mine["foreign"] or not mine["tails"] or (dev.type == "cuda" and not (
            mine["launches"] and mine["tail_launches"])):
        raise AssertionError(f"(e) 1x2 rank {rank}: GAR weight operands "
                             f"not among its parts {mine['foreign']}, "
                             f"{mine['tails']} stage-2 products, launches "
                             f"{mine['launches']} and "
                             f"{mine['tail_launches']}")
    ranks = [None, None]
    dist.all_gather_object(ranks, mine)
    del part, state
    if rank == 0:
        one_logits, one_tokens, one_state, one_ms = _greedy(
            cfg, whole, cell, tokens, dc["steps"], None)
        err = float((logits - one_logits).abs().max()
                    / one_logits.abs().max())
        if err > spec["tol_logits"]:
            raise AssertionError(f"(e) 1x2: logits {err:.3e} of their max "
                                 "from one rank's")
        if any(r["tokens"] != one_tokens.tolist() for r in ranks):
            raise AssertionError(f"(e) 1x2: greedy tokens "
                                 f"{[r['tokens'] for r in ranks]}, one "
                                 f"rank's {one_tokens.tolist()}")
        out["e"] = {"logits_err": err, "ranks": ranks, "one_step_ms": one_ms,
                    "one_params": _nbytes(whole),
                    "params": cm.param_count(pspecs),
                    "s": time.perf_counter() - t0}
        del whole, one_state


def merge_check(dev, *, batch: int, heads: int, kv_heads: int,
                head_dim: int, length: int, shards: int, pos: int,
                window: int, seed: int = 0) -> dict:
    """The decode attention of one query a row at position ``pos`` over a
    bfloat16 cache of ``length`` rows (zero past ``pos``, as unwritten
    rows are) cut into ``shards``: the rank's steps
    (``attention.masked_logits``, ``rows_max``, ``rows_sum``,
    ``rows_out``) on each shard, their all-reduces replaced by the maxima
    and sums of the shards' parts in rank order, against whole
    ``chunked_attend``. Returns the error relative to the output's max
    with the cache's values in float32 on both sides (``err``), and with
    the cache's bfloat16 as the rank and the whole function round their
    probabilities and output to it (``bf16_err``: two roundings of one
    value part by at most an ulp, 2^-7 of the output's max)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(batch, 1, heads, head_dim, generator=gen, device=dev)
    kv = [torch.randn(batch, length, kv_heads, head_dim, generator=gen,
                      device=dev).to(torch.bfloat16) for _ in range(2)]
    for t in kv:
        t[:, pos + 1:] = 0
    k, v = kv
    q_pos = torch.tensor([pos], device=dev)
    rows = length // shards
    qs = attn._query_chunks(q, kv_heads)[:, 0]

    def merged(v_all):
        lg = [attn.masked_logits(
            qs, k[:, i * rows:(i + 1) * rows].float(), q_positions=q_pos,
            k_positions=i * rows + torch.arange(rows, device=dev),
            window=window) for i in range(shards)]
        m = attn.rows_max(lg[0])
        for x in lg[1:]:
            m = torch.maximum(m, attn.rows_max(x))
        l = attn.rows_sum(lg[0], m)
        for x in lg[1:]:
            l = l + attn.rows_sum(x, m)
        o = attn.rows_out(lg[0], m, l, v_all[:, :rows])
        for i in range(1, shards):
            o = o + attn.rows_out(lg[i], m, l,
                                  v_all[:, i * rows:(i + 1) * rows])
        return o.to(v_all.dtype).reshape(batch, 1, heads, head_dim)

    def whole(v_all):
        return attn.chunked_attend(
            q, k.float(), v_all, q_positions=q_pos,
            k_positions=torch.arange(length, device=dev), window=window)
    want = whole(v.float())
    err = float((merged(v.float()) - want).abs().max() / want.abs().max())
    a, b = merged(v).float(), whole(v).float()
    return {"err": err,
            "bf16_err": float((a - b).abs().max() / b.abs().max())}


def run_pair(spec: dict, deadline: float) -> dict:
    """Run the two ranks as processes (rank 1 once rank 0 has written
    ``a_done``) and return rank 0's ``result.json``. A rank that fails,
    or the pair past ``deadline`` seconds, raises ``RuntimeError`` with
    the ranks' last output; every process is stopped before returning."""
    import subprocess
    d = spec["dir"]
    path = os.path.join(d, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = (os.path.join(here, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    logs = [open(os.path.join(d, f"rank{r}.log"), "w") for r in (0, 1)]
    procs = []

    def start(r):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), path, str(r)],
            env=env, stdout=logs[r], stderr=subprocess.STDOUT))
    t0 = time.perf_counter()
    try:
        start(0)
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes) or \
                    time.perf_counter() - t0 > deadline:
                break
            if len(procs) == 1 and os.path.exists(os.path.join(d, "a_done")):
                start(1)
            if len(procs) == 2 and codes == [0, 0]:
                break
            if len(procs) == 1 and codes == [0]:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    codes = [p.returncode for p in procs]
    if codes != [0, 0]:
        tails = ""
        for r in range(len(procs)):
            with open(os.path.join(d, f"rank{r}.log")) as f:
                tails += f"--- rank {r} (exit {codes[r]})\n{f.read()[-3000:]}"
        raise RuntimeError(f"ranks exited {codes} after "
                           f"{time.perf_counter() - t0:.1f} s\n{tails}")
    with open(os.path.join(d, "result.json")) as f:
        return json.load(f)


def main(spec_path: str, rank: int) -> int:
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(spec["device"])
    cfg = config(spec)
    out: dict = {}
    t0 = time.perf_counter()
    dense = train.dense_init(cfg, 0, dev)
    _sync(dev)
    out["init_s"] = time.perf_counter() - t0
    ref = ref_c = None
    if rank == 0:
        ref = run_a(spec, cfg, dense, dev, out)
        if "lowrank" in spec:
            one, box = lowrank_run(spec, dev, None)
            ref_c = one.losses, _host(one.params)
            out["c_one"] = {"calls": len(box["shapes"]),
                            "launches": box["launches"],
                            "step_ms": [s * 1e3 for s in one.step_seconds]}
            del one
        open(os.path.join(spec["dir"], "a_done"), "w").close()
    run_b(spec, cfg, dense, dev, rank, ref, out, ref_c)
    if rank == 0:
        out["params"] = cm.param_count(tfm.model_spec(cfg))
        with open(os.path.join(spec["dir"], "result.json"), "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
