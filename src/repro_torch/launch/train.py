"""Training launcher on the card: dense pretraining, or FlexRank
consolidation (paper Algorithm 1: calibrate, DataSVD-decompose and
DP-select a seeded dense model, then train the nested factorized model),
with AdamW or Muon, checkpoint/restart and preemption handling, and an
elastic eval of every budget row.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \
      --mode flexrank_kd --steps 20 --seq-len 128 --batch 8 \
      --ckpt-dir /tmp/ckpt --ckpt-every 10

Runs on the GPU; ``--device cpu`` runs the plain PyTorch versions of the
kernels instead (use ``--smoke`` there). The flags are those of
``repro.launch.train``, and so are the branches:
- ``--mode flexrank_kd``: the consolidation loss (distillation from the
  frozen dense model at a budget row drawn from the DP table);
- ``--mode dense`` and ``--mode flexrank`` with AdamW: the reference's
  ``make_train_step`` (``launch/specs.py``), under ``remat_blocks()``;
  ``flexrank`` builds the DP state but trains on the uniform table;
- ``--mode dense`` and ``--mode flexrank`` with Muon: a plain
  cross-entropy step, no ranks and no remat, as in the reference.
Muon takes ten times ``--lr`` for its matrix leaves. ``--grad-compress``
is parsed and not read, as in the reference. The SIGTERM guard is
installed before the dense init, as in the reference, so a preemption
during the set-up saves at step 1.

Across ranks (``torchrun --nproc-per-node N -m repro_torch.launch.train
--mesh-shape D,M ...``, or any launcher that sets ``RANK``,
``WORLD_SIZE`` and ``MASTER_ADDR``) the launcher starts
``torch.distributed`` (NCCL where every rank has a card of its own, by the
cards' UUIDs, else gloo; the ``[mesh]`` line names it) and builds the
reference's elastic mesh over the world: the data axis takes what the
ranks leave after ``M``. Each data rank trains on its rows of the global
batch; each 'model' rank holds every leaf as the reference's
``param_shardings`` places it (``distributed.sharding.rank_dims``): its
``E / M`` of every MoE layer's experts, routing its chunk of the
sequence (``models/moe.py:moe_apply_ep``), and its heads, kv-heads, MLP
columns and vocabulary rows, run tensor-parallel (``models/tp.py``); the
leaves ``sharding.deferred`` names stay whole. The flexrank_kd teacher is
cut by its own spec's dims. Every rank runs the build stages
(calibration, DataSVD, DP) the same way on the whole model, outside the
mesh, then keeps its part. After the backward, every gradient is averaged
over the data axes (a cut leaf's within its 'model' column), the
clipping norm counts each cut leaf once, and Muon orthogonalizes a cut
matrix whole. Rank 0 logs and writes the checkpoints, in the one-device
format with every cut leaf gathered first, so a checkpoint restores at
any world size; the preemption flag is agreed
by every rank at each step boundary. Without ``torch.distributed``,
``--mesh-shape`` builds the mesh over the one device the run uses: ``4,1``
shrinks to 1 x 1; a model dimension above 1 fails its assertion.

Every training and eval forward runs under the mesh (``mesh_context``),
as in the reference, so an MoE layer takes ``moe_apply_ep``: on one
device, one slice of all ``B * S`` tokens with its own capacity.

Each step draws its budget row as the reference does,
``randint(fold_in(PRNGKey(seed + 1), step), (), 0, K)``, bit for bit, and
its batch is ``source.batch_at(step)``, so both packages see the same rows
and tokens at every step, and a restart at step k consumes the batches it
would have seen.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device, threefry
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import distill
from repro_torch.core import flexrank as FR
from repro_torch.core.profiles import ProfileTable
from repro_torch.data import calibration_batches, make_source
from repro_torch import distributed as D
from repro_torch.distributed import (Mesh, PreemptionGuard,
                                     StragglerMonitor, elastic_remesh)
from repro_torch.distributed import collectives as C
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import single_device_mesh
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw, muon

EVAL_STEP = 10_000        # the step index of the elastic-eval batch


def dense_init(cfg, seed: int, device) -> dict:
    """Seeded dense parameters: drawn on the CPU from a ``torch.Generator``
    (the same values whatever the device), then moved."""
    gen = torch.Generator().manual_seed(seed)
    return cm.tree_map(lambda t: t.to(device),
                       cm.instantiate(tfm.model_spec(cfg), gen))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_flexrank_state(cfg, dense_params, source, *, calib_batches=8,
                         timings: Optional[Dict[str, float]] = None):
    """Paper Algorithm 1 stages 1-2: calibrate (the first ``calib_batches``
    batches of ``source``, text only, as in the reference), DataSVD-
    decompose, DP-select. Returns (factorized params, table, infos);
    ``timings`` (if given) receives the seconds of each stage,
    ``calibrate``, ``decompose`` and ``dp``, and ``plain_svd``, the number
    of groups no moment covered, which took plain SVD (the encoder, the
    cross blocks and ``frontend_proj`` of the audio and vision
    families)."""
    device = cm.tree_leaves(dense_params)[0].device
    t = {}
    t0 = time.perf_counter()
    moments = FR.collect_moments(dense_params, cfg,
                                 calibration_batches(source, calib_batches))
    _sync(device)
    t["calibrate"] = time.perf_counter() - t0
    t["plain_svd"] = len(FR.plain_svd_groups(cfg, moments))
    t0 = time.perf_counter()
    fact_params, curves = FR.decompose(dense_params, cfg, moments)
    _sync(device)
    t["decompose"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    table, infos = FR.build_table(cfg, curves)
    t["dp"] = time.perf_counter() - t0
    if timings is not None:
        timings.update(t)
    return fact_params, table, infos


@dataclasses.dataclass
class TrainRun:
    """What ``run`` did: the trained params and optimizer state (this
    rank's part: ``shard_dims`` gives each leaf's dimension split over
    'model', None where a leaf is whole; ``full_state`` puts them back
    together), the profile table and groups (None in dense mode), and
    per-step and per-row records."""
    params: Any
    opt_state: Union[adamw.AdamWState, muon.MuonState]
    table: Optional[ProfileTable]
    infos: Optional[list]
    losses: List[float]             # loss per step (this invocation's)
    budget_rows: List[Optional[int]]  # row drawn per step, where known
    step_seconds: List[float]       # host clock per step, ending in a sync
    setup_seconds: Dict[str, float]
    eval_before: List[float]        # per-row CE on the eval batch
    eval_after: List[float]
    mesh: Optional[Mesh] = None
    shard_dims: Any = None
    sync_seconds: List[float] = dataclasses.field(default_factory=list)
    start_step: int = 0             # the step a restart resumed from
    preempted: bool = False

    def full_state(self):
        """(params, opt_state) whole: every cut leaf gathered over
        'model' (a collective: every rank calls it)."""
        return _whole((self.params, self.opt_state), self.shard_dims,
                      self.mesh)


def train_step(params, opt_state, loss_fn: Callable, opt_cfg: SP.OptConfig,
               batch: Dict, rng: threefry.Key, *, mesh: Optional[Mesh] = None,
               shard_dims=None, remat: bool = False):
    """One step of ``loss_fn(params, batch, rng) -> (loss, metrics)``
    through ``specs.step`` (under ``remat_blocks`` with ``remat``; under a
    ``mesh`` with groups the gradients averaged over its data axes, the
    clipping norm counting the leaves split over 'model' along
    ``shard_dims`` once). Returns (params, opt_state, metrics) with
    metrics ``loss`` (a float, averaged over the data axes: the step ends
    in a sync), ``budget_k``, ``lr`` and ``sync``, the seconds of the
    gradients' all-reduce."""
    params, opt_state, _, m = SP.step(
        params, opt_state, lambda: loss_fn(params, batch, rng), opt_cfg,
        remat=remat, mesh=mesh, shard_dims=shard_dims)
    group = None if mesh is None else mesh.group(D.data_axes(mesh))
    return params, opt_state, {
        "loss": C.reduce_host(float(m["loss"]), group),
        "budget_k": m["budget_k"], "lr": m["lr"], "sync": m["sync"]}


def cross_entropy_loss(cfg) -> Callable:
    """The reference's Muon step for ``--mode dense`` and ``--mode
    flexrank``: next-token cross-entropy plus aux of the forward at full
    rank, no remat. Returns ``loss_fn(params, batch, rng) -> (loss,
    metrics)``."""
    def loss_fn(params, batch, rng):
        logits, aux = tfm.forward(params, cfg, batch["tokens"][:, :-1])
        loss = distill.cross_entropy(logits, batch["tokens"][:, 1:],
                                     vocab=cfg.vocab_size) + aux
        return loss, {"loss": loss.detach(), "budget_k": None}
    return loss_fn


# ------------------------------------------------- the tree over the mesh

def _map_state(fn, tree, dims):
    """``fn(leaves, dims)`` over (params, AdamW or Muon state) or params,
    the optimizer's moments taking their parameters' dims."""
    if isinstance(tree, tuple) and len(tree) == 2 and not hasattr(
            tree, "_fields"):
        return (_map_state(fn, tree[0], dims),
                _map_state(fn, tree[1], dims))
    if isinstance(tree, adamw.AdamWState):
        return tree._replace(mu=fn(tree.mu, dims), nu=fn(tree.nu, dims))
    if isinstance(tree, muon.MuonState):
        return tree._replace(momentum=fn(tree.momentum, dims),
                             adamw_state=_map_state(fn, tree.adamw_state,
                                                    dims))
    return fn(tree, dims)


def _part(tree, dims, mesh):
    return _map_state(lambda t, d: D.shard_tree(t, d, mesh), tree, dims)


def _whole(tree, dims, mesh):
    if mesh is None or mesh.group("model") is None:
        return tree
    return _map_state(lambda t, d: D.unshard_tree(t, d, mesh), tree, dims)


def _any_rank(flag: bool, mesh: Mesh) -> bool:
    """``flag`` or'ed over every rank of the mesh (a barrier, too)."""
    if not mesh.groups:
        return flag
    return bool(C.reduce_host(float(flag), dist.group.WORLD, "max"))


def run(cfg, dense_params, source, *, steps: int, lr: float = 1e-3,
        seed: int = 0, log: Callable[[str], None] = print,
        mode: str = "flexrank_kd", optimizer: str = "adamw",
        ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
        eval_before: bool = True,
        step_hook: Optional[Callable[[int], None]] = None,
        guard: Optional[PreemptionGuard] = None,
        mesh: Optional[Mesh] = None) -> TrainRun:
    """Train from ``dense_params`` on ``source``'s batches, on the device
    of the dense params, as ``repro.launch.train.main`` does: in the
    flexrank modes build the FlexRank state first (the dense params are
    the frozen teacher of ``flexrank_kd``), take ``steps`` steps of
    ``mode`` with ``optimizer``, and in the flexrank modes evaluate every
    budget row on the batch at ``EVAL_STEP`` after (and before, with
    ``eval_before``). The trained leaves are copies: the optimizer
    updates them in place, and the decomposition shares the unfactorized
    leaves (embedding, norms) with the teacher.

    ``mesh`` (default: the one device's 1 x 1 mesh) is entered for every
    training and eval forward. Over ranks (a mesh with groups; every rank
    calls ``run`` with the same arguments and its own device's dense
    params) each data rank takes its rows of every batch, each 'model'
    rank its part of every leaf (``TrainRun.shard_dims``), and gradients,
    losses and eval losses are averaged over the data axes (module note).

    With ``ckpt_dir``: resume from its latest committed step, save
    ``(params, opt_state)`` every ``ckpt_every`` steps (async) and at the
    end (blocking); on SIGTERM (``PreemptionGuard``, on any rank) save at
    the next step boundary (blocking) and return with ``preempted``.
    ``step_hook(step)`` runs after each step, before its saves. Without
    ``guard``, ``run`` installs its own before the first step and restores
    the old handler before the final eval; a caller's ``guard`` (``main``'s,
    installed before the set-up) is left to the caller."""
    device = cm.tree_leaves(dense_params)[0].device
    mesh = mesh if mesh is not None else single_device_mesh(device)
    d_axes = D.data_axes(mesh)
    n_data, data_index = mesh.size(d_axes), mesh.index(d_axes)
    data_group = mesh.group(d_axes)
    lead = mesh.index(mesh.axis_names) == 0
    setup: Dict[str, float] = {}
    table = infos = table_rows = None
    if mode.startswith("flexrank"):
        fact, table, infos = build_flexrank_state(cfg, dense_params, source,
                                                  timings=setup)
        log(f"[flexrank] {len(infos)} groups, {table.table.shape[0]} nested "
            f"budgets (calibrate {setup['calibrate']:.2f} s, decompose "
            f"{setup['decompose']:.2f} s, DP {setup['dp']:.2f} s)")
        table_rows = FR.table_host(table)
        spec = FR.factorized_spec(cfg)
    else:
        fact = dense_params
        spec = tfm.model_spec(cfg)
    dims = D.rank_dims(cfg, mesh, cm.axes_tree(spec), fact)
    params = cm.tree_map(
        lambda t: t.detach().clone().requires_grad_(True), fact)
    del fact
    opt_cfg: SP.OptConfig = adamw.AdamWConfig(
        lr=lr, warmup_steps=min(100, steps // 10 + 1), total_steps=steps)
    if optimizer == "muon":
        opt_cfg = muon.MuonConfig(lr=lr * 10, adamw=opt_cfg)

    def opt_init(p):
        return muon.init(p, opt_cfg) if optimizer == "muon" else \
            adamw.init(p)

    # a checkpoint holds the whole state: restore it whole, then keep this
    # rank's part
    mgr = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None
    start_step, opt_state = 0, None
    if mgr and mgr.latest_step() is not None:
        (params, opt_state), start_step = mgr.restore(
            (params, opt_init(params)))
        opt_state = _part(opt_state, dims, mesh)
        log(f"[restart] resumed from step {start_step}")
    params = cm.tree_map(lambda t: t.detach().requires_grad_(True),
                         _part(params, dims, mesh))
    if opt_state is None:
        opt_state = opt_init(params)

    remat = False
    if mode == "flexrank_kd":
        # the teacher is the dense model: its own leaves, its own dims
        teacher_dims = D.rank_dims(
            cfg, mesh, cm.axes_tree(tfm.model_spec(cfg)), dense_params)
        loss_fn = FR.make_consolidation_loss(
            cfg, infos, table_rows, _part(dense_params, teacher_dims, mesh))
    elif optimizer == "muon":
        loss_fn = cross_entropy_loss(cfg)
    else:
        spec_loss = SP.make_train_step(cfg, opt_cfg, mode=mode).loss_fn
        remat = True

        def loss_fn(params, batch, rng):
            loss = spec_loss(params, batch, rng)
            return loss, {"loss": loss.detach(), "budget_k": None}

    def step_fn(params, opt_state, batch, rng):
        return train_step(params, opt_state, loss_fn, opt_cfg, batch, rng,
                          mesh=mesh, shard_dims=dims, remat=remat)

    def tokens_at(step):
        tokens = source.batch_at(step)["tokens"]
        if n_data > 1:
            if tokens.shape[0] % n_data:
                raise ValueError(f"a batch of {tokens.shape[0]} rows over "
                                 f"{n_data} data ranks")
            b = tokens.shape[0] // n_data
            tokens = tokens[data_index * b:(data_index + 1) * b]
        return {"tokens": torch.as_tensor(tokens, device=device)}

    def elastic_eval():
        if infos is None:
            return []
        batch = tokens_at(EVAL_STEP)
        with D.mesh_context(mesh):
            return [C.reduce_host(FR.eval_budget_loss(
                params, cfg, infos, table_rows, batch, k), data_group)
                for k in range(table_rows.shape[0])]

    def save(step, blocking=False):
        """Rank 0 writes the whole state (every rank gathers); a blocking
        save returns on every rank once the step is committed."""
        whole = _whole((params, opt_state), dims, mesh)
        if lead:
            mgr.save(step, whole, blocking=blocking)
        if blocking:
            _any_rank(False, mesh)

    before = elastic_eval() if eval_before else []
    monitor = StragglerMonitor()
    own_guard = guard is None
    if own_guard:
        guard = PreemptionGuard()
    losses, rows, secs, syncs = [], [], [], []
    base_key = threefry.prng_key(seed + 1)

    def result(**kw) -> TrainRun:
        return TrainRun(params=params, opt_state=opt_state, table=table,
                        infos=infos, losses=losses, budget_rows=rows,
                        step_seconds=secs, setup_seconds=setup,
                        eval_before=before, mesh=mesh, shard_dims=dims,
                        sync_seconds=syncs, start_step=start_step, **kw)
    try:
        for step in range(start_step, steps):
            batch = tokens_at(step)
            rng = threefry.fold_in(base_key, step)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 rng)
            dt = time.perf_counter() - t0
            losses.append(metrics["loss"])
            rows.append(metrics["budget_k"])
            secs.append(dt)
            syncs.append(metrics["sync"])
            if monitor.record(dt):
                log(f"[straggler] step {step} took {dt:.2f}s (median "
                    f"{monitor.median:.2f}s)")
            if step % 10 == 0 or step == steps - 1:
                row = "" if rows[-1] is None else f" row {rows[-1]}"
                log(f"step {step:5d} loss {losses[-1]:.4f} lr "
                    f"{metrics['lr']:.2e}{row} {dt * 1000:.0f}ms")
            if step_hook is not None:
                step_hook(step)
            if mgr and (step + 1) % ckpt_every == 0:
                save(step + 1)
            if _any_rank(guard.requested, mesh):
                log(f"[preempt] checkpoint at step {step + 1} and exit")
                if mgr:
                    save(step + 1, blocking=True)
                return result(eval_after=[], preempted=True)
        if mgr:
            save(steps, blocking=True)
    finally:
        if own_guard:
            guard.restore()
        if mgr:
            mgr.wait()
    after = elastic_eval()
    if infos is not None:
        log("[elastic eval] per-budget CE:")
        for k, ce in enumerate(after):
            budget = table.budgets[min(k, len(table.budgets) - 1)]
            log(f"  budget {budget:.2f} (row {k}): {ce:.4f}")
    return result(eval_after=after)


def _start_world(device_flag) -> torch.device:
    """Start ``torch.distributed`` from the environment ``torchrun`` sets
    (``distributed.init_world_from_env``: NCCL where every rank has a card
    of its own, else gloo), each rank on the card ``LOCAL_RANK`` names
    among those it sees. Returns this rank's device."""
    device = resolve_device(device_flag)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    D.init_world_from_env(device)
    return device


def main(argv=None, *, step_hook: Optional[Callable[[int], None]] = None):
    """The command line of ``repro.launch.train``. Returns (params,
    losses) as the reference's ``main`` does (across ranks, this rank's
    params); ``step_hook`` goes to ``run``. The SIGTERM guard is
    installed first, as the reference's ``main`` installs it before the
    dense init, so a preemption during the set-up or the final eval kills
    nothing; the old handler is back once ``main`` returns. Where the
    environment names a world (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``)
    and ``torch.distributed`` is not started yet, ``main`` starts it and
    tears it down at the end."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-small")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, an error without "
                         "it); cpu runs the kernels' plain versions")
    ap.add_argument("--mode", default="dense",
                    choices=["dense", "flexrank", "flexrank_kd"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh-shape", default=None,
                    help="e.g. 2,4: the reference's elastic mesh over the "
                         "world's ranks (the data axis takes what the "
                         "ranks leave after the model axis), or over the "
                         "one device without torch.distributed; default "
                         "single device")
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "muon"],
                    help="muon: Newton-Schulz orthogonalized momentum for "
                         "matrix params (paper §7's suggested direction)")
    ap.add_argument("--grad-compress", action="store_true",
                    help="PowerSGD gradient compression: parsed and not "
                         "read, as in the reference")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    started = (not D.in_world() and all(
        k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")))
    device = _start_world(args.device) if started else \
        resolve_device(args.device)
    guard = PreemptionGuard()
    try:
        lead = not D.in_world() or dist.get_rank() == 0
        log = print if lead else (lambda msg: None)
        if args.grad_compress:
            log("[grad-compress] parsed and not read, as in the reference: "
                "the data-parallel all-reduce is uncompressed")
        cfg = get_config(args.arch, smoke=args.smoke)
        if args.mesh_shape:
            shape = tuple(int(x) for x in args.mesh_shape.split(","))
            names = ("data", "model")[: len(shape)]
            mesh = elastic_remesh(shape, names) if D.in_world() else \
                elastic_remesh(shape, names, devices=[device])
            log(f"[mesh] {args.mesh_shape} -> {mesh.shape} on {device}, "
                f"{D.world_backend() or 'no process group'}")
        else:
            mesh = single_device_mesh(device)
        source = make_source(cfg.vocab_size, args.seq_len, args.batch,
                             seed=args.seed)
        dense = dense_init(cfg, args.seed, device)
        result = run(cfg, dense, source, steps=args.steps, lr=args.lr,
                     seed=args.seed, mode=args.mode, log=log,
                     optimizer=args.optimizer, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, eval_before=False,
                     step_hook=step_hook, guard=guard, mesh=mesh)
    finally:
        guard.restore()
        if started:
            D.shutdown_world()
    tokens = args.batch * args.seq_len
    if result.step_seconds:
        med = float(np.median(result.step_seconds))
        log(f"# training: {args.mode}, {args.optimizer}, "
            f"{len(result.losses)} steps, median {med * 1e3:.1f} ms/step, "
            f"{tokens / med:.0f} tokens/s ({device}, mesh {mesh.shape})")
    return result.params, result.losses


if __name__ == "__main__":
    main()
