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
changes no step on one device, as in the reference (nothing is
all-reduced). ``--mesh-shape`` builds the reference's elastic mesh over
the one device the run uses: ``4,1`` shrinks to 1 x 1 and trains as
without the flag; a model dimension above 1 fails its assertion.
The SIGTERM guard is installed before the dense init, as in the
reference, so a preemption during the set-up saves at step 1.

Each step draws its budget row as the reference does,
``randint(fold_in(PRNGKey(seed + 1), step), (), 0, K)``, bit for bit, and
its batch is ``source.batch_at(step)``, so both packages see the same rows
and tokens at every step, and a restart at step k consumes the batches it
would have seen.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device, threefry
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import distill
from repro_torch.core import flexrank as FR
from repro_torch.core.profiles import ProfileTable
from repro_torch.data import calibration_batches, make_source
from repro_torch.distributed import (PreemptionGuard, StragglerMonitor,
                                     elastic_remesh)
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
    """What ``run`` did: the trained params and optimizer state, the
    profile table and groups (None in dense mode), and per-step and
    per-row records."""
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
    start_step: int = 0             # the step a restart resumed from
    preempted: bool = False


OptConfig = Union[adamw.AdamWConfig, muon.MuonConfig]


def apply_updates(params, grads, opt_state, opt_cfg: OptConfig):
    """The optimizer step of ``opt_cfg``'s kind, in place."""
    if isinstance(opt_cfg, muon.MuonConfig):
        return muon.apply_updates(params, grads, opt_state, opt_cfg)
    return adamw.apply_updates(params, grads, opt_state, opt_cfg)


def train_step(params, opt_state, loss_fn: Callable, opt_cfg: OptConfig,
               batch: Dict, rng: threefry.Key):
    """One step of ``loss_fn(params, batch, rng) -> (loss, metrics)``:
    loss and gradients by autograd, then the in-place AdamW or Muon update.
    Returns (params, opt_state, metrics) with metrics ``loss`` (a float:
    the step ends in a sync), ``budget_k`` and ``lr``."""
    loss, metrics = loss_fn(params, batch, rng)
    loss.backward()
    params, opt_state, om = apply_updates(params, SP.grads_of(params),
                                          opt_state, opt_cfg)
    SP.clear_grads(params)
    return params, opt_state, {"loss": float(metrics["loss"]),
                               "budget_k": metrics["budget_k"],
                               "lr": om["lr"]}


def cross_entropy_loss(cfg) -> Callable:
    """The reference's Muon step for ``--mode dense`` and ``--mode
    flexrank``: next-token cross-entropy plus aux of the forward at full
    rank, no remat. Returns ``loss_fn(params, batch, rng) -> (loss,
    metrics)``."""
    def loss_fn(params, batch, rng):
        logits, aux = tfm.forward(params, cfg, batch["tokens"][:, :-1])
        loss = distill.cross_entropy(logits, batch["tokens"][:, 1:]) + aux
        return loss, {"loss": loss.detach(), "budget_k": None}
    return loss_fn


def run(cfg, dense_params, source, *, steps: int, lr: float = 1e-3,
        seed: int = 0, log: Callable[[str], None] = print,
        mode: str = "flexrank_kd", optimizer: str = "adamw",
        ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
        eval_before: bool = True,
        step_hook: Optional[Callable[[int], None]] = None,
        guard: Optional[PreemptionGuard] = None) -> TrainRun:
    """Train from ``dense_params`` on ``source``'s batches, on the device
    of the dense params, as ``repro.launch.train.main`` does: in the
    flexrank modes build the FlexRank state first (the dense params are
    the frozen teacher of ``flexrank_kd``), take ``steps`` steps of
    ``mode`` with ``optimizer``, and in the flexrank modes evaluate every
    budget row on the batch at ``EVAL_STEP`` after (and before, with
    ``eval_before``). The trained leaves are copies: the optimizer
    updates them in place, and the decomposition shares the unfactorized
    leaves (embedding, norms) with the teacher.

    With ``ckpt_dir``: resume from its latest committed step, save
    ``(params, opt_state)`` every ``ckpt_every`` steps (async) and at the
    end (blocking); on SIGTERM (``PreemptionGuard``) save at the next
    step boundary (blocking) and return with ``preempted``.
    ``step_hook(step)`` runs after each step, before its saves. Without
    ``guard``, ``run`` installs its own before the first step and restores
    the old handler before the final eval; a caller's ``guard`` (``main``'s,
    installed before the set-up) is left to the caller."""
    device = cm.tree_leaves(dense_params)[0].device
    setup: Dict[str, float] = {}
    table = infos = table_rows = None
    if mode.startswith("flexrank"):
        fact, table, infos = build_flexrank_state(cfg, dense_params, source,
                                                  timings=setup)
        log(f"[flexrank] {len(infos)} groups, {table.table.shape[0]} nested "
            f"budgets (calibrate {setup['calibrate']:.2f} s, decompose "
            f"{setup['decompose']:.2f} s, DP {setup['dp']:.2f} s)")
        table_rows = FR.table_host(table)
    else:
        fact = dense_params
    params = cm.tree_map(
        lambda t: t.detach().clone().requires_grad_(True), fact)
    del fact
    opt_cfg: OptConfig = adamw.AdamWConfig(
        lr=lr, warmup_steps=min(100, steps // 10 + 1), total_steps=steps)
    if optimizer == "muon":
        opt_cfg = muon.MuonConfig(lr=lr * 10, adamw=opt_cfg)
        opt_state = muon.init(params, opt_cfg)
    else:
        opt_state = adamw.init(params)

    mgr = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None
    start_step = 0
    if mgr and mgr.latest_step() is not None:
        (params, opt_state), start_step = mgr.restore((params, opt_state))
        params = cm.tree_map(lambda t: t.requires_grad_(True), params)
        log(f"[restart] resumed from step {start_step}")

    if mode == "flexrank_kd":
        loss_fn = FR.make_consolidation_loss(cfg, infos, table_rows,
                                             dense_params)
    elif optimizer == "muon":
        loss_fn = cross_entropy_loss(cfg)
    else:
        spec_step = SP.make_train_step(cfg, opt_cfg, mode=mode)
        loss_fn = None

    def step_fn(params, opt_state, batch, rng):
        if loss_fn is not None:
            return train_step(params, opt_state, loss_fn, opt_cfg, batch,
                              rng)
        params, opt_state, m = spec_step(params, opt_state, batch, rng)
        return params, opt_state, {"loss": float(m["loss"]),
                                   "budget_k": None, "lr": m["lr"]}

    def tokens_at(step):
        return {"tokens": torch.as_tensor(source.batch_at(step)["tokens"],
                                          device=device)}

    def elastic_eval():
        if infos is None:
            return []
        batch = tokens_at(EVAL_STEP)
        return [FR.eval_budget_loss(params, cfg, infos, table_rows, batch, k)
                for k in range(table_rows.shape[0])]

    before = elastic_eval() if eval_before else []
    monitor = StragglerMonitor()
    own_guard = guard is None
    if own_guard:
        guard = PreemptionGuard()
    losses, rows, secs = [], [], []
    base_key = threefry.prng_key(seed + 1)

    def result(**kw) -> TrainRun:
        return TrainRun(params=params, opt_state=opt_state, table=table,
                        infos=infos, losses=losses, budget_rows=rows,
                        step_seconds=secs, setup_seconds=setup,
                        eval_before=before, start_step=start_step, **kw)
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
                mgr.save(step + 1, (params, opt_state))
            if guard.requested:
                log(f"[preempt] checkpoint at step {step + 1} and exit")
                if mgr:
                    mgr.save(step + 1, (params, opt_state), blocking=True)
                return result(eval_after=[], preempted=True)
        if mgr:
            mgr.save(steps, (params, opt_state), blocking=True)
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


def main(argv=None, *, step_hook: Optional[Callable[[int], None]] = None):
    """The command line of ``repro.launch.train``. Returns (params,
    losses) as the reference's ``main`` does; ``step_hook`` goes to
    ``run``. The SIGTERM guard is installed first, as the reference's
    ``main`` installs it before the dense init, so a preemption during the
    set-up or the final eval kills nothing; the old handler is back once
    ``main`` returns."""
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
                    help="e.g. 4,1: the reference's elastic mesh over the "
                         "one device the run uses (the data axis shrinks "
                         "to 1; a model dimension above 1 fails); default "
                         "single device")
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "muon"],
                    help="muon: Newton-Schulz orthogonalized momentum for "
                         "matrix params (paper §7's suggested direction)")
    ap.add_argument("--grad-compress", action="store_true",
                    help="PowerSGD gradient compression: changes nothing "
                         "on one device, as in the reference")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.grad_compress:
        print("[grad-compress] one device: nothing is all-reduced, so no "
              "gradient is compressed; PowerSGD over a data-parallel "
              "all-reduce waits for ROADMAP A.11")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.mesh_shape:
        shape = tuple(int(x) for x in args.mesh_shape.split(","))
        mesh = elastic_remesh(shape, ("data", "model")[: len(shape)],
                              devices=[device])
        print(f"[mesh] {args.mesh_shape} -> {mesh.shape} on {device}")
    else:
        mesh = single_device_mesh(device)
    source = make_source(cfg.vocab_size, args.seq_len, args.batch,
                         seed=args.seed)
    guard = PreemptionGuard()
    try:
        dense = dense_init(cfg, args.seed, mesh.devices.flat[0])
        result = run(cfg, dense, source, steps=args.steps, lr=args.lr,
                     seed=args.seed, mode=args.mode,
                     optimizer=args.optimizer, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, eval_before=False,
                     step_hook=step_hook, guard=guard)
    finally:
        guard.restore()
    tokens = args.batch * args.seq_len
    if result.step_seconds:
        med = float(np.median(result.step_seconds))
        print(f"# training: {args.mode}, {args.optimizer}, "
              f"{len(result.losses)} steps, median {med * 1e3:.1f} ms/step, "
              f"{tokens / med:.0f} tokens/s ({device})")
    return result.params, result.losses


if __name__ == "__main__":
    main()
