"""Training launcher on the card: FlexRank consolidation (paper Algorithm
1): calibrate, DataSVD-decompose and DP-select a seeded dense model, then
train the nested factorized model against it by stochastic-budget
distillation with AdamW, and evaluate every budget row.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \
      --steps 20 --seq-len 128 --batch 8

Runs on the GPU; ``--device cpu`` runs the plain PyTorch versions of the
kernels instead (use ``--smoke`` there). The flags are those of
``repro.launch.train``; the ones whose code is not ported yet raise.
Each step draws its budget row as the reference does,
``randint(fold_in(PRNGKey(seed + 1), step), (), 0, K)``, bit for bit, and
its batch is ``source.batch_at(step)``, so both packages see the same rows
and tokens at every step.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device, threefry
from repro_torch.configs import get_config
from repro_torch.core import flexrank as FR
from repro_torch.core.profiles import ProfileTable
from repro_torch.data import calibration_batches, make_source
from repro_torch.distributed import StragglerMonitor
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw

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
    profile table, and per-step and per-row records."""
    params: Any
    opt_state: adamw.AdamWState
    table: ProfileTable
    infos: list
    losses: List[float]             # consolidation loss per step
    budget_rows: List[int]          # budget row drawn per step
    step_seconds: List[float]       # host clock per step, ending in a sync
    setup_seconds: Dict[str, float]
    eval_before: List[float]        # per-row CE on the eval batch
    eval_after: List[float]


def train_step(params, opt_state: adamw.AdamWState, loss_fn: Callable,
               opt_cfg: adamw.AdamWConfig, batch: Dict, rng: threefry.Key):
    """One consolidation step: loss and gradients by autograd, then the
    in-place AdamW update. Returns (params, opt_state, metrics) with
    metrics ``loss`` (a float: the step ends in a sync), ``budget_k`` and
    ``lr``."""
    loss, metrics = loss_fn(params, batch, rng)
    loss.backward()
    # a leaf the loss does not reach (zamba2's per-unit ``ln_attn``: the
    # shared block has its own norm) has a zero gradient, as under jax.grad
    grads = cm.tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                        else p.grad, params)
    params, opt_state, om = adamw.apply_updates(params, grads, opt_state,
                                                opt_cfg)
    for p in cm.tree_leaves(params):
        p.grad = None
    return params, opt_state, {"loss": float(metrics["loss"]),
                               "budget_k": metrics["budget_k"],
                               "lr": om["lr"]}


def run(cfg, dense_params, source, *, steps: int, lr: float = 1e-3,
        seed: int = 0, log: Callable[[str], None] = print) -> TrainRun:
    """FlexRank consolidation from ``dense_params`` (the frozen teacher) on
    ``source``'s batches, on the device of the dense params: build the
    FlexRank state, take ``steps`` AdamW steps of the consolidation loss,
    and evaluate every budget row on the batch at ``EVAL_STEP`` before and
    after. The student's leaves are copies: the optimizer updates them in
    place, and the decomposition shares the unfactorized leaves (embedding,
    norms) with the teacher."""
    device = cm.tree_leaves(dense_params)[0].device
    setup: Dict[str, float] = {}
    fact, table, infos = build_flexrank_state(cfg, dense_params, source,
                                              timings=setup)
    log(f"[flexrank] {len(infos)} groups, {table.table.shape[0]} nested "
        f"budgets (calibrate {setup['calibrate']:.2f} s, decompose "
        f"{setup['decompose']:.2f} s, DP {setup['dp']:.2f} s)")
    params = cm.tree_map(
        lambda t: t.detach().clone().requires_grad_(True), fact)
    del fact
    table_rows = FR.table_host(table)
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=min(100, steps // 10 + 1),
                                total_steps=steps)
    opt_state = adamw.init(params)
    loss_fn = FR.make_consolidation_loss(cfg, infos, table_rows, dense_params)

    def tokens_at(step):
        return {"tokens": torch.as_tensor(source.batch_at(step)["tokens"],
                                          device=device)}

    def elastic_eval():
        batch = tokens_at(EVAL_STEP)
        return [FR.eval_budget_loss(params, cfg, infos, table_rows, batch, k)
                for k in range(table_rows.shape[0])]

    eval_before = elastic_eval()
    monitor = StragglerMonitor()
    losses, rows, secs = [], [], []
    base_key = threefry.prng_key(seed + 1)
    for step in range(steps):
        batch = tokens_at(step)
        rng = threefry.fold_in(base_key, step)
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, loss_fn,
                                                opt_cfg, batch, rng)
        dt = time.perf_counter() - t0
        losses.append(metrics["loss"])
        rows.append(metrics["budget_k"])
        secs.append(dt)
        if monitor.record(dt):
            log(f"[straggler] step {step} took {dt:.2f}s (median "
                f"{monitor.median:.2f}s)")
        if step % 10 == 0 or step == steps - 1:
            log(f"step {step:5d} loss {losses[-1]:.4f} lr "
                f"{metrics['lr']:.2e} row {rows[-1]} {dt * 1000:.0f}ms")
    eval_after = elastic_eval()
    log("[elastic eval] per-budget CE:")
    for k, ce in enumerate(eval_after):
        budget = table.budgets[min(k, len(table.budgets) - 1)]
        log(f"  budget {budget:.2f} (row {k}): {ce:.4f}")
    return TrainRun(params=params, opt_state=opt_state, table=table,
                    infos=infos, losses=losses, budget_rows=rows,
                    step_seconds=secs, setup_seconds=setup,
                    eval_before=eval_before, eval_after=eval_after)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-small")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, an error without "
                         "it); cpu runs the kernels' plain versions")
    ap.add_argument("--mode", default="flexrank_kd",
                    choices=["dense", "flexrank", "flexrank_kd"],
                    help="flexrank_kd is ported; dense and flexrank raise")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="not ported yet (raises)")
    ap.add_argument("--mesh-shape", default=None,
                    help="not ported yet (raises)")
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "muon"],
                    help="muon is not ported yet (raises)")
    ap.add_argument("--grad-compress", action="store_true",
                    help="not ported yet (raises)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    todo = {"--mode dense/flexrank (ROADMAP A.9: the dense and label-only "
            "train steps)": args.mode != "flexrank_kd",
            "--optimizer muon (ROADMAP A.9)": args.optimizer == "muon",
            "--grad-compress (ROADMAP A.9: PowerSGD)": args.grad_compress,
            "--mesh-shape (ROADMAP A.11: distributed training)":
                args.mesh_shape is not None,
            "--ckpt-dir (ROADMAP A.9: checkpoint/restart)":
                args.ckpt_dir is not None}
    for what, asked in todo.items():
        if asked:
            raise NotImplementedError(f"{what} is not ported yet")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    source = make_source(cfg.vocab_size, args.seq_len, args.batch,
                         seed=args.seed)
    dense = dense_init(cfg, args.seed, device)
    result = run(cfg, dense, source, steps=args.steps, lr=args.lr,
                 seed=args.seed)
    tokens = args.batch * args.seq_len
    if result.step_seconds:
        med = float(np.median(result.step_seconds))
        print(f"# training: {len(result.losses)} steps, median "
              f"{med * 1e3:.1f} ms/step, {tokens / med:.0f} tokens/s "
              f"({device})")
    return result.params, result.losses


if __name__ == "__main__":
    main()
