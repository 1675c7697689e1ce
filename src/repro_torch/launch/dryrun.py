"""The dry run: every assigned (arch x shape) cell on the reference's
production mesh, one rank of it traced on ``meta`` tensors, with what
that rank computes, exchanges and holds, and the roofline those give.
The JAX package's ``launch/dryrun.py`` lowers and compiles each cell for
a (16, 16) or (2, 16, 16) mesh of forced host devices and reads XLA's
analyses; here the process is rank 0 of a fake world of 256 or 512 ranks
(``distributed.init_world("fake", ...)``), whose collectives move
nothing, and ``launch/trace_analysis.py`` counts the step as it runs.

A cell's step is the port's program on this rank: the reference's
partitioned program (``fsdp=False``) as far as the port runs it. The
batch rows go over the data axes (where they divide; a batch of one is
held whole), and over 'model' each leaf of the parameters, the AdamW
moments and the flexrank_kd teacher is cut as ``param_shardings`` places
it (``sharding.rank_dims``): experts (``moe_apply_ep``, and at decode
``moe_apply`` over the rank's experts), heads, kv-heads, MLP columns,
vocabulary and factor rank (``models/tp.py``, the GAR form's ``v_tilde``
and ``u_hat`` among them); the attention stacks' decode caches hold this
rank's k/v heads, or its rows of a sequence cut over 'model' or 'data'
(``specs.cache_specs(mesh=)``). What the rank still holds whole is
listed in the record under ``whole``: the leaves ``sharding.deferred``
names (MLA's attention, the recurrent blocks) and the cache entries
whose placement the rank does not execute (the recurrent and latent
states, the sequence of zamba's shared attention). Parameters are bfloat16 (``specs.COMPUTE_DTYPE``), the AdamW
moments float32. The train step is ``specs.make_train_step``'s
(``specs.step`` under ``remat_blocks()``; in ``flexrank_kd`` with the
frozen dense teacher), the prefill and decode steps
``specs.make_prefill_step`` / ``make_decode_step`` under the mesh. A
record keeps the reference's keys, with the trace's figures where XLA's
stood, and adds ``placed``: the bytes a device holds under the
reference's placements (``param_shardings(fsdp=)``, ``input_shardings``,
``cache_shardings``), beside what the port executes. ``fsdp=True``
changes ``placed`` only: the port does not act on it.

The roofline's rates are the datasheet peaks of an NVIDIA H100 80GB HBM3
at 700 W: 989 TFLOP/s bfloat16 dense, 3.35 TB/s HBM, and for the
collective term one 400 Gb/s link a card between nodes (50 GB/s), since
every group of 16 or more ranks spans nodes of 8 cards.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
      --shape train_4k --mesh single --mode dense
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import distributed as D
from repro_torch import threefry
from repro_torch.configs import ASSIGNED_ARCHS, get_config, shapes_for
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import flexrank as FR
from repro_torch.distributed.sharding import dim_leaves, is_placement
from repro_torch.launch import costmodel
from repro_torch.launch import specs as SP
from repro_torch.launch import trace_analysis as TA
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import common as cm
from repro_torch.optim import adamw

# NVIDIA H100 80GB HBM3 (SXM5, 700 W), datasheet peaks
PEAK_FLOPS = 989e12       # bfloat16 dense tensor-core FLOP/s
HBM_BW = 3.35e12          # bytes/s
LINK_BW = 50e9            # bytes/s: one 400 Gb/s link a card across nodes
DEVICE_BYTES = 80e9       # the card's memory
ROOFLINE = {"device": "NVIDIA H100 80GB HBM3, 700.00 W (datasheet peaks)",
            "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "link_bw": LINK_BW,
            "device_bytes": DEVICE_BYTES}
EXECUTES = ("batch over data axes; experts, heads, kv-heads, MLP, vocab "
            "and rank over 'model' as placed; the attention stacks' decode "
            "caches as placed (heads, or the sequence over 'model' or "
            "'data'); but the leaves and cache entries listed under whole")
OUT_DIR = os.path.join("results", "dryrun_torch")


def fake_world(size: int) -> None:
    """Make this process rank 0 of a fake world of ``size`` ranks (one
    already started is kept; a real one is an error)."""
    if D.in_world():
        if D.world_backend() != "fake":
            raise RuntimeError("the dry run traces in a fake world; this "
                               f"process is in a {D.world_backend()} world")
        if dist.get_world_size() == size:
            return
        D.shutdown_world()
    D.init_world("fake", device="meta", rank=0, world_size=size)


def build_cell(arch: str, shape_name: str, multi_pod: bool, mode: str,
               mesh_override=None):
    """(cfg, shape, mesh) of a cell; the mesh spans a fake world of its
    ranks. ``mesh_override`` lays out other (pod, data, model) sizes."""
    cfg = get_config(arch)
    shape = next(s for s in shapes_for(arch) if s.name == shape_name)
    if mesh_override:
        shp = tuple(mesh_override)
        fake_world(math.prod(shp))
        mesh = make_mesh(shp, ("pod", "data", "model")[-len(shp):])
    else:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
    return cfg, shape, mesh


def local_shape(mesh, shape: ShapeConfig) -> ShapeConfig:
    """The cell's shape on one rank: the batch over the data axes where it
    divides, else whole."""
    n = mesh.size(D.data_axes(mesh))
    b = shape.global_batch
    return dataclasses.replace(shape, global_batch=b // n if b % n == 0
                               else b)


def _leaf_bytes(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _placed_bytes(mesh, leaves, placements, dtype=None) -> int:
    """Bytes on one device of ``leaves`` (specs or tensors) under
    ``placements`` (their trees' leaves in the same order); ``dtype``
    stands for the floating leaves' where given."""
    total = 0
    for leaf, pl in zip(leaves, placements):
        dt = leaf.dtype
        if dtype is not None and dt.is_floating_point:
            dt = dtype
        total += _leaf_bytes(SP.shard_shape(mesh, pl, leaf.shape), dt)
    return total


def placed(cfg: ModelConfig, shape: ShapeConfig, mesh, pspecs, paxes,
           mode: str, *, fsdp: bool) -> Dict:
    """The bytes one device holds under the reference's placements."""
    def tree(specs, axes, dtype, fs=fsdp):
        return _placed_bytes(
            mesh, cm.tree_leaves(specs, is_leaf=cm.is_spec),
            cm.tree_leaves(D.param_shardings(mesh, axes, specs, fsdp=fs),
                           is_leaf=is_placement), dtype)

    out = {"params": tree(pspecs, paxes, SP.COMPUTE_DTYPE)}
    ins = SP.input_specs(cfg, shape)
    shard = SP.input_shardings(mesh, cfg, shape)
    out["inputs"] = _placed_bytes(mesh, [ins[k] for k in sorted(ins)],
                                  [shard[k] for k in sorted(ins)])
    if shape.kind == "train":
        o = SP.optimizer_specs(pspecs)
        out["optimizer"] = 4 + 2 * tree(o.mu, paxes, None)
        if mode == "flexrank_kd":
            tspecs, taxes = SP.model_param_specs(cfg, mode="dense")
            out["teacher"] = tree(tspecs, taxes, SP.COMPUTE_DTYPE, False)
    elif shape.kind == "decode":
        cache = SP.cache_specs(cfg, shape)
        pl = SP.cache_shardings(mesh, cfg, shape, cache)
        items = [(p, t) for p, t in cm.tree_items(cache)
                 if isinstance(t, torch.Tensor)]
        pls = dict(cm.tree_items(pl, is_leaf=is_placement))
        out["cache"] = _placed_bytes(mesh, [t for _, t in items],
                                     [pls[p] for p, _ in items])
    out["total"] = sum(out.values())
    return {"fsdp": fsdp, "bytes_per_device": out}


def param_mode(mode: str) -> str:
    """The parameters' form of a run mode: dense for ``dense`` and
    ``serve``, else the mode's own (factorized, sliced, GAR)."""
    return "dense" if mode in ("dense", "serve") else mode


def _make(specs, dtype, device, gen):
    """The tree of ``specs`` on ``device``: floating leaves in ``dtype``,
    integer ones (GAR's inverse permutations) int64, as the port deploys
    them, each row a permutation drawn from ``gen`` off ``meta`` (the
    kernel scatters by it)."""
    def perm(t):
        if t.device.type == "meta":
            return t.long()
        m = t.shape[-1]
        rows = [torch.randperm(m, generator=gen)
                for _ in range(t.numel() // max(m, 1))]
        return torch.stack(rows).reshape(t.shape).to(device)
    tree = cm.instantiate(specs, gen, device=device)
    return cm.tree_map(lambda t: t.to(dtype) if t.is_floating_point()
                       else perm(t), tree)


def _inputs(cfg: ModelConfig, shape: ShapeConfig, device, gen, dtype):
    out = {}
    for k, t in SP.input_specs(cfg, shape).items():
        if t.device.type == torch.device(device).type:
            out[k] = t
        elif k == "tokens":
            out[k] = torch.randint(0, cfg.vocab_size, t.shape,
                                   generator=gen, dtype=t.dtype).to(device)
        else:
            out[k] = torch.randn(t.shape, generator=gen).to(device, dtype)
    return out


def _dims(cfg, mesh, specs):
    return D.rank_dims(cfg, mesh, cm.axes_tree(specs), specs)


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh, mode: str, *,
               device="meta", dtype=SP.COMPUTE_DTYPE, seed: int = 0):
    """The cell's step on this rank (module note) and its arguments:
    ``(step, args, facts)``, facts the local batch and, in the flexrank
    modes, the budget row the step draws. On ``meta`` (the dry run) the
    tensors are shapes; on another device (``dtype`` float32 on the
    card, where the kernels take it) they are drawn from ``seed``, every
    rank the same whole tree before it keeps its part."""
    meta = torch.device(device).type == "meta"
    gen = None if meta else torch.Generator().manual_seed(seed)
    pspecs, paxes = SP.model_param_specs(cfg, mode=param_mode(mode))
    loc = local_shape(mesh, shape)
    batch = _inputs(cfg, loc, device, gen, dtype)
    dims = _dims(cfg, mesh, pspecs)
    params = D.shard_tree(_make(pspecs, dtype, device, gen), dims, mesh)
    facts: Dict = {"local_batch": loc.global_batch}
    if shape.kind == "train":
        params = cm.tree_map(lambda t: t.requires_grad_(True), params)
        o = SP.optimizer_specs(pspecs)
        opt = adamw.AdamWState(
            step=0, mu=D.shard_tree(_make(o.mu, torch.float32, device, gen),
                                    dims, mesh),
            nu=D.shard_tree(_make(o.nu, torch.float32, device, gen), dims,
                            mesh))
        tmode = mode if mode in ("flexrank", "flexrank_kd") else "dense"
        step = SP.make_train_step(cfg, adamw.AdamWConfig(), mode=tmode)
        rng = threefry.prng_key(seed)
        args = [params, opt, batch, rng]
        if mode == "flexrank_kd":
            tspecs, _ = SP.model_param_specs(cfg, mode="dense")
            args.append(D.shard_tree(_make(tspecs, dtype, device, gen),
                                     _dims(cfg, mesh, tspecs), mesh))
        if tmode != "dense":
            facts["budget_k"] = FR.budget_draw(
                rng, len(cfg.flexrank.budgets[:7]))
    elif shape.kind == "prefill":
        step = SP.make_prefill_step(cfg)
        args = [params, batch]
    else:
        step = SP.make_decode_step(cfg)
        args = [params, SP.cache_specs(cfg, shape, dtype=dtype,
                                       device=device, mesh=mesh), batch]
    return step, args, facts


def whole_on_rank(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  mode: str) -> Dict:
    """What this rank holds whole though the reference's placements cut
    it over 'model' (module note): ``leaves`` maps a parameter path to
    the reason (``sharding.deferred``), ``cache`` a decode cache entry's
    path to its placement."""
    pspecs, paxes = SP.model_param_specs(cfg, mode=param_mode(mode))
    full = D.model_dims(mesh, paxes, pspecs)
    paths = [p for p, _ in cm.tree_items(pspecs, is_leaf=cm.is_spec)]
    leaves = {}
    for path, d in zip(paths, dim_leaves(full)):
        why = d is not None and D.deferred(cfg, path)
        if why:
            leaves[path] = why
    out: Dict = {"leaves": leaves}
    if shape.kind == "decode":
        held = dict(cm.tree_items(SP.cache_specs(cfg, shape, mesh=mesh)))
        whole = SP.cache_specs(cfg, shape)
        pls = dict(cm.tree_items(SP.cache_shardings(mesh, cfg, shape, whole),
                                 is_leaf=is_placement))
        cache = {}
        for path, t in cm.tree_items(whole):
            if not isinstance(t, torch.Tensor):
                continue
            want = SP.shard_shape(mesh, pls[path], t.shape)
            if tuple(held[path].shape) != want:
                cache[path] = [None if e is None else list(e)
                               for e in pls[path]]
        out["cache"] = cache
    return out


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, mode: str, *,
               fsdp: bool = False) -> Tuple[Dict, Dict, Dict]:
    """Build the cell's step on ``meta`` and trace one call of it as rank
    0. Returns (the trace's figures, ``placed``, facts of the step with
    the seconds to build and to trace)."""
    for g in mesh.groups.values():
        if dist.get_rank(g) < 0:
            raise RuntimeError("the traced rank is not in every group of "
                               "its mesh")
    t0 = time.perf_counter()
    step, args, facts = build_step(cfg, shape, mesh, mode)
    facts["build_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    with D.mesh_context(mesh):
        _, fig = TA.trace(step, *args)
    facts["trace_s"] = time.perf_counter() - t1
    pspecs, paxes = SP.model_param_specs(cfg, mode=param_mode(mode))
    return fig, placed(cfg, shape, mesh, pspecs, paxes, mode,
                       fsdp=fsdp), facts


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic MODEL_FLOPS: 6ND train / 2ND prefill / 2N_active*B
    decode, N the active parameters (an MoE layer's top-k experts)."""
    n_total = cm.param_count(SP.model_param_specs(cfg, mode="dense")[0])
    n_active = n_total
    if cfg.moe is not None:
        m = cfg.moe
        per_expert = 3 * cfg.d_model * m.d_ff_expert
        moe_layers = sum(s.count for s in cfg.segments if s.kind == "attn")
        n_active = n_total - moe_layers * (m.num_experts - m.top_k) \
            * per_expert
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, mode: str,
             out_dir: Optional[str], mesh_override=None, tag: str = "",
             fsdp: bool = False) -> Dict:
    """Trace one cell and write its record to ``out_dir`` (if given); a
    failure is recorded (``status: "fail"``, its error and traceback)."""
    cfg, shape, mesh = build_cell(arch, shape_name, multi_pod, mode,
                                  mesh_override)
    chips = math.prod(mesh.shape.values())
    rec: Dict = {"arch": arch, "shape": shape_name, "mode": mode,
                 "mesh": "x".join(str(v) for v in mesh.shape.values()),
                 "chips": chips, "rank": 0, "executes": EXECUTES,
                 "roofline": ROOFLINE}
    t0 = time.time()
    try:
        fig, rec["placed"], facts = trace_cell(cfg, shape, mesh, mode,
                                               fsdp=fsdp)
        rec["placed"]["note"] = ("the reference's placements; fsdp changes "
                                 "these only, the port does not act on it")
        rec["whole"] = whole_on_rank(cfg, shape, mesh, mode)
        rec.update(facts)
        rec["lower_s"] = round(facts["build_s"], 1)
        rec["compile_s"] = None            # nothing is compiled
        rec["bytes_per_device"] = fig["bytes"]
        rec["xla_raw"] = None              # no XLA cost analysis here
        rec["hlo_flops_per_device"] = fig["flops_dot"]
        rec["dot_count"] = fig["dot_count"]
        coll = fig["collective_bytes_total"]
        rec["collective_bytes_per_device"] = coll
        rec["collectives"] = fig["collective_bytes"]
        rec["collective_counts"] = fig["collective_counts_static"]
        rec["collective_counts_dynamic"] = fig["collective_counts_dynamic"]
        rec["kernel_work"] = fig["kernel_work"]
        traffic = costmodel.memory_traffic(cfg, shape,
                                           mesh_shape=dict(mesh.shape))
        rec["hlo_bytes_per_device"] = traffic["total"]
        rec["memory_traffic"] = traffic
        rec["t_compute"] = fig["flops_dot"] / PEAK_FLOPS
        rec["t_memory"] = traffic["total"] / HBM_BW
        rec["t_collective"] = coll / LINK_BW
        terms = {"compute": rec["t_compute"], "memory": rec["t_memory"],
                 "collective": rec["t_collective"]}
        rec["bottleneck"] = max(terms, key=terms.get)
        mf = model_flops(cfg, shape)
        rec["model_flops_total"] = mf
        rec["useful_flops_ratio"] = mf / max(fig["flops_dot"] * chips, 1.0)
        rec["fits_device"] = fig["bytes"]["peak"] <= DEVICE_BYTES
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}__{shape_name}__{rec['mesh']}__{mode}" + (
            f"__{tag}" if tag else "")
        with open(os.path.join(out_dir, fname + ".json"), "w") as f:
            json.dump(rec, f, indent=2)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--mode", default="dense",
                    choices=["dense", "flexrank", "flexrank_kd", "gar"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--all", action="store_true",
                    help="run every assigned (arch x shape) on this mesh")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s.name) for a in ASSIGNED_ARCHS for s in shapes_for(a)]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    for arch, shape_name in cells:
        rec = run_cell(arch, shape_name, multi_pod=args.mesh == "multi",
                       mode=args.mode, out_dir=args.out)
        keys = ("status", "mesh", "lower_s", "trace_s", "bottleneck",
                "t_compute", "t_memory", "t_collective")
        print(f"[{arch} {shape_name} {args.mode}] "
              + " ".join(f"{k}={rec.get(k)}" for k in keys), flush=True)
        if rec["status"] != "ok":
            print(rec.get("error"), flush=True)
    D.shutdown_world()


if __name__ == "__main__":
    main()
