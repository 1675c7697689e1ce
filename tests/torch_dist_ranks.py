"""The rank side of ``tests/test_torch_dist.py`` and
``tests/test_torch_tp.py``: one process of a world of CPU ranks over
gloo. It imports torch and the port only, so that a
rank starts fast and needs no JAX.

    python tests/torch_dist_ranks.py SPEC.json RANK

``SPEC.json`` holds the world (``world``, ``shape``, ``port``, a
``main_port`` for the launcher's own start), the directory the inputs
come from and the results go to (``dir``), and the jobs. Each job's
results go into ``rank<RANK>.npz``; the test compares them. A rank that
raises exits with code 1, and its peers' next collective fails at the
group's timeout.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import os
import signal
import sys

import numpy as np
import torch

from repro_torch import distributed as D
from repro_torch import threefry
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import collectives as C
from repro_torch.configs import get_config
from repro_torch.data import make_source
from repro_torch.launch import train as ttrain
from repro_torch.core import distill
from repro_torch.launch import specs as SP
from repro_torch.models import attention as tattn
from repro_torch.models import common as cm
from repro_torch.models import moe as tmoe
from repro_torch.models import tp
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as TC

TIMEOUT = datetime.timedelta(seconds=30)
_SHAPE = ShapeConfig("tp", 16, 4, "decode")


def variant(arch: str, name: str):
    """The smoke config of ``arch`` at the test's capacity: ``default``,
    ``w5`` (a local window of 5), or ``nodrop`` (every pair kept: capacity
    factor E), ``nodrop_aux0``
    (and no aux loss: the per-slice aux is the EP path's own function,
    which the global path does not compute)."""
    cfg = get_config(arch, smoke=True)
    if name == "default":
        return cfg
    if name == "w5":
        return dataclasses.replace(cfg, local_window=5)
    moe = dataclasses.replace(cfg.moe,
                              capacity_factor=float(cfg.moe.num_experts))
    if name == "nodrop_aux0":
        moe = dataclasses.replace(moe, router_aux_weight=0.0)
    return dataclasses.replace(cfg, moe=moe)


def gar_moe_spec(cfg, budget: int):
    """The GAR spec of the first MoE layer's FFN of ``cfg`` deployed at
    ``budget`` (an index of its budgets), without the layers axis."""
    spec = SP.model_param_specs(cfg, mode="gar", budget_index=budget)[0]
    seg = next(i for i, s in enumerate(cfg.segments) if s.kind == "attn")
    return cm.tree_map(lambda s: dataclasses.replace(
        s, shape=s.shape[1:], axes=s.axes[1:]),
        spec["segments"][seg]["mlp"], is_leaf=cm.is_spec)


def tree_from(arrays, prefix: str, spec):
    """The tree of ``spec`` with each leaf ``arrays[prefix/path]``."""
    it = iter([torch.as_tensor(arrays[f"{prefix}/{path}"])
               for path, _ in cm.tree_items(spec, is_leaf=cm.is_spec)])
    return cm.tree_map(lambda _: next(it), spec, is_leaf=cm.is_spec)


def put_tree(out: dict, prefix: str, tree) -> None:
    for path, t in cm.tree_items(tree):
        out[f"{prefix}/{path}"] = t.detach().numpy()


class Rank:
    def __init__(self, spec: dict, rank: int):
        self.spec, self.rank = spec, rank
        self.world, self.shape = spec["world"], tuple(spec["shape"])
        self.inputs = np.load(os.path.join(spec["dir"], "inputs.npz"))
        self.out: dict = {}
        self._mesh = None
        self._meshes = None

    def mesh(self):
        if not D.in_world():
            D.init_world("gloo", device="cpu", rank=self.rank,
                         world_size=self.world, timeout=TIMEOUT,
                         init_method=f"tcp://127.0.0.1:{self.spec['port']}")
            self._mesh = D.elastic_remesh(self.shape, ("data", "model"))
        return self._mesh

    def tp_meshes(self) -> dict:
        """A world of four: its (2, 2) and (1, 4) meshes, and the (1, 2)
        mesh of this rank's pair (ranks 0-1 and 2-3, two replicas of one
        (1, 2) program), keyed "2x2", "1x4", "1x2"."""
        if self._mesh is None:
            self.mesh()
            full = self._mesh
            pair = D.Mesh(D.device_array(["cpu"] * 2, (1, 2)),
                          ("data", "model"),
                          {("model",): full.group("model")},
                          (0, full.index("model")))
            self._meshes = {"2x2": full, "1x2": pair,
                            "1x4": D.mesh_over_world((1, 4),
                                                     ("data", "model"))}
        return self._meshes

    def _tp_mesh(self, job):
        """The job's mesh: the world's own where it is of that shape, else
        one of ``tp_meshes``'."""
        if job["mesh"] == "x".join(map(str, self.shape)):
            return self.mesh()
        return self.tp_meshes()[job["mesh"]]

    # ----------------------------------------------------------- jobs

    def tp_linear(self, job):
        """``common.linear`` on this rank's part of each leaf of
        ``tp/linear/<case>``: forward at each nested rank, the whole
        output (gathered where it is this rank's columns) and the input's
        and every leaf's gradient of ``sum(y * ct)``."""
        mesh = self._tp_mesh(job)
        group = mesh.group("model")
        for case in job["cases"]:
            pre = f"tp/linear/{case['name']}"
            whole = tuple(case["whole"])
            leaf = {k: torch.as_tensor(self.inputs[f"{pre}/p/{k}"])
                    for k in case["keys"]}
            part = {k: D.shard_tree(t, case["dims"][k], mesh)
                    for k, t in leaf.items()}
            for rank in case["ranks"]:
                p = {k: t.clone().requires_grad_(True)
                     for k, t in part.items()}
                x = torch.as_tensor(self.inputs[f"{pre}/x"]).clone()
                if case["x_cut"]:
                    x = C.scatter(x, -1, group).detach()
                x.requires_grad_(True)
                with D.mesh_context(mesh):
                    y = cm.linear(p, x, rank=rank, whole=whole)
                    if y.shape[-1] != whole[1]:
                        y = C.gather(y, -1, group)
                ct = torch.as_tensor(self.inputs[f"{pre}/ct"])
                torch.sum(y * ct).backward()
                key = f"{pre}/{rank}"
                self.out[f"{key}/y"] = y.detach().numpy()
                self.out[f"{key}/gx"] = x.grad.numpy()
                for k, t in p.items():
                    self.out[f"{key}/g/{k}"] = t.grad.numpy()

    def tp_vocab(self, job):
        """The losses on this rank's vocabulary columns of
        ``tp/vocab/<V>/s`` (and the teacher's ``t``): cross-entropy and the
        consolidation loss at kd weights 1 and 0.5, and each one's
        gradient of the student's whole logits."""
        mesh = self._tp_mesh(job)
        group = mesh.group("model")
        for v in job["vocabs"]:
            pre = f"tp/vocab/{v}"
            labels = torch.as_tensor(self.inputs[f"{pre}/labels"])
            t = torch.as_tensor(self.inputs[f"{pre}/t"])
            for name in ("ce", "kd1", "kd05"):
                s = torch.as_tensor(self.inputs[f"{pre}/s"]).clone()
                cut = s.shape[-1] % mesh.size("model") == 0
                if cut:
                    s = C.scatter(s, -1, group).detach()
                s.requires_grad_(True)
                tt = C.scatter(t, -1, group) if cut else t
                with D.mesh_context(mesh):
                    if name == "ce":
                        loss = distill.cross_entropy(s, labels, vocab=v)
                    else:
                        loss = distill.consolidation_loss(
                            s, tt, labels, vocab=v, temperature=2.0,
                            kd_weight=1.0 if name == "kd1" else 0.5)
                loss.backward()
                g = s.grad
                if cut:
                    g = C.all_gather_along(g, -1, group)
                self.out[f"{pre}/{name}/loss"] = loss.detach().numpy()
                self.out[f"{pre}/{name}/g"] = g.numpy()

    def tp_attn(self, job):
        """``attn_apply`` of ``tp/attn`` on this rank's part of its
        leaves: the output and every whole gradient of ``sum(y * ct)``,
        then a prefill and one decode step over a cache of every head
        (its 2 kv heads do not divide 4; 9 rows do not either): their
        outputs."""
        mesh = self._tp_mesh(job)
        cfg = get_config(job["arch"], smoke=True)
        spec = tattn.attn_spec(cfg)
        whole = tree_from(self.inputs, "tp/attn/p", spec)
        dims = D.rank_dims(cfg, mesh, cm.axes_tree(spec), spec)
        p = cm.tree_map(lambda t: t.requires_grad_(True),
                        D.shard_tree(whole, dims, mesh))
        x = torch.as_tensor(self.inputs["tp/attn/x"]).clone()
        x.requires_grad_(True)
        s = x.shape[1]
        with D.mesh_context(mesh):
            y, _ = tattn.attn_apply(p, x, cfg, positions=torch.arange(s),
                                    window=job["window"])
        torch.sum(y * torch.as_tensor(self.inputs["tp/attn/ct"])).backward()
        self.out["tp/attn/y"] = y.detach().numpy()
        self.out["tp/attn/gx"] = x.grad.numpy()
        grads = D.unshard_tree(cm.tree_map(lambda t: t.grad, p), dims, mesh)
        put_tree(self.out, "tp/attn/g", grads)
        cache = SP.cache_specs(cfg, ShapeConfig("a", s + 1, x.shape[0],
                                                "decode"),
                               dtype=torch.float32, device="cpu",
                               mesh=mesh)["segments"][0]
        cache = {k: (v[0] if k != "idx" else v) for k, v in cache.items()}
        self.out["tp/attn/cache_heads"] = np.int64(cache["k"].shape[2])
        with torch.no_grad(), D.mesh_context(mesh):
            y1, cache = tattn.attn_apply(p, x[:, :s - 1], cfg,
                                         positions=torch.arange(s - 1),
                                         window=job["window"], cache=cache)
            y2, _ = tattn.attn_apply(p, x[:, s - 1:], cfg,
                                     positions=torch.arange(s - 1, s),
                                     window=job["window"], cache=cache)
        self.out["tp/attn/cached"] = torch.cat([y1, y2], 1).numpy()

    def tp_step(self, job):
        """``specs.make_train_step``'s step on this rank's part of every
        leaf (``rank_dims``) and its data rows, each case ``[arch,
        variant, mode]``: before it, the loss's gradient of every leaf
        this rank holds whole; after it, the loss (averaged over the data
        ranks), the parameters and AdamW's first moment gathered whole,
        and this rank's bytes of parameters and moments. Then the prefill
        and decode steps' logits on the updated parts."""
        mesh = self._tp_mesh(job)
        nd, di = mesh.size("data"), mesh.index("data")
        key0 = f"tp/step/{job['mesh']}"
        for arch, name, mode in job["cases"]:
            cfg = variant(arch, name)
            pre = f"tp/step/{arch}/{mode}"
            pspecs, paxes = SP.model_param_specs(cfg, mode=mode)
            dims = D.rank_dims(cfg, mesh, paxes, pspecs)
            params = cm.tree_map(
                lambda t: t.requires_grad_(True),
                D.shard_tree(tree_from(self.inputs, f"{pre}/p", pspecs),
                             dims, mesh))
            teacher = None
            if mode == "flexrank_kd":
                tspecs, taxes = SP.model_param_specs(cfg, mode="dense")
                teacher = D.shard_tree(
                    tree_from(self.inputs, f"{pre}/t", tspecs),
                    D.rank_dims(cfg, mesh, taxes, tspecs), mesh)
            batch = {}
            for k in ("tokens", "frontend"):
                if f"{pre}/{k}" in self.inputs:
                    a = torch.as_tensor(self.inputs[f"{pre}/{k}"])
                    rows = a.shape[0] // nd
                    batch[k] = a[di * rows:(di + 1) * rows]
            step = SP.make_train_step(cfg, tadamw.AdamWConfig(), mode=mode)
            rng = threefry.prng_key(3)
            out = f"{key0}/{arch}/{mode}"
            with D.mesh_context(mesh), tfm.remat_blocks():
                step.loss_fn(params, batch, rng, teacher).backward()
            for (path, t), d in zip(cm.tree_items(params),
                                    D.sharding.dim_leaves(dims)):
                if d is None or mesh.size("model") == 1:
                    self.out[f"{out}/g_whole/{path}"] = t.grad.numpy()
            SP.clear_grads(params)
            opt = tadamw.init(params)
            with D.mesh_context(mesh):
                params, opt, m = step(params, opt, batch, rng, teacher)
            self.out[f"{out}/loss"] = np.float64(C.reduce_host(
                float(m["loss"]), mesh.group(("data",))))
            put_tree(self.out, f"{out}/params",
                     D.unshard_tree(params, dims, mesh))
            put_tree(self.out, f"{out}/mu", D.unshard_tree(opt.mu, dims,
                                                          mesh))
            nbytes = [sum(t.numel() * t.element_size()
                          for t in cm.tree_leaves(tree))
                      for tree in (params, opt.mu, opt.nu)]
            self.out[f"{out}/bytes"] = np.asarray(nbytes, np.int64)
            if mode != "dense":
                continue
            with D.mesh_context(mesh):
                fl = SP.make_prefill_step(cfg)(params, {
                    k: v[:, :-1] if k == "tokens" else v
                    for k, v in batch.items()})
            with D.mesh_context(mesh):
                state = SP.cache_specs(cfg, dataclasses.replace(
                    _SHAPE, global_batch=batch["tokens"].shape[0] * nd,
                    seq_len=batch["tokens"].shape[1]), dtype=torch.float32,
                    device="cpu", mesh=mesh)
                if "frontend" in batch:
                    tfm.attach_cross_kv(params, cfg, state, tfm.frontend_proj(
                        params, batch["frontend"], cfg))
                dec = SP.make_decode_step(cfg)
                logits = []
                for i in range(3):
                    lg, state = dec(params, state, {
                        "tokens": batch["tokens"][:, i:i + 1]})
                    logits.append(lg)
            self.out[f"{out}/prefill"] = fl.numpy()
            self.out[f"{out}/decode"] = torch.stack(logits, 1).numpy()

    def tp_decode(self, job):
        """A prompt through ``prefill`` into this rank's part of the decode
        cache (``specs.cache_specs(mesh=)``) on its part of every leaf,
        then decode steps teacher-forced from ``tp/decode/<case>/tokens``
        (the parameters of the job's ``mode``, dense by default, at its
        ``budget`` index in ``gar`` mode):
        the logits (whole over the vocabulary), the caches gathered whole,
        and this rank's bytes of parameters and cache. A bfloat16 cache
        also gives the float32 value of each write before its rounding
        (``test_torch_bf16_ties.Bf16Writes``), gathered whole."""
        mesh = self._tp_mesh(job)
        name, arch, var, _, b, dtype, prompt, steps, cache_len = job["case"]
        cfg = variant(arch, var)
        pre = f"tp/decode/{name}"
        pspecs, paxes = SP.model_param_specs(
            cfg, mode=job.get("mode", "dense"), budget_index=job.get("budget"))
        dims = D.rank_dims(cfg, mesh, paxes, pspecs)
        params = D.shard_tree(tree_from(self.inputs, f"{pre}/p", pspecs),
                              dims, mesh)
        nd, di = mesh.size("data"), mesh.index("data")
        tokens = torch.as_tensor(self.inputs[f"{pre}/tokens"])
        if b % nd == 0 and b > 1:
            tokens = tokens[di * b // nd:(di + 1) * b // nd]
        shape = ShapeConfig("d", cache_len, b, "decode")
        dt = getattr(torch, dtype)
        dec = SP.make_decode_step(cfg)
        with torch.no_grad(), D.mesh_context(mesh):
            state = SP.cache_specs(cfg, shape, dtype=dt, device="cpu",
                                   mesh=mesh)
            caches = [c for c in state["segments"] if c is not None]
            writes = contextlib.nullcontext()
            if dt == torch.bfloat16:
                from test_torch_bf16_ties import Bf16Writes
                writes = Bf16Writes(*(c[k] for c in caches for k in "kv"))
            with writes as rec:
                lg, state = tfm.prefill(params, cfg, state,
                                        tokens[:, :prompt])
                logits = [tp.whole_vocab(lg, cfg.vocab_size)]
                for i in range(steps):
                    lg, state = dec(params, state, {
                        "tokens": tokens[:, prompt + i:prompt + i + 1]})
                    logits.append(lg[:, None])
            self.out[f"{pre}/logits"] = torch.cat(logits, 1).float().numpy()
            for j, c in enumerate(caches):
                for k in ("k", "v"):
                    self.out[f"{pre}/cache/{j}/{k}"] = _whole_cache(
                        mesh, cfg, c, c[k], b).float().numpy()
                    if rec is not None:
                        self.out[f"{pre}/shadow/{j}/{k}"] = _whole_cache(
                            mesh, cfg, c, rec.shadow(c[k]), b).numpy()
        self.out[f"{pre}/bytes"] = np.asarray([
            sum(t.numel() * t.element_size() for t in cm.tree_leaves(tree)
                if isinstance(t, torch.Tensor))
            for tree in (params, state)], np.int64)

    def tp_gar_linear(self, job):
        """The GAR ``common.linear`` on this rank's part of each leaf of
        ``tp/gar/<case>`` (``perm_inv`` whole): the output (gathered where
        it is this rank's columns), and the input's and both factors'
        gradients of ``sum(y * ct)``, each factor's as this rank's part."""
        mesh = self._tp_mesh(job)
        group = mesh.group("model")
        for case in job["cases"]:
            pre = f"tp/gar/{case['name']}"
            whole = tuple(case["whole"])
            p = {k: D.shard_tree(torch.as_tensor(self.inputs[f"{pre}/p/{k}"]),
                                 d, mesh).clone()
                 for k, d in case["dims"].items()}
            for k in ("v_tilde", "u_hat"):
                p[k].requires_grad_(True)
            x = torch.as_tensor(self.inputs[f"{pre}/x"]).clone()
            if case["x_cut"]:
                x = C.scatter(x, -1, group).detach()
            x.requires_grad_(True)
            with D.mesh_context(mesh):
                y = cm.linear(p, x, whole=whole)
                self.out[f"{pre}/cols"] = np.int64(y.shape[-1])
                if y.shape[-1] != whole[1]:
                    y = C.gather(y, -1, group)
            torch.sum(y * torch.as_tensor(self.inputs[f"{pre}/ct"])).backward()
            self.out[f"{pre}/y"] = y.detach().numpy()
            self.out[f"{pre}/gx"] = x.grad.numpy()
            for k in ("v_tilde", "u_hat"):
                self.out[f"{pre}/g/{k}"] = p[k].grad.numpy()

    def tp_gar_moe(self, job):
        """``moe_apply`` of GAR expert leaves cut by E over this rank's
        experts (``rank_dims``: the shared experts' GAR leaves cut as
        placed), each case ``[arch, variant, budget index]``: the output,
        aux, and the input's and every leaf's gradient (gathered whole)
        of ``sum(y * ct) + aux``."""
        mesh = self._tp_mesh(job)
        for arch, var, budget in job["cases"]:
            cfg = variant(arch, var)
            pre = f"tp/garmoe/{arch}/{budget}"
            spec = gar_moe_spec(cfg, budget)
            dims = D.rank_dims(cfg, mesh, cm.axes_tree(spec), spec)
            p = D.shard_tree(tree_from(self.inputs, f"{pre}/p", spec), dims,
                             mesh)
            p = cm.tree_map(lambda t: t.requires_grad_(t.is_floating_point()),
                            p)
            x = torch.as_tensor(self.inputs[f"{pre}/x"]).clone()
            x.requires_grad_(True)
            with D.mesh_context(mesh):
                y, aux = tmoe.moe_apply(p, x, cfg)
            (torch.sum(y * torch.as_tensor(self.inputs[f"{pre}/ct"]))
             + aux).backward()
            self.out[f"{pre}/y"] = y.detach().numpy()
            self.out[f"{pre}/aux"] = aux.detach().numpy()
            self.out[f"{pre}/gx"] = x.grad.numpy()
            self.out[f"{pre}/held"] = np.int64(
                p["experts"]["gate"]["v_tilde"].shape[0])
            grads = cm.tree_map(
                lambda t: t.grad if t.is_floating_point()
                else torch.zeros(t.shape), p)
            put_tree(self.out, f"{pre}/g", D.unshard_tree(grads, dims, mesh))

    def tp_moe_part(self, job):
        """``moe_apply_ep`` where the tokens do not divide the 'model' axis
        (its fallback: ``moe_apply`` over this rank's experts), each case
        ``[arch, variant]``: the output, aux, and the whole input's and
        every leaf's gradient (gathered whole) of ``sum(y * ct) + aux``."""
        mesh = self._tp_mesh(job)
        for arch, var in job["cases"]:
            cfg = variant(arch, var)
            pre = f"tp/moe/{arch}/{var}"
            spec = tmoe.moe_spec(cfg)
            dims = D.rank_dims(cfg, mesh, cm.axes_tree(spec), spec)
            p = cm.tree_map(lambda t: t.requires_grad_(True), D.shard_tree(
                tree_from(self.inputs, f"{pre}/p", spec), dims, mesh))
            x = torch.as_tensor(self.inputs[f"{pre}/x"]).clone()
            x.requires_grad_(True)
            with D.mesh_context(mesh):
                y, aux = tmoe.moe_apply_ep(p, x, cfg)
            (torch.sum(y * torch.as_tensor(self.inputs[f"{pre}/ct"]))
             + aux).backward()
            self.out[f"{pre}/y"] = y.detach().numpy()
            self.out[f"{pre}/aux"] = aux.detach().numpy()
            self.out[f"{pre}/gx"] = x.grad.numpy()
            self.out[f"{pre}/held"] = np.int64(
                p["experts"]["gate"]["w"].shape[0])
            put_tree(self.out, f"{pre}/g", D.unshard_tree(
                cm.tree_map(lambda t: t.grad, p), dims, mesh))

    def tp_run(self, job):
        """Two steps of ``launch/train.py:run`` on the mesh (each run
        ``[arch, mode, optimizer]``; the dense AdamW one checkpointed into
        ``write``), then a restore of the one-rank checkpoint in ``read``
        and one more step."""
        mesh = self._tp_mesh(job)
        for arch, mode, optimizer in job["runs"]:
            cfg = get_config(arch, smoke=True)
            source = make_source(cfg.vocab_size, 16, 4, seed=0)
            ck = job.get("ckpt") if (mode, optimizer) == ("dense",
                                                          "adamw") else None
            res = ttrain.run(cfg, self._dense(arch), source, steps=2,
                             mode=mode, optimizer=optimizer,
                             eval_before=False, mesh=mesh,
                             ckpt_dir=None if ck is None else ck["write"],
                             log=lambda m: None)
            self._keep(f"tp/run/{arch}/{mode}/{optimizer}", res)
            if ck is None:
                continue
            res = ttrain.run(cfg, self._dense(arch), source, steps=3,
                             ckpt_dir=ck["read"], mode="dense",
                             eval_before=False,
                             mesh=mesh, log=lambda m: None)
            self.out["tp/ckpt/restored/start"] = np.int64(res.start_step)
            self._keep("tp/ckpt/restored", res)

    def count(self, job):
        """The dry run's step of a smoke cell (``dryrun.build_step``) on
        this rank's CPU tensors, traced: its counts (``trace_counts``)."""
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import dryrun
        from repro_torch.launch import trace_analysis as TA
        cfg = get_config(job["arch"], smoke=True)
        shape = ShapeConfig("t", job["seq"], job["batch"], job["step"])
        mesh = self.mesh()
        step, args, _ = dryrun.build_step(cfg, shape, mesh, job["mode"],
                                          device="cpu", dtype=torch.float32)
        with D.mesh_context(mesh):
            _, fig = TA.trace(step, *args)
        self.out.update(trace_counts(fig))

    def moe(self, job):
        """``moe_apply_ep`` forward and backward on this rank's rows and
        experts, at each capacity: the loss ``sum(out * ct) + aux /
        n_data`` (summed over the data ranks: the global ``sum(out * ct)
        + aux``), and at no drop ``sum(out * ct)`` alone."""
        mesh = self.mesh()
        nd, di = mesh.size("data"), mesh.index("data")
        nm, mi = mesh.size("model"), mesh.index("model")
        for arch in job["archs"]:
            pre = f"moe/{arch}"
            for name, loss_kind in (("default", "aux"), ("nodrop", "aux"),
                                    ("nodrop", "out")):
                cfg = variant(arch, name)
                p = tree_from(self.inputs, f"{pre}/p", tmoe.moe_spec(cfg))
                e_loc = cfg.moe.num_experts // nm
                p["experts"] = cm.tree_map(
                    lambda t: t[mi * e_loc:(mi + 1) * e_loc].clone(),
                    p["experts"])
                p = cm.tree_map(lambda t: t.requires_grad_(True), p)
                x, ct = (torch.as_tensor(self.inputs[f"{pre}/{k}"])
                         for k in ("x", "ct"))
                rows = x.shape[0] // nd
                x = x[di * rows:(di + 1) * rows].clone().requires_grad_(True)
                ct = ct[di * rows:(di + 1) * rows]
                with D.mesh_context(mesh):
                    y, aux = tmoe.moe_apply_ep(p, x, cfg)
                loss = torch.sum(y * ct)
                if loss_kind == "aux":
                    loss = loss + aux / nd
                loss.backward()
                key = f"{pre}/{name}_{loss_kind}"
                self.out[f"{key}/out"] = y.detach().numpy()
                self.out[f"{key}/aux"] = aux.detach().numpy()
                self.out[f"{key}/gx"] = x.grad.numpy()
                put_tree(self.out, f"{key}/grad",
                         cm.tree_map(lambda t: t.grad, p))

    def powersgd(self, job):
        """``compress_decompress(axis_name="data")`` for three steps of
        this rank's gradients."""
        mesh = self.mesh()
        di = mesh.index("data")
        tmpl = {k[len("psgd/tmpl/"):]: torch.as_tensor(v)
                for k, v in self.inputs.items() if k.startswith("psgd/tmpl/")}
        tmpl = _nest(tmpl)
        cfg = TC.PowerSGDConfig(rank=4, min_compress_size=256)
        st = TC.init(tmpl, cfg, seed=3)
        for step in range(3):
            flat = {k.split("/", 2)[2]: torch.as_tensor(v)
                    for k, v in self.inputs.items()
                    if k.startswith(f"psgd/s{step}r{di}/")}
            with D.mesh_context(mesh):
                g, st, metrics = TC.compress_decompress(
                    _nest(flat), st, cfg, axis_name="data")
            put_tree(self.out, f"psgd/{step}/g", g)
            put_tree(self.out, f"psgd/{step}/e", st.error)
            put_tree(self.out, f"psgd/{step}/q", st.q)
        self.out["psgd/ratio"] = np.float64(metrics["powersgd_ratio"])

    def _dense(self, arch):
        cfg = get_config(arch, smoke=True)
        return tree_from(self.inputs, f"dense/{arch}", tfm.model_spec(cfg))

    def _keep(self, key, res):
        self.out[f"{key}/losses"] = np.asarray(res.losses)
        params, _ = res.full_state()
        put_tree(self.out, f"{key}/params", params)
        put_tree(self.out, f"{key}/local", res.params)

    def train(self, job):
        """Two steps of ``launch/train.py:run`` on the mesh, each run
        ``[arch, variant]`` (``--mode dense``, AdamW) or ``[arch, variant,
        mode, optimizer]``; the flexrank modes keep their elastic eval."""
        mesh = self.mesh()
        for arch, name, *how in job["runs"]:
            mode, optimizer = how or ("dense", "adamw")
            cfg = variant(arch, name)
            source = make_source(cfg.vocab_size, 16, 4, seed=0)
            res = ttrain.run(cfg, self._dense(arch), source, steps=2,
                             mode=mode, optimizer=optimizer,
                             eval_before=False, mesh=mesh,
                             log=lambda m: None)
            key = f"train/{arch}/{name}" + (f"/{mode}/{optimizer}"
                                             if how else "")
            self._keep(key, res)
            self.out[f"{key}/eval"] = np.asarray(res.eval_after)

    def main(self, job):
        """The launcher's command line, the world started by the launcher
        from the environment ``torchrun`` would set (and torn down after),
        on the JAX package's dense weights."""
        os.environ.update(RANK=str(self.rank), WORLD_SIZE=str(self.world),
                          LOCAL_RANK=str(self.rank),
                          MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(self.spec["main_port"]))
        arch = job["arch"]
        ttrain.dense_init = lambda cfg, seed, device: self._dense(arch)
        _, losses = ttrain.main(
            ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
             "--seq-len", "16", "--batch", "4", "--mesh-shape",
             ",".join(map(str, self.shape))])
        assert not D.in_world()
        self.out[f"main/{arch}/losses"] = np.asarray(losses)

    def ckpt(self, job):
        """A checkpoint written here (2 steps) and one written on one rank,
        restored here (no step left to take, then one more step)."""
        mesh = self.mesh()
        arch = job["arch"]
        cfg = get_config(arch, smoke=True)
        source = make_source(cfg.vocab_size, 16, 4, seed=0)
        common = dict(mode="dense", eval_before=False, mesh=mesh,
                      log=lambda m: None)
        res = ttrain.run(cfg, self._dense(arch), source, steps=2,
                         ckpt_dir=job["write"], **common)
        self._keep("ckpt/written", res)
        res = ttrain.run(cfg, self._dense(arch), source, steps=2,
                         ckpt_dir=job["read"], **common)
        self._keep("ckpt/restored", res)
        self.out["ckpt/restored/start"] = np.int64(res.start_step)
        res = ttrain.run(cfg, self._dense(arch), source, steps=3,
                         ckpt_dir=job["read"], **common)
        self.out["ckpt/resumed/losses"] = np.asarray(res.losses)

    def sigterm(self, job):
        """A SIGTERM to the last rank after step 1 of 4."""
        mesh = self.mesh()
        arch = job["arch"]
        cfg = get_config(arch, smoke=True)
        source = make_source(cfg.vocab_size, 16, 4, seed=0)

        def hook(step):
            if step == 1 and self.rank == self.world - 1:
                os.kill(os.getpid(), signal.SIGTERM)
        res = ttrain.run(cfg, self._dense(arch), source, steps=4,
                         mode="dense", eval_before=False, mesh=mesh,
                         ckpt_dir=job["dir"], step_hook=hook,
                         log=lambda m: None)
        self.out["sigterm/preempted"] = np.bool_(res.preempted)
        self.out["sigterm/steps"] = np.int64(len(res.losses))


def _whole_cache(mesh, cfg, cache: dict, t: torch.Tensor,
                 batch: int) -> torch.Tensor:
    """A rank's (L, B, T, H, D) cache leaf ``t`` of ``cache`` gathered
    whole: its heads over 'model', its rows over their axis, its batch
    rows over the data axes."""
    if t.shape[-2] < cfg.num_kv_heads:
        t = C.all_gather_along(t, -2, mesh.group("model"))
    if "rows" in cache:
        t = C.all_gather_along(t, -3, mesh.group(cache["rows"][0]))
    if t.shape[-4] < batch:
        t = C.all_gather_along(t, -4, mesh.group(("data",)))
    return t


def trace_counts(fig: dict) -> dict:
    """A trace's work counts as arrays: flops and dots, and each kind's
    collective bytes and calls."""
    out = {"flops": np.float64(fig["flops_dot"]),
           "dots": np.int64(fig["dot_count"])}
    for k, v in fig["collective_bytes"].items():
        out[f"bytes/{k}"] = np.float64(v)
        out[f"calls/{k}"] = np.int64(fig["collective_counts_dynamic"][k])
    return out


def _nest(flat: dict) -> dict:
    """``{"a/b": t}`` -> ``{"a": {"b": t}}``; digit keys make lists."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


def main(spec_path: str, rank: int) -> int:
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    r = Rank(spec, rank)
    try:
        for job in spec["jobs"]:
            getattr(r, job["kind"])(job)
        np.savez(os.path.join(spec["dir"], f"rank{rank}.npz"), **r.out)
    finally:
        D.shutdown_world()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
