"""The rank side of ``tests/test_torch_dist.py``: one process of a world
of CPU ranks over gloo. It imports torch and the port only, so that a
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

import dataclasses
import datetime
import json
import os
import signal
import sys

import numpy as np
import torch

from repro_torch import distributed as D
from repro_torch.configs import get_config
from repro_torch.data import make_source
from repro_torch.launch import train as ttrain
from repro_torch.models import common as cm
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tfm
from repro_torch.optim import compression as TC

TIMEOUT = datetime.timedelta(seconds=30)


def variant(arch: str, name: str):
    """The smoke config of ``arch`` at the test's capacity: ``default``,
    or ``nodrop`` (every pair kept: capacity factor E), ``nodrop_aux0``
    (and no aux loss: the per-slice aux is the EP path's own function,
    which the global path does not compute)."""
    cfg = get_config(arch, smoke=True)
    if name == "default":
        return cfg
    moe = dataclasses.replace(cfg.moe,
                              capacity_factor=float(cfg.moe.num_experts))
    if name == "nodrop_aux0":
        moe = dataclasses.replace(moe, router_aux_weight=0.0)
    return dataclasses.replace(cfg, moe=moe)


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

    def mesh(self):
        if not D.in_world():
            D.init_world("gloo", device="cpu", rank=self.rank,
                         world_size=self.world, timeout=TIMEOUT,
                         init_method=f"tcp://127.0.0.1:{self.spec['port']}")
            self._mesh = D.elastic_remesh(self.shape, ("data", "model"))
        return self._mesh

    # ----------------------------------------------------------- jobs

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
