"""The port's dry run (``launch/dryrun.py`` and the rest of
``launch/specs.py``) against the JAX package's, on the CPU.

* Spec trees at full size, every arch: ``model_param_specs`` in every mode
  (leaf paths, shapes, dtypes, logical axes; ``param_count``),
  ``optimizer_specs``, and ``input_specs`` of every assigned shape, equal
  to the reference's.
* ``model_flops`` of every assigned cell, and the shard shapes of
  ``input_shardings``, ``param_shardings(fsdp=False/True)`` and
  ``cache_shardings`` on both production meshes, equal to the reference's
  ``NamedSharding.shard_shape``: one subprocess with 512 forced host
  devices computes the reference's (nothing is compiled), as
  ``tests/test_system.py`` runs the reference's dry run.
* FLOPs at smoke size on one device, against ``hlo_analysis.analyze`` of
  the reference's compiled step: prefill and decode within 1%, the dense
  train step within 5% (all three come out equal). The flexrank train
  step runs other products than the reference's in two places: the
  low-rank backward (``kernels/ops.py:_LowRank``: five products over the
  kept columns where XLA's gradient of the masked branch runs four over
  every column) and the recompute of each layer's last factorized
  product, which XLA drops as dead; it is held exactly with both put
  back in the reference's terms, at every budget row.
* ``run_cell`` end to end at smoke widths for an arch of each family
  (dense, MoE, MLA, recurrent, audio, vision) in each shape kind, on a
  fake (2, 2) mesh; every cell's experts cut E / n_model, at decode
  too; ``fsdp`` moves ``placed`` only; a full-size config built on
  ``meta`` without a draw.
* The rank's decode cache at full size on ``meta`` for every decode cell
  of the eight attention stacks on both production meshes, and at a
  batch of one: ``shard_shape`` of ``cache_shardings``, nothing held
  whole; the merge's maximum counted as an all-reduce.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import ShapeConfig as JShape
from repro.launch import hlo_analysis
from repro.launch import specs as JSP
from repro.models import common as jcm
from repro.optim import adamw as jadamw
from repro_torch import distributed as D
from repro_torch.configs import ASSIGNED_ARCHS, get_config, list_archs, \
    shapes_for
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as DR
from repro_torch.launch import specs as SP
from repro_torch.launch import trace_analysis as TA
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm

HERE = Path(__file__).resolve().parent
SRC = str(HERE.parent / "src")
MODES = ["dense", "flexrank", "flexrank_kd", "flexrank_sliced", "gar"]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _dtype(d) -> str:
    return str(d).replace("torch.", "") if isinstance(d, torch.dtype) \
        else np.dtype(d).name


def _jpath(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _jleaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=jcm.is_spec)
    return {_jpath(p): (tuple(s.shape), _dtype(s.dtype), tuple(s.axes))
            for p, s in flat}


def _tleaves(tree):
    return {p: (tuple(s.shape), _dtype(s.dtype), tuple(s.axes))
            for p, s in cm.tree_items(tree, is_leaf=cm.is_spec)}


# ------------------------------------------------------------ spec trees

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_reference(arch, mode):
    t, taxes = SP.model_param_specs(get_config(arch), mode=mode)
    j, _ = JSP.model_param_specs(jget(arch), mode=mode)
    assert _tleaves(t) == _jleaves(j)
    assert cm.param_count(t) == jcm.param_count(j)
    assert taxes == cm.axes_tree(t)


@pytest.mark.parametrize("arch", list_archs())
def test_optimizer_and_input_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    t = SP.optimizer_specs(SP.model_param_specs(cfg)[0])
    j = JSP.optimizer_specs(JSP.model_param_specs(jcfg)[0])
    assert _tleaves(t.mu) == _jleaves(j.mu)
    assert _tleaves(t.nu) == _jleaves(j.nu)
    assert _tleaves(t.step) == _jleaves(j.step)
    for s in shapes_for(arch):
        ti = SP.input_specs(cfg, s)
        ji = JSP.input_specs(jcfg, JShape(s.name, s.seq_len,
                                          s.global_batch, s.kind))
        assert sorted(ti) == sorted(ji)
        for k in ti:
            assert ti[k].device.type == "meta"
            assert (tuple(ti[k].shape), _dtype(ti[k].dtype)) == \
                (tuple(ji[k].shape), _dtype(ji[k].dtype)), (s.name, k)


# ------------------------------------------- model_flops and placements

_REFERENCE = textwrap.dedent("""
    import json, sys
    import jax
    from repro.launch import dryrun as DR          # forces 512 devices
    from repro.configs import ASSIGNED_ARCHS, get_config, shapes_for
    from repro.launch import specs as SP
    from repro.distributed.sharding import param_shardings
    MESHES = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}

    def path(p):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in p)

    def shards(tree, shardings):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        sh = jax.tree_util.tree_leaves(shardings)
        return {path(p): list(s.shard_shape(tuple(x.shape)))
                for (p, x), s in zip(flat, sh)}

    out = {"flops": {}, "placed": {}}
    for mname, (shape, axes) in MESHES.items():
        mesh = jax.make_mesh(shape, axes)
        for arch in ASSIGNED_ARCHS:
            cfg = get_config(arch)
            rec = out["placed"][f"{mname}/{arch}"] = {}
            pspecs, paxes = SP.model_param_specs(cfg, mode="dense")
            shapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
                s.shape, s.dtype), pspecs, is_leaf=lambda x: hasattr(
                    x, "axes"))
            for fsdp in (False, True):
                rec[f"params/{fsdp}"] = shards(shapes, param_shardings(
                    mesh, paxes, pspecs, fsdp=fsdp))
            for s in shapes_for(arch):
                out["flops"][f"{arch}/{s.name}"] = DR.model_flops(cfg, s)
                ins = SP.input_specs(cfg, s)
                rec[f"inputs/{s.name}"] = shards(
                    ins, SP.input_shardings(mesh, cfg, s))
                if s.kind == "decode":
                    c = SP.cache_specs(cfg, s)
                    rec[f"cache/{s.name}"] = shards(
                        c, SP.cache_shardings(mesh, cfg, s, c))
    json.dump(out, open(sys.argv[1], "w"))
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    dst = tmp_path_factory.mktemp("dryrun_ref") / "ref.json"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _REFERENCE, str(dst)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(dst.read_text())


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_flops_match_reference(reference, arch):
    cfg = get_config(arch)
    for s in shapes_for(arch):
        assert DR.model_flops(cfg, s) == reference["flops"][f"{arch}/{s.name}"]


def _shards(mesh, tree, placements, is_leaf=None):
    pls = dict(cm.tree_items(placements, is_leaf=D.sharding.is_placement))
    return {p: list(SP.shard_shape(mesh, pls[p], x.shape))
            for p, x in cm.tree_items(tree, is_leaf=is_leaf)
            if hasattr(x, "shape")}


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
@pytest.mark.parametrize("mname", list(MESHES))
def test_placements_match_reference(reference, mname, arch):
    """Every leaf's shard shape, the kv-heads fallback (the cache's
    sequence on 'model') and the batch-1 sequence on 'data' included;
    the reference's ``pos`` and ``idx`` arrays are the port's host
    ints."""
    shape, axes = MESHES[mname]
    mesh = DR.make_mesh(shape, axes, devices=["cpu"] * math.prod(shape))
    cfg = get_config(arch)
    ref = reference["placed"][f"{mname}/{arch}"]
    pspecs, paxes = SP.model_param_specs(cfg)
    for fsdp in (False, True):
        got = _shards(mesh, pspecs, D.param_shardings(
            mesh, paxes, pspecs, fsdp=fsdp), is_leaf=cm.is_spec)
        assert got == ref[f"params/{fsdp}"], fsdp
    for s in shapes_for(arch):
        ins = SP.input_specs(cfg, s)
        assert _shards(mesh, ins, SP.input_shardings(mesh, cfg, s)) == \
            ref[f"inputs/{s.name}"], s.name
        if s.kind == "decode":
            c = SP.cache_specs(cfg, s)
            got = _shards(mesh, c, SP.cache_shardings(mesh, cfg, s, c))
            want = ref[f"cache/{s.name}"]
            extra = {p for p in want if p not in got}
            assert all(p == "pos" or p.endswith("/idx") for p in extra)
            assert got == {p: v for p, v in want.items() if p in got}


# ------------------------------------------- FLOPs against the reference

FLOPS_ARCH = "deepseek-7b"
CELLS = {"train": ShapeConfig("t", 32, 4, "train"),
         "prefill": ShapeConfig("p", 64, 2, "prefill"),
         "decode": ShapeConfig("d", 64, 2, "decode")}


def _one_device():
    return DR.make_mesh((1, 1), ("data", "model"), devices=["cpu"])


def _reference_flops(mode: str, shape: ShapeConfig) -> float:
    jcfg = jget(FLOPS_ARCH, smoke=True)
    js = JShape(shape.name, shape.seq_len, shape.global_batch, shape.kind)
    pspecs, _ = JSP.model_param_specs(jcfg, mode=mode)
    ps = jcm.shape_tree(pspecs, dtype=jnp.float32)
    ins = JSP.input_specs(jcfg, js)
    if shape.kind == "train":
        step = JSP.make_train_step(jcfg, jadamw.AdamWConfig(), mode=mode)
        lowered = jax.jit(step).lower(
            ps, jcm.shape_tree(JSP.optimizer_specs(pspecs)), ins,
            jax.ShapeDtypeStruct((2,), jnp.uint32))
    elif shape.kind == "prefill":
        lowered = jax.jit(JSP.make_prefill_step(jcfg)).lower(ps, ins)
    else:
        lowered = jax.jit(JSP.make_decode_step(jcfg)).lower(
            ps, JSP.cache_specs(jcfg, js), ins)
    return hlo_analysis.analyze(lowered.compile().as_text())["flops_dot"]


def _port_trace(mode: str, shape: ShapeConfig, seed: int = 0):
    mesh = _one_device()
    step, args, facts = DR.build_step(get_config(FLOPS_ARCH, smoke=True),
                                      shape, mesh, mode,
                                      dtype=torch.float32, seed=seed)
    with D.mesh_context(mesh):
        _, fig = TA.trace(step, *args)
    return fig, facts


def _breakdown(mode, shape) -> str:
    """Per-op FLOPs of the port's step, for a failure's message."""
    counts = {}

    class Ops(TA.StepTrace):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            f0 = self.flops
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if self.flops != f0:
                counts[str(func)] = counts.get(str(func), 0) + self.flops - f0
            return out
    mesh = _one_device()
    step, args, _ = DR.build_step(get_config(FLOPS_ARCH, smoke=True), shape,
                                  mesh, mode, dtype=torch.float32)
    with D.mesh_context(mesh), Ops(memory=False):
        step(*args)
    return json.dumps(counts)


@pytest.mark.parametrize("kind,tol", [("prefill", 0.01), ("decode", 0.01),
                                      ("train", 0.05)])
def test_flops_match_reference(kind, tol):
    fig, _ = _port_trace("dense", CELLS[kind])
    want = _reference_flops("dense", CELLS[kind])
    assert fig["flops_dot"] == pytest.approx(want, rel=tol), \
        _breakdown("dense", CELLS[kind])


@pytest.mark.parametrize("seed", [7, 0, 1, 3, 2, 8, 18],
                         ids=[f"row{k}" for k in range(7)])
def test_flexrank_train_flops_match_reference(monkeypatch, seed):
    """The flexrank step at budget row ``k`` (the seed's draw): with each
    low-rank call's backward (T tokens, n in, m out, r columns, kr kept)
    counted as the reference runs it, ``2 T r (2m + 2n)``, in place of the
    port's ``2 T kr (2m + 3n)``, the count is the reference's."""
    calls = []
    plain_fwd, plain_bwd = ops._LowRank.forward, ops._LowRank.backward

    def forward(ctx, x, v, u, rank):
        ctx.dims = (x.shape[0], v.shape[0], u.shape[0], v.shape[1])
        return plain_fwd(ctx, x, v, u, rank)

    def backward(ctx, dy):
        calls.append(ctx.dims + (ctx.kr,))
        return plain_bwd(ctx, dy)
    monkeypatch.setattr(ops._LowRank, "forward", staticmethod(forward))
    monkeypatch.setattr(ops._LowRank, "backward", staticmethod(backward))
    fig, facts = _port_trace("flexrank", CELLS["train"], seed=seed)
    assert facts["budget_k"] == [7, 0, 1, 3, 2, 8, 18].index(seed)
    assert calls
    as_reference = fig["flops_dot"] + sum(
        2 * t * (r * (2 * m + 2 * n) - kr * (2 * m + 3 * n))
        for t, n, m, r, kr in calls)
    # the recompute of each layer's last product (mlp/down's z @ u^T),
    # whose value the backward never reads: XLA drops it as dead, and
    # torch's checkpoint stops early at op boundaries, not inside a
    # Function's forward
    cfg = get_config(FLOPS_ARCH, smoke=True)
    down = [(t, r, m) for t, n, m, r, kr in calls
            if (n, m) == (cfg.d_ff, cfg.d_model)]
    assert len(down) == cfg.num_layers
    as_reference -= sum(2 * t * r * m for t, r, m in down)
    assert as_reference == _reference_flops("flexrank", CELLS["train"])


# ------------------------------------------------------------ run_cell

FAMILIES = ["deepseek-7b", "deepseek-moe-16b", "minicpm3-4b", "zamba2-7b",
            "seamless-m4t-medium", "llama-3.2-vision-11b"]
SMALL = {"train_4k": ShapeConfig("train_4k", 64, 8, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 128, 4, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 128, 8, "decode")}

RECORD_KEYS = ("arch", "shape", "mode", "mesh", "chips", "lower_s",
               "compile_s", "bytes_per_device", "xla_raw",
               "hlo_flops_per_device", "collective_bytes_per_device",
               "collectives", "collective_counts",
               "collective_counts_dynamic", "hlo_bytes_per_device",
               "memory_traffic", "t_compute", "t_memory", "t_collective",
               "bottleneck", "model_flops_total", "useful_flops_ratio",
               "status", "total_s")


@pytest.fixture
def smoke_cells(monkeypatch):
    monkeypatch.setattr(DR, "get_config",
                        lambda a: get_config(a, smoke=True))
    monkeypatch.setattr(DR, "shapes_for", lambda a: list(SMALL.values()))
    yield
    D.shutdown_world()


@pytest.mark.parametrize("shape", list(SMALL))
@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_end_to_end(smoke_cells, tmp_path, arch, shape):
    rec = DR.run_cell(arch, shape, multi_pod=False, mode="dense",
                      out_dir=str(tmp_path), mesh_override=(2, 2))
    assert rec["status"] == "ok", rec.get("traceback")
    for k in RECORD_KEYS:
        assert k in rec, k
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["hlo_flops_per_device"] > 0 and rec["mesh"] == "2x2"
    b = rec["bytes_per_device"]
    assert b["peak"] == b["argument"] + b["temp"] > b["argument"] > 0
    assert rec["placed"]["bytes_per_device"]["total"] > 0
    assert rec["executes"] == DR.EXECUTES
    on_disk = json.loads((tmp_path / f"{arch}__{shape}__2x2__dense.json")
                         .read_text())
    assert on_disk["status"] == "ok"
    if shape == "train_4k":
        assert rec["collectives"]["all-reduce"] > 0


def test_decode_cuts_experts(smoke_cells):
    """A decode step with a cache runs ``moe_apply`` over the rank's
    experts, E / n_model as the reference places them, as train and
    prefill (``moe_apply_ep``) do; its step exchanges no tokens (no
    all-to-all; its all-reduces are the tensor-parallel heads', the
    vocabulary's and the routed output's)."""
    cfg = get_config("deepseek-moe-16b", smoke=True)
    e = cfg.moe.num_experts
    DR.fake_world(4)
    mesh = DR.make_mesh((2, 2), ("data", "model"))
    for name in ("decode_32k", "prefill_32k", "train_4k"):
        _, args, _ = DR.build_step(cfg, SMALL[name], mesh, "dense")
        experts = [t for p, t in cm.tree_items(args[0])
                   if "/experts/" in p]
        assert experts and all(t.shape[1] == e // 2 for t in experts), name
    fig, _, _ = DR.trace_cell(cfg, SMALL["decode_32k"], mesh, "dense")
    assert fig["collective_bytes"]["all-to-all"] == 0
    assert fig["collective_bytes_total"] == fig["collective_bytes"][
        "all-reduce"] + fig["collective_bytes"]["all-gather"] > 0


ATTENTION_STACKS = ["deepseek-7b", "deepseek-moe-16b", "gemma3-27b",
                    "gpt2-small", "llama-3.2-vision-11b",
                    "llama4-scout-17b-a16e", "seamless-m4t-medium",
                    "stablelm-1.6b"]


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ATTENTION_STACKS)
def test_decode_cache_as_placed(arch, multi):
    """Every decode cell of the attention stacks at full size on
    ``meta``, and the same at a batch of one: the rank's cache
    (``cache_specs(mesh=)``) has the shape ``shard_shape`` gives under
    ``cache_shardings``, a cut sequence carries its axis and first row,
    and the rank holds no leaf and no cache entry whole, dense or in the
    GAR form."""
    try:
        for shape in (s for s in shapes_for(arch) if s.kind == "decode"):
            for b in (shape.global_batch, 1):
                cfg, cell, mesh = DR.build_cell(arch, shape.name, multi,
                                                "dense")
                cell = dataclasses.replace(cell, global_batch=b)
                whole = SP.cache_specs(cfg, cell)
                pls = dict(cm.tree_items(
                    SP.cache_shardings(mesh, cfg, cell, whole),
                    is_leaf=D.sharding.is_placement))
                mine = dict(cm.tree_items(SP.cache_specs(cfg, cell,
                                                         mesh=mesh)))
                for path, t in cm.tree_items(whole):
                    if not isinstance(t, torch.Tensor):
                        continue
                    want = SP.shard_shape(mesh, pls[path], t.shape)
                    assert tuple(mine[path].shape) == want, (path, b)
                    if not path.endswith(("/k", "/v")):
                        continue
                    seq = pls[path][-3]
                    rows = path.rsplit("/", 1)[0] + "/rows/1"
                    if seq is not None and mesh.size(seq) > 1:
                        assert mine[rows] == mesh.index(seq) * want[-3]
                    else:
                        assert rows not in mine, (path, b)
                for mode in ("dense", "gar"):
                    assert DR.whole_on_rank(cfg, cell, mesh, mode) == {
                        "leaves": {}, "cache": {}}, (b, mode)
    finally:
        D.shutdown_world()


def test_merge_all_reduces_are_counted():
    """The merge's maximum over the ranks is an all-reduce in the trace's
    counts, beside its sums (a llama4 decode cell cuts its sequence over
    'model')."""
    cfg = get_config("llama4-scout-17b-a16e", smoke=True)
    try:
        DR.fake_world(4)
        mesh = DR.make_mesh((1, 4), ("data", "model"))
        x = torch.zeros((2, 3), device="meta")
        with D.mesh_context(mesh):
            _, fig = TA.trace(lambda: [
                D.collectives.all_reduce(x, mesh.group("model"), op)
                for op in ("max", "sum")])
        assert fig["collective_bytes"]["all-reduce"] == 2 * 2 * 3 * 4
        assert fig["collective_counts_dynamic"]["all-reduce"] == 2
        shape = dataclasses.replace(SMALL["decode_32k"], global_batch=2)
        state = SP.cache_specs(cfg, shape, mesh=mesh)
        assert state["segments"][0]["rows"] == ("model", 0)
    finally:
        D.shutdown_world()


def test_fsdp_moves_placed_only(smoke_cells):
    cfg = get_config("deepseek-7b", smoke=True)
    DR.fake_world(4)
    mesh = DR.make_mesh((2, 2), ("data", "model"))
    a = DR.trace_cell(cfg, SMALL["train_4k"], mesh, "dense", fsdp=False)
    b = DR.trace_cell(cfg, SMALL["train_4k"], mesh, "dense", fsdp=True)
    assert a[0] == b[0]
    pa, pb = (x[1]["bytes_per_device"] for x in (a, b))
    assert pb["params"] < pa["params"] and pb["optimizer"] < pa["optimizer"]
    assert pb["inputs"] == pa["inputs"]


def test_meta_build_draws_nothing():
    """llama4-scout-17b-a16e's 107 B parameters on ``meta`` in seconds,
    the generator untouched."""
    cfg = get_config("llama4-scout-17b-a16e")
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state().clone()
    t0 = time.perf_counter()
    params = cm.instantiate(tfm.model_spec(cfg), gen, device="meta",
                            dtype=torch.bfloat16)
    assert time.perf_counter() - t0 < 5.0
    assert torch.equal(gen.get_state(), state)
    leaves = cm.tree_leaves(params)
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for t in leaves)
    assert sum(t.numel() for t in leaves) == cm.param_count(
        tfm.model_spec(cfg)) > 100e9
