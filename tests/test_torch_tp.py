"""Tensor parallelism over 'model' (``models/tp.py``,
``distributed/sharding.py:rank_dims``) across CPU ranks over gloo,
against the whole program on one rank and the reference's partitioned
step on forced host devices.

* ``model_dims`` of every leaf of the 11 configs' specs (full size, dense
  and factorized) at (1, 2), (2, 2) and (16, 16): the dimension the
  reference's ``param_shardings`` places on 'model'.
* In one pool of four rank processes (``tests/torch_dist_ranks.py``;
  meshes (2, 2), (1, 4), and (1, 2) on each pair of ranks): the column-,
  row- and rank-parallel ``linear``, dense and factorized, at two ranks of
  the nested mask (forward, input and leaf gradients); the vocabulary-
  parallel cross-entropy and consolidation loss (a vocabulary that
  divides and one that does not); gemma3's attention at (1, 4), where
  its 2 kv heads are cut inside a head, and a prefill and a decode step
  over its cache; ``make_train_step``'s step at (1, 2) and (2, 2) for
  gpt2-small (dense, flexrank, flexrank_kd), gemma3-27b, deepseek-moe-16b
  (no drop, no aux) and llama-3.2-vision-11b (with its frontend), with
  the prefill and decode steps after the dense ones. The launcher at
  (1, 2) is ``tests/test_torch_tp_launcher.py``'s.
* In the same pool, the decode cells: a prompt through ``prefill`` into
  each rank's part of the cache (``specs.cache_specs(mesh=)``) and decode
  steps after it, the sequence cut over 'model' at (1, 4) (gemma3 with a
  window of 5, in float32 and bfloat16; llama4, one expert a rank) and
  over 'data' at (2, 2) for a batch of one (deepseek-moe, 4 experts a
  rank); and ``moe_apply`` over each rank's experts with its gradients.
* The reference's step jitted with ``param_shardings`` as its
  ``in_shardings`` on meshes (1, 2) and (2, 2) of forced host devices, in
  two subprocesses while the pool runs, and its prefill and
  ``make_decode_step`` with ``cache_shardings`` too.
* Each rank's bytes of parameters and AdamW moments, and at decode of
  parameters and cache: ``placed(fsdp=False)``'s. A leaf cut over
  'model' that the rank program runs whole raises.

Tolerances, float32 throughout: against the one-rank port (the same
products, summed in another order across ranks) 1e-5 of each result's
largest entry for the products and losses, 1e-4 for gradients and AdamW's
first moment (the clipped gradient); against the reference's partitioned
step 1e-4 relative on the loss and 2e-3 of each leaf's largest entry on
the first moment (two libraries' float32 products and reductions, as
``tests/test_torch_train_modes.py`` holds the one-device steps), and
the updated parameters within 2e-3 of each leaf's largest entry. The
decode logits: 1e-5 of their max against one rank, 1e-4 against the
reference (a bfloat16 cache: ``check_bf16_parity`` at those tolerances).
"""
import json
import subprocess
import sys
import textwrap
import time
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.distributed import sharding as jshard
from repro_torch import distributed as D
from repro_torch import threefry
from repro_torch.configs import ShapeConfig, get_config, list_archs
from repro_torch.core import flexrank as TFR
from repro_torch.launch import dryrun as DR
from repro_torch.launch import specs as SP
from repro_torch.models import attention as tattn
from repro_torch.models import common as cm
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw as tadamw

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import torch_dist_ranks as ranks  # noqa: E402
from test_torch_bf16_ties import check_bf16_parity  # noqa: E402
from test_torch_dist import _env, run_pool  # noqa: E402

DEADLINE = 240
B, S, TF = 4, 16, 17            # batch rows, tokens, vision frames
STEP_CASES = [("gpt2-small", "default", "dense"),
              ("gpt2-small", "default", "flexrank"),
              ("gpt2-small", "default", "flexrank_kd"),
              ("gemma3-27b", "default", "dense"),
              ("deepseek-moe-16b", "nodrop_aux0", "dense"),
              ("llama-3.2-vision-11b", "default", "dense")]
STEP_MESHES = ["1x2", "2x2"]
LINEAR = [  # name, whole (d_in, d_out[, rank]), leaf shapes, dims, x cut
    ("col_dense", (8, 12), {"w": (8, 12)}, {"w": 1}, False, [None]),
    ("row_dense", (12, 8), {"w": (12, 8)}, {"w": 0}, True, [None]),
    ("row_dense_whole_x", (12, 8), {"w": (12, 8)}, {"w": 0}, False, [None]),
    ("col_fact", (8, 12), {"v": (8, 6), "u": (12, 6)}, {"v": 1, "u": 0},
     False, [None, 4]),
    ("row_fact", (12, 8), {"v": (12, 6), "u": (8, 6)}, {"v": 0, "u": 1},
     True, [None, 3]),
    ("rank_fact", (10, 8, 6), {"v": (10, 6), "u": (8, 6)},
     {"v": 1, "u": 1}, False, [None, 4, 1]),
    ("gathered_whole_out", (8, 9), {"v": (8, 6), "u": (9, 6)},
     {"v": 1, "u": None}, False, [None, 4]),
]
VOCABS = [12, 11]               # over 2 ranks: cut, and held whole
ATTN_ARCH, ATTN_WINDOW = "gemma3-27b", 5
# the decode cells: name, arch, variant, mesh, batch, cache dtype, prompt,
# decode steps, cache length
DECODE_CASES = [
    # 2 kv heads on 4 ranks: the sequence over 'model', 8 rows a rank; the
    # prompt straddles the edges at 8 and 16, a window of 5 crosses them
    ("gemma3_w5", "gemma3-27b", "w5", "1x4", 2, "float32", 20, 4, 32),
    ("gemma3_w5_bf16", "gemma3-27b", "w5", "1x4", 2, "bfloat16", 20, 4,
     32),
    # the same cut, and one of 4 experts a rank
    ("llama4", "llama4-scout-17b-a16e", "default", "1x4", 2, "float32", 20,
     4, 32),
    # a batch of one: the sequence over 'data' (the prompt on data rank 0
    # and 1, the steps on 1), heads and 4 of 8 experts a rank over 'model'
    ("deepseek_b1", "deepseek-moe-16b", "nodrop_aux0", "2x2", 1, "float32",
     20, 4, 32),
]
DECODE_IDS = [c[0] for c in DECODE_CASES]
# moe_apply_ep's fallback over a rank's experts: 3 tokens do not divide 2
MOE_PART = [("deepseek-moe-16b", "nodrop"), ("llama4-scout-17b-a16e",
                                             "default")]


# ------------------------------------------------------------ placements

def _jax_model_dims(shape, axes, shapes):
    """The dimension the reference's ``param_shardings`` places on
    'model', leaf by leaf, on a mesh of ``shape`` (its sizes only: the
    placement is arithmetic on them)."""
    mesh = types.SimpleNamespace(shape=dict(zip(("data", "model"), shape)),
                                 axis_names=("data", "model"))
    real = jshard.NamedSharding
    jshard.NamedSharding = lambda m, p: p
    try:
        specs = jshard.param_shardings(mesh, axes, shapes)
    finally:
        jshard.NamedSharding = real
    out = []
    for spec in jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec)):
        hit = [i for i, e in enumerate(spec) if e == "model"]
        out.append(hit[0] if hit else None)
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_model_dims_match_param_shardings(arch):
    """Every leaf of the dense and factorized specs at full size, at (1, 2),
    (2, 2) and (16, 16)."""
    cfg = get_config(arch)
    for spec in (tfm.model_spec(cfg), TFR.factorized_spec(cfg)):
        axes = cm.axes_tree(spec)
        shapes = cm.tree_map(lambda s: tuple(s.shape), spec,
                             is_leaf=cm.is_spec)
        for shape in ((1, 2), (2, 2), (16, 16)):
            mesh = D.Mesh(D.device_array(["meta"] * int(np.prod(shape)),
                                         shape), ("data", "model"))
            got = D.sharding.dim_leaves(D.model_dims(mesh, axes, spec))
            want = _jax_model_dims(shape, axes, shapes)
            assert got == want, (arch, shape)


# ------------------------------------------------------------ inputs

def _draw(rng, shape):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)


def _tree(rng, spec):
    return {p: (_draw(rng, s.shape) if s.init == "normal" else
                0.1 * rng.standard_normal(s.shape).astype(np.float32))
            for p, s in cm.tree_items(spec, is_leaf=cm.is_spec)}


def _write_inputs(path: Path) -> dict:
    rng = np.random.default_rng(29)
    a = {}
    for name, whole, shapes, _, cut, _ in LINEAR:
        pre = f"tp/linear/{name}"
        for k, shp in shapes.items():
            a[f"{pre}/p/{k}"] = _draw(rng, shp)
        a[f"{pre}/x"] = rng.standard_normal((3, 5, whole[0])).astype(
            np.float32)
        a[f"{pre}/ct"] = rng.standard_normal((3, 5, whole[1])).astype(
            np.float32)
    for v in VOCABS:
        pre = f"tp/vocab/{v}"
        for k in ("s", "t"):
            a[f"{pre}/{k}"] = 3 * rng.standard_normal((3, 5, v)).astype(
                np.float32)
        a[f"{pre}/labels"] = rng.integers(0, v, (3, 5))
    cfg = get_config(ATTN_ARCH, smoke=True)
    for p, t in _tree(rng, tattn.attn_spec(cfg)).items():
        a[f"tp/attn/p/{p}"] = t
    a["tp/attn/x"] = rng.standard_normal((2, 8, cfg.d_model)).astype(
        np.float32)
    a["tp/attn/ct"] = rng.standard_normal((2, 8, cfg.d_model)).astype(
        np.float32)
    for arch, name, mode in STEP_CASES:
        cfg = ranks.variant(arch, name)
        pre = f"tp/step/{arch}/{mode}"
        for p, t in _tree(rng, SP.model_param_specs(cfg, mode=mode)[0]
                          ).items():
            a[f"{pre}/p/{p}"] = t
        if mode == "flexrank_kd":
            for p, t in _tree(rng, tfm.model_spec(cfg)).items():
                a[f"{pre}/t/{p}"] = t
        a[f"{pre}/tokens"] = rng.integers(0, cfg.vocab_size, (B, S + 1)
                                          ).astype(np.int32)
        if cfg.family == "vlm":
            a[f"{pre}/frontend"] = rng.standard_normal(
                (B, TF, cfg.frontend_dim)).astype(np.float32)
    for arch, var in MOE_PART:
        cfg = ranks.variant(arch, var)
        pre = f"tp/moe/{arch}/{var}"
        for p, t in _tree(rng, tmoe.moe_spec(cfg)).items():
            a[f"{pre}/p/{p}"] = t
        for k in ("x", "ct"):
            a[f"{pre}/{k}"] = rng.standard_normal((1, 3, cfg.d_model)
                                                  ).astype(np.float32)
    for name, arch, var, _, b, _, prompt, steps, _ in DECODE_CASES:
        cfg = ranks.variant(arch, var)
        pre = f"tp/decode/{name}"
        for p, t in _tree(rng, tfm.model_spec(cfg)).items():
            a[f"{pre}/p/{p}"] = t
        a[f"{pre}/tokens"] = rng.integers(
            0, cfg.vocab_size, (b, prompt + steps)).astype(np.int32)
    np.savez(path / "inputs.npz", **a)
    return a


def _case_tree(inputs, pre, spec):
    return ranks.tree_from(inputs, pre, spec)


# ------------------------------------------------------- the reference

REF_SCRIPT = textwrap.dedent('''
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.distributed.sharding import param_shardings
    from repro.distributed.meshctx import mesh_context
    from repro.launch import specs as SP
    from repro.launch.mesh import make_mesh
    from repro.models import common as cm
    from repro.optim import adamw

    d, mesh_key = sys.argv[1], sys.argv[2]
    cases = json.loads(sys.argv[3])
    decode_cases = json.loads(sys.argv[4])
    inp = np.load(os.path.join(d, "inputs.npz"))
    out = {}

    def variant(arch, name):
        cfg = get_config(arch, smoke=True)
        if name == "default":
            return cfg
        if name == "w5":
            return dataclasses.replace(cfg, local_window=5)
        m = dataclasses.replace(cfg.moe, capacity_factor=float(
            cfg.moe.num_experts), router_aux_weight=0.0)
        return dataclasses.replace(cfg, moe=m)

    def path_str(kp):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in kp)

    def tree(prefix, spec):
        leaves, tdef = jax.tree_util.tree_flatten_with_path(
            spec, is_leaf=cm.is_spec)
        return jax.tree_util.tree_unflatten(
            tdef, [jnp.asarray(inp[prefix + "/" + path_str(k)])
                   for k, _ in leaves])

    def put(prefix, t):
        for kp, a in jax.tree_util.tree_flatten_with_path(t)[0]:
            out[prefix + "/" + path_str(kp)] = np.asarray(a)

    shape = tuple(int(x) for x in mesh_key.split("x"))
    mesh = make_mesh(shape, ("data", "model"))
    for arch, name, mode in cases:
        cfg = variant(arch, name)
        pre = "tp/step/%s/%s" % (arch, mode)
        pspecs, paxes = SP.model_param_specs(cfg, mode=mode)
        params = tree(pre + "/p", pspecs)
        opt = adamw.init(params)
        batch = {k: jnp.asarray(inp[pre + "/" + k])
                 for k in ("tokens", "frontend") if pre + "/" + k in inp}
        with mesh_context(mesh):
            ospecs = SP.optimizer_specs(pspecs)
            pshard = param_shardings(mesh, paxes, pspecs)
            oshard = param_shardings(mesh, cm.axes_tree(ospecs), ospecs)
            shp = ShapeConfig("tp", batch["tokens"].shape[1] - 1,
                                 batch["tokens"].shape[0], "train")
            ishard = SP.input_shardings(mesh, cfg, shp)
            step = SP.make_train_step(cfg, adamw.AdamWConfig(), mode=mode)
            shards = [pshard, oshard, {k: ishard[k] for k in batch},
                      NamedSharding(mesh, P())]
            args = [params, opt, batch, jax.random.PRNGKey(3)]
            if mode == "flexrank_kd":
                tspecs, taxes = SP.model_param_specs(cfg, mode="dense")
                shards.append(param_shardings(mesh, taxes, tspecs))
                args.append(tree(pre + "/t", tspecs))
            p2, o2, m = jax.jit(step, in_shardings=tuple(shards))(*args)
        key = "ref/%s/%s/%s" % (mesh_key, arch, mode)
        out[key + "/loss"] = np.asarray(m["loss"])
        put(key + "/params", p2)
        put(key + "/mu", o2.mu)

    # the decode cells: prefill into the cache and the decode step, jitted
    # with the placements of the reference's decode cell; a bfloat16 cache
    # without them (there the partitioned program departs from the
    # one-device one: test_decode_over_placed_cache_matches_one_rank_and_
    # reference)
    from repro.models import transformer as tfm
    for name, arch, var, mkey, b, dt, prompt, steps, cache_len in \
            decode_cases:
        cfg = variant(arch, var)
        pre = "tp/decode/" + name
        mesh = make_mesh(tuple(int(x) for x in mkey.split("x")),
                         ("data", "model"))
        pspecs, paxes = SP.model_param_specs(cfg, mode="dense")
        params = tree(pre + "/p", pspecs)
        tokens = jnp.asarray(inp[pre + "/tokens"])
        shp = ShapeConfig("d", cache_len, b, "decode")
        placed = dt == "float32"
        with mesh_context(mesh if placed else None):
            state = tfm.init_decode_state(cfg, b, cache_len,
                                          dtype=getattr(jnp, dt))
            pre_fn = jax.jit(lambda p, st, t: tfm.prefill(p, cfg, st, t))
            dec = jax.jit(SP.make_decode_step(cfg))
            if placed:
                shards = (param_shardings(mesh, paxes, pspecs),
                          SP.cache_shardings(mesh, cfg, shp, state),
                          SP.input_shardings(mesh, cfg, shp)["tokens"])
                pre_fn = jax.jit(lambda p, st, t: tfm.prefill(p, cfg, st, t),
                                 in_shardings=shards)
                dec = jax.jit(SP.make_decode_step(cfg), in_shardings=(
                    shards[0], shards[1], {"tokens": shards[2]}))
            lg, state = pre_fn(params, state, tokens[:, :prompt])
            logits = [np.asarray(lg, np.float32)]
            for i in range(steps):
                lg, state = dec(params, state, {
                    "tokens": tokens[:, prompt + i:prompt + i + 1]})
                logits.append(np.asarray(lg, np.float32)[:, None])
        key = "ref/decode/" + name
        out[key + "/logits"] = np.concatenate(logits, 1)
        caches = [c for c in state["segments"] if c is not None]
        for j, c in enumerate(caches):
            for k in ("k", "v"):
                out["%s/cache/%d/%s" % (key, j, k)] = np.asarray(
                    c[k], np.float32)
    np.savez(os.path.join(d, "ref_%s.npz" % mesh_key), **out)
    print("REFOK")
''')


# ------------------------------------------------------------ the pool

def _jobs() -> list:
    lin = [{"name": n, "whole": list(w), "keys": list(shp), "dims": dims,
            "x_cut": cut, "ranks": rk}
           for n, w, shp, dims, cut, rk in LINEAR]
    return [
        {"kind": "tp_linear", "mesh": "1x2", "cases": lin},
        {"kind": "tp_vocab", "mesh": "1x2", "vocabs": VOCABS},
        {"kind": "tp_attn", "mesh": "1x4", "arch": ATTN_ARCH,
         "window": ATTN_WINDOW},
        *[{"kind": "tp_step", "mesh": m, "cases": STEP_CASES}
          for m in STEP_MESHES],
        *[{"kind": "tp_decode", "mesh": c[3], "case": list(c)}
          for c in DECODE_CASES],
        {"kind": "tp_moe_part", "mesh": "1x2",
         "cases": [list(c) for c in MOE_PART]},
    ]


def _ref_decode_cases(mesh_key) -> list:
    """The decode cells a reference subprocess runs: the (1, 4) ones in
    the (1, 2) process, the (2, 2) one in its own."""
    return [list(c) for c in DECODE_CASES
            if (c[3] == "2x2") == (mesh_key == "2x2")]


_STATE: dict = {}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The pool's results and the reference's, computed once."""
    tmp = tmp_path_factory.mktemp("tp")
    _STATE["tmp"] = tmp
    inputs = _write_inputs(tmp)
    refs = [subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(tmp), m,
         json.dumps(STEP_CASES), json.dumps(_ref_decode_cases(m))],
        env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for m in STEP_MESHES]
    end = time.monotonic() + DEADLINE
    try:
        pool = run_pool(tmp, (2, 2), _jobs(), end - time.monotonic())
        done = [r.communicate(timeout=max(end - time.monotonic(), 1.0))
                for r in refs]
    finally:
        for r in refs:
            if r.poll() is None:
                r.kill()
                r.wait(timeout=30)
    ref = {}
    for m, proc, (out, err) in zip(STEP_MESHES, refs, done):
        assert proc.returncode == 0 and "REFOK" in out, err[-3000:]
        ref.update(np.load(tmp / f"ref_{m}.npz"))
    return {"pool": pool, "ref": ref, "inputs": inputs, "tmp": tmp}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-12)


def _pairs(mesh_key):
    """The pool ranks that ran a mesh, as (data index, model index) ->
    rank: the (1, 2) pairs' first replica."""
    if mesh_key == "2x2":
        return {(0, 0): 0, (0, 1): 1, (1, 0): 2, (1, 1): 3}
    if mesh_key == "1x4":
        return {(0, m): m for m in range(4)}
    return {(0, 0): 0, (0, 1): 1}


# ------------------------------------------------------------ products

@pytest.mark.parametrize("case", LINEAR, ids=[c[0] for c in LINEAR])
def test_linear_parts_match_whole(world, case):
    """The layer on each rank's part against the whole layer at every
    nested rank: the whole output, the input's gradient (each rank's
    columns where its input is cut) and every leaf's (each rank's part)."""
    name, whole, shapes, dims, cut, rks = case
    inp, pool = world["inputs"], world["pool"]
    pre = f"tp/linear/{name}"
    for rank in rks:
        p = {k: torch.as_tensor(inp[f"{pre}/p/{k}"]).requires_grad_(True)
             for k in shapes}
        x = torch.as_tensor(inp[f"{pre}/x"]).requires_grad_(True)
        y = cm.linear(p, x, rank=rank)
        torch.sum(y * torch.as_tensor(inp[f"{pre}/ct"])).backward()
        for m in range(2):
            res = pool[m]
            key = f"{pre}/{rank}"
            assert _rel(res[f"{key}/y"], y.detach().numpy()) < 1e-5, rank
            gx = x.grad.numpy()
            if cut:
                gx = np.split(gx, 2, axis=-1)[m]
            assert _rel(res[f"{key}/gx"], gx) < 1e-4, rank
            for k, t in p.items():
                g = t.grad.numpy()
                if dims[k] is not None:
                    g = np.split(g, 2, axis=dims[k])[m]
                assert res[f"{key}/g/{k}"].shape == g.shape, k
                assert _rel(res[f"{key}/g/{k}"], g) < 1e-4, (rank, k)


@pytest.mark.parametrize("vocab", VOCABS)
def test_vocab_parallel_losses_match_whole(world, vocab):
    """Cross-entropy and the consolidation loss (kd weight 1 and 0.5, T 2)
    on each rank's vocabulary columns (whole where 11 does not divide 2)
    against the whole loss, and the logits' gradient."""
    inp, pool = world["inputs"], world["pool"]
    pre = f"tp/vocab/{vocab}"
    from repro_torch.core import distill
    labels = torch.as_tensor(inp[f"{pre}/labels"])
    t = torch.as_tensor(inp[f"{pre}/t"])
    for name in ("ce", "kd1", "kd05"):
        s = torch.as_tensor(inp[f"{pre}/s"]).requires_grad_(True)
        if name == "ce":
            loss = distill.cross_entropy(s, labels)
        else:
            loss = distill.consolidation_loss(
                s, t, labels, temperature=2.0,
                kd_weight=1.0 if name == "kd1" else 0.5)
        loss.backward()
        for res in pool[:2]:
            assert _rel(res[f"{pre}/{name}/loss"], loss.detach().numpy()) \
                < 1e-5, name
            assert _rel(res[f"{pre}/{name}/g"], s.grad.numpy()) < 1e-4, name


def test_attention_cut_inside_a_head_matches_whole(world):
    """gemma3's smoke attention (4 heads, 2 kv heads of 16) at (1, 4): one
    query head a rank, the kv columns cut inside a head and gathered; a
    window of 5. The output and every gradient against the whole layer;
    then a prefill and a decode step over a cache of every kv head (2
    do not divide 4) against the uncached output."""
    inp, pool = world["inputs"], world["pool"]
    cfg = get_config(ATTN_ARCH, smoke=True)
    spec = tattn.attn_spec(cfg)
    p = cm.tree_map(lambda t: t.requires_grad_(True),
                    ranks.tree_from(inp, "tp/attn/p", spec))
    x = torch.as_tensor(inp["tp/attn/x"]).requires_grad_(True)
    y, _ = tattn.attn_apply(p, x, cfg, positions=torch.arange(x.shape[1]),
                            window=ATTN_WINDOW)
    torch.sum(y * torch.as_tensor(inp["tp/attn/ct"])).backward()
    for res in pool:
        assert int(res["tp/attn/cache_heads"]) == cfg.num_kv_heads
        assert _rel(res["tp/attn/y"], y.detach().numpy()) < 1e-5
        assert _rel(res["tp/attn/cached"], y.detach().numpy()) < 1e-5
        assert _rel(res["tp/attn/gx"], x.grad.numpy()) < 1e-4
        for path, leaf in cm.tree_items(p):
            assert _rel(res[f"tp/attn/g/{path}"], leaf.grad.numpy()) \
                < 1e-4, path


# ------------------------------------------------------------ the step

def _one_rank_step(world, arch, name, mode):
    """The step on one rank, whole (no mesh): loss, gradients, the
    updated parameters and first moment, and for the dense modes the
    prefill and decode logits on the updated parameters."""
    key = ("one", arch, mode)
    if key in _STATE:
        return _STATE[key]
    inp = world["inputs"]
    cfg = ranks.variant(arch, name)
    pre = f"tp/step/{arch}/{mode}"
    pspecs, _ = SP.model_param_specs(cfg, mode=mode)
    params = cm.tree_map(lambda t: t.requires_grad_(True),
                         _case_tree(inp, f"{pre}/p", pspecs))
    teacher = None
    if mode == "flexrank_kd":
        teacher = _case_tree(inp, f"{pre}/t", tfm.model_spec(cfg))
    batch = {k: torch.as_tensor(inp[f"{pre}/{k}"])
             for k in ("tokens", "frontend") if f"{pre}/{k}" in inp}
    step = SP.make_train_step(cfg, tadamw.AdamWConfig(), mode=mode)
    rng = threefry.prng_key(3)
    with tfm.remat_blocks():
        step.loss_fn(params, batch, rng, teacher).backward()
    grads = {p: t.grad.clone() for p, t in cm.tree_items(params)}
    SP.clear_grads(params)
    params, opt, m = step(params, tadamw.init(params), batch, rng, teacher)
    out = {"loss": float(m["loss"]), "grads": grads,
           "params": dict(cm.tree_items(params)),
           "mu": dict(cm.tree_items(opt.mu))}
    if mode == "dense":
        with torch.no_grad():
            out["prefill"] = SP.make_prefill_step(cfg)(params, {
                k: v[:, :-1] if k == "tokens" else v
                for k, v in batch.items()})
            state = SP.cache_specs(cfg, ShapeConfig("tp", S + 1, B,
                                                    "decode"),
                                   dtype=torch.float32, device="cpu")
            if "frontend" in batch:
                tfm.attach_cross_kv(params, cfg, state, tfm.frontend_proj(
                    params, batch["frontend"], cfg))
            dec = SP.make_decode_step(cfg)
            logits = []
            for i in range(3):
                lg, state = dec(params, state,
                                {"tokens": batch["tokens"][:, i:i + 1]})
                logits.append(lg)
            out["decode"] = torch.stack(logits, 1)
    _STATE[key] = out
    return out


@pytest.mark.parametrize("mesh_key", STEP_MESHES)
@pytest.mark.parametrize("arch,name,mode", STEP_CASES,
                         ids=[f"{a}-{m}" for a, _, m in STEP_CASES])
def test_partitioned_step_matches_one_rank_and_reference(world, arch, name,
                                                         mode, mesh_key):
    """The step across ranks against one rank of the port (the loss, every
    leaf's first moment and updated parameters, whole) and against the
    reference's step jitted on the same mesh of forced devices with
    ``param_shardings`` as its ``in_shardings``; the prefill and decode
    logits after the dense steps against one rank's."""
    one = _one_rank_step(world, arch, name, mode)
    ref = world["ref"]
    rkey = f"ref/{mesh_key}/{arch}/{mode}"
    key = f"tp/step/{mesh_key}/{arch}/{mode}"
    pairs = _pairs(mesh_key)
    rows = B // (1 + max(d for d, _ in pairs))
    for (d, _), r in pairs.items():
        res = world["pool"][r]
        mine = slice(d * rows, (d + 1) * rows)
        loss = float(res[f"{key}/loss"])
        assert abs(loss - one["loss"]) <= 1e-5 * abs(one["loss"])
        assert abs(loss - float(ref[f"{rkey}/loss"])) <= \
            1e-4 * abs(one["loss"])
        for path, mu in one["mu"].items():
            got = res[f"{key}/mu/{path}"]
            assert _rel(got, mu.numpy()) < 1e-4, path
            assert np.abs(got - ref[f"{rkey}/mu/{path}"]).max() <= \
                2e-3 * np.abs(mu.numpy()).max() + 1e-12, path
        for path, p in one["params"].items():
            got = res[f"{key}/params/{path}"]
            assert _rel(got, p.detach().numpy()) < 1e-5, path
            assert _rel(ref[f"{rkey}/params/{path}"], p.detach().numpy()) \
                < 2e-3, path
        if mode == "dense":
            assert _rel(res[f"{key}/prefill"],
                        one["prefill"][mine].numpy()) < 1e-5
            assert _rel(res[f"{key}/decode"],
                        one["decode"][mine].numpy()) < 1e-5


@pytest.mark.parametrize("mesh_key", STEP_MESHES)
@pytest.mark.parametrize("arch,name,mode", STEP_CASES,
                         ids=[f"{a}-{m}" for a, _, m in STEP_CASES])
def test_whole_leaves_gradients_equal_on_model_ranks(world, arch, name, mode,
                                                     mesh_key):
    """The gradient of every leaf a rank holds whole is the same on every
    'model' rank of its data group, bit for bit, and their mean over the
    data ranks is the one-rank gradient."""
    one = _one_rank_step(world, arch, name, mode)
    pairs = _pairs(mesh_key)
    key = f"tp/step/{mesh_key}/{arch}/{mode}/g_whole/"
    nd = 1 + max(d for d, _ in pairs)
    paths = [k[len(key):] for k in world["pool"][0] if k.startswith(key)]
    assert paths
    for path in paths:
        per_data = []
        for d in range(nd):
            first = world["pool"][pairs[(d, 0)]][key + path]
            np.testing.assert_array_equal(
                world["pool"][pairs[(d, 1)]][key + path], first, path)
            per_data.append(first)
        assert _rel(np.mean(per_data, axis=0),
                    one["grads"][path].numpy()) < 1e-4, path


@pytest.mark.parametrize("mesh_key", STEP_MESHES)
@pytest.mark.parametrize("arch,name,mode", STEP_CASES,
                         ids=[f"{a}-{m}" for a, _, m in STEP_CASES])
def test_rank_holds_placed_bytes(world, arch, name, mode, mesh_key):
    """Each rank's bytes of parameters and of AdamW's moments: those of
    the dry run's ``placed(fsdp=False)`` for the cell on the mesh, its
    bfloat16 parameters at 2 bytes an entry against the rank's float32 at
    4 (``placed`` counts the reference's int32 step beside the moments;
    the port keeps it on the host)."""
    cfg = ranks.variant(arch, name)
    shape = tuple(int(x) for x in mesh_key.split("x"))
    mesh = D.Mesh(D.device_array(["cpu"] * int(np.prod(shape)), shape),
                  ("data", "model"))
    pspecs, paxes = SP.model_param_specs(cfg, mode=mode)
    want = DR.placed(cfg, ShapeConfig("tp", S, B, "train"), mesh, pspecs,
                     paxes, mode, fsdp=False)["bytes_per_device"]
    for r in _pairs(mesh_key).values():
        params, mu, nu = world["pool"][r][
            f"tp/step/{mesh_key}/{arch}/{mode}/bytes"]
        assert params == want["params"] * 4 // 2
        assert mu + nu + 4 == want["optimizer"]


# ------------------------------------------------------------ decode

def _one_rank_decode(world, case):
    """A decode cell's prompt and steps on one rank, whole (no mesh): the
    logits and each attention cache's k and v."""
    key = ("decode", case[0])
    if key in _STATE:
        return _STATE[key]
    name, arch, var, _, b, dt, prompt, steps, cache_len = case
    cfg = ranks.variant(arch, var)
    pre = f"tp/decode/{name}"
    params = _case_tree(world["inputs"], f"{pre}/p", tfm.model_spec(cfg))
    tokens = torch.as_tensor(world["inputs"][f"{pre}/tokens"])
    state = SP.cache_specs(cfg, ShapeConfig("d", cache_len, b, "decode"),
                           dtype=getattr(torch, dt), device="cpu")
    dec = SP.make_decode_step(cfg)
    with torch.no_grad():
        lg, state = tfm.prefill(params, cfg, state, tokens[:, :prompt])
        logits = [lg]
        for i in range(steps):
            lg, state = dec(params, state, {
                "tokens": tokens[:, prompt + i:prompt + i + 1]})
            logits.append(lg[:, None])
    caches = [c for c in state["segments"] if c is not None]
    out = {"logits": torch.cat(logits, 1).float().numpy(),
           "cache": lambda j, k: caches[j][k].float().numpy(),
           "segments": len(caches)}
    _STATE[key] = out
    return out


def _layers(get, segments: int) -> list:
    """Every attention layer's {'k', 'v'} (B, T, H, D), in the order the
    model runs them, of stacked caches ``get(segment, key)``."""
    return [{k: get(j, k)[l] for k in ("k", "v")} for j in range(segments)
            for l in range(get(j, "k").shape[0])]


@pytest.mark.parametrize("case", DECODE_CASES, ids=DECODE_IDS)
def test_decode_over_placed_cache_matches_one_rank_and_reference(world,
                                                                  case):
    """A prompt into this rank's part of the cache (``cache_specs(mesh=)``:
    its heads, or its rows of a sequence cut over 'model' or 'data') and
    the decode steps after it, each rank with its part of every leaf (the
    experts E / n_model): the logits and the caches gathered whole against
    one rank of the port within 1e-5 of their max and against the
    reference's prefill and ``make_decode_step`` jitted with
    ``param_shardings`` and ``cache_shardings`` as ``in_shardings``
    within 1e-4.

    A bfloat16 cache is held by ``check_bf16_parity`` at those
    tolerances, the rank's float32 values before each cache write's
    rounding recorded by ``Bf16Writes``: the runs agree up to the first
    differing cache element, which is a rounding tie of one ulp. Against
    the reference jitted without the placements: XLA's partitioned
    program of a float32 model over a bfloat16 cache departs from the
    reference's own one-device logits from the first token on (past
    ``TOL_BF16_TIE`` on this cell), and the port's row-parallel partial
    products of the attention's bfloat16 output summed in bfloat16 depart
    from that program as far, so the port sums them in float32 and rounds
    once, as one device does (``models/tp.py``)."""
    one = _one_rank_decode(world, case)
    name, dt = case[0], case[5]
    pre, rkey = f"tp/decode/{name}", f"ref/decode/{name}"
    ref = world["ref"]
    n = one["segments"]
    for r in _pairs(case[3]).values():
        res = world["pool"][r]
        got = res[f"{pre}/logits"]
        mine = _layers(lambda j, k: res[f"{pre}/cache/{j}/{k}"], n)
        if dt == "float32":
            assert _rel(got, one["logits"]) < 1e-5, r
            assert _rel(got, ref[f"{rkey}/logits"]) < 1e-4, r
            for a, c in zip(mine, _layers(one["cache"], n)):
                for k in ("k", "v"):
                    assert _rel(a[k], c[k]) < 1e-5, (r, k)
            continue
        shadows = _layers(lambda j, k: res[f"{pre}/shadow/{j}/{k}"], n)
        check_bf16_parity(got, one["logits"], mine, _layers(one["cache"], n),
                          shadows, tol=1e-5)
        check_bf16_parity(
            got, ref[f"{rkey}/logits"], mine,
            _layers(lambda j, k: ref[f"{rkey}/cache/{j}/{k}"], n), shadows,
            tol=1e-4)


@pytest.mark.parametrize("case", DECODE_CASES, ids=DECODE_IDS)
def test_decode_rank_holds_placed_bytes(world, case):
    """Each rank's bytes of parameters and decode cache in a decode cell:
    the dry run's ``placed(fsdp=False)``, its bfloat16 parameters and
    cache at 2 bytes an entry against the rank's float32 at 4."""
    name, arch, var, mkey, b, dt, _, _, cache_len = case
    cfg = ranks.variant(arch, var)
    shape = tuple(int(x) for x in mkey.split("x"))
    mesh = D.Mesh(D.device_array(["cpu"] * int(np.prod(shape)), shape),
                  ("data", "model"))
    pspecs, paxes = SP.model_param_specs(cfg, mode="dense")
    want = DR.placed(cfg, ShapeConfig("d", cache_len, b, "decode"), mesh,
                     pspecs, paxes, "dense", fsdp=False)["bytes_per_device"]
    for r in _pairs(mkey).values():
        params, cache = world["pool"][r][f"tp/decode/{name}/bytes"]
        assert params == want["params"] * 4 // 2, r
        assert cache == want["cache"] * (2 if dt == "float32" else 1), r


@pytest.mark.parametrize("arch,var", MOE_PART)
def test_moe_over_a_ranks_experts_matches_whole(world, arch, var):
    """``moe_apply`` over each rank's E / 2 experts (``moe_apply_ep``'s
    fallback where 3 tokens do not split over 2 'model' ranks, and the
    decode step's path): the output and aux within 1e-5 of the whole
    layer's, the input's and every leaf's gradient (the experts and the
    shared experts' columns gathered, the router whole on each rank)
    within 1e-4."""
    cfg = ranks.variant(arch, var)
    pre = f"tp/moe/{arch}/{var}"
    inp = world["inputs"]
    p = cm.tree_map(lambda t: t.requires_grad_(True),
                    ranks.tree_from(inp, f"{pre}/p", tmoe.moe_spec(cfg)))
    x = torch.as_tensor(inp[f"{pre}/x"]).requires_grad_(True)
    y, aux = tmoe.moe_apply(p, x, cfg)
    (torch.sum(y * torch.as_tensor(inp[f"{pre}/ct"])) + aux).backward()
    for res in world["pool"][:2]:
        assert int(res[f"{pre}/held"]) * 2 == cfg.moe.num_experts
        assert _rel(res[f"{pre}/y"], y.detach().numpy()) < 1e-5
        assert _rel(res[f"{pre}/aux"], aux.detach().numpy()) < 1e-5
        assert _rel(res[f"{pre}/gx"], x.grad.numpy()) < 1e-4
        for path, leaf in cm.tree_items(p):
            assert _rel(res[f"{pre}/g/{path}"], leaf.grad.numpy()) < 1e-4, \
                path


# ------------------------------------------------------------ raises

@pytest.mark.parametrize("arch,mode", [("minicpm3-4b", "dense"),
                                       ("rwkv6-3b", "dense"),
                                       ("minicpm3-4b", "gar")])
def test_split_leaf_the_rank_cannot_run_raises(arch, mode):
    """``rank_dims`` holds MLA's attention and the recurrent blocks whole
    (in the GAR form too: MLA's GAR leaves); cut by ``model_dims``
    instead, the rank program raises where it meets such a leaf, on a
    fake world of two ranks."""
    cfg = get_config(arch, smoke=True)
    pspecs, paxes = SP.model_param_specs(cfg, mode=mode)
    D.init_world("fake", device="cpu", rank=0, world_size=2)
    try:
        mesh = D.mesh_over_world((1, 2), ("data", "model"))
        full = D.sharding.dim_leaves(D.model_dims(mesh, paxes, pspecs))
        held = D.sharding.dim_leaves(D.rank_dims(cfg, mesh, paxes, pspecs))
        assert full != held
        gen = torch.Generator().manual_seed(0)
        params = DR._make(pspecs, torch.float32, "cpu", gen)
        ok = D.shard_tree(params, D.rank_dims(cfg, mesh, paxes, pspecs),
                          mesh)
        cut = D.shard_tree(params, D.model_dims(mesh, paxes, pspecs), mesh)
        tokens = torch.zeros((1, 4), dtype=torch.long)
        with D.mesh_context(mesh), torch.no_grad():
            tfm.forward(ok, cfg, tokens)
            with pytest.raises(ValueError, match="'model'|neither whole"):
                tfm.forward(cut, cfg, tokens)
    finally:
        D.shutdown_world()
