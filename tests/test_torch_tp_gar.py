"""The GAR form over 'model' (``models/tp.py:_gar_linear``): each rank
holds ``v_tilde`` and ``u_hat`` as the reference's ``param_shardings``
places them (``perm_inv`` whole) and runs its part of every GAR product,
across two CPU ranks over gloo (``tests/torch_dist_ranks.py``, one pool
of two ranks at mesh (1, 2)).

* (a) The GAR ``linear`` on each rank's parts, its cut read from
  ``model_dims`` of the leaf's logical axes: column-parallel (``v_tilde``
  by rank, ``u_hat`` by out), row-parallel (``v_tilde`` by in, ``u_hat``
  by rank; the input cut or whole), rank-parallel (both by rank), and the
  mixes where one leaf stays whole because its dimension does not divide
  (m - r odd, r odd, an odd input), and m - r = 0. The output and the
  input's and both factors' gradients against the whole product; the
  output also against ``ref.gar_matmul_ref`` plus the permutation in
  float64. Each layout's collectives traced on ``meta`` in a fake world of
  two, as the dry run counts them: z and the tail only. Then
  ``moe_apply`` over a rank's 4 of 8 GAR experts (each with its own
  ``perm_inv``), the shared experts' GAR leaves cut as placed.
* (b) gpt2-small and deepseek-moe-16b smoke configs in ``gar`` mode at
  budgets 0.9 (the default row, where most smoke leaves have an odd rank
  and stay whole) and 0.7 (every leaf of those two cut): a prompt through
  ``prefill`` into each rank's part of the decode cache and 4 decode
  steps, against one rank of the port and against the reference's
  prefill and ``make_decode_step`` in ``gar`` mode jitted with
  ``param_shardings`` and ``cache_shardings`` on forced host devices (in
  a subprocess, while the pool runs).
* (c) Each rank's bytes of parameters and cache in those cells against
  the dry run's ``placed(fsdp=False)``: the rank's float32 and int64
  against the reference's bfloat16 and int32, twice as many bytes.

Tolerances, float32 throughout: against the whole product or the one-rank
port (the same products, summed in another order across ranks) 1e-5 of
the output's or logits' max, 1e-4 of each gradient's max; against the
float64 plain version 1e-5 of the output's max; against the reference's
partitioned program 1e-4 of the logits' max (two libraries' float32
products).
"""
import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import distributed as D
from repro_torch.configs import ShapeConfig
from repro_torch.kernels import ref as kref
from repro_torch.launch import dryrun as DR
from repro_torch.launch import specs as SP
from repro_torch.launch import trace_analysis as TA
from repro_torch.models import common as cm
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tfm

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import torch_dist_ranks as ranks  # noqa: E402
from test_torch_dist import _env, run_pool  # noqa: E402

DEADLINE = 140
MESH = "1x2"
# name, whole (d_in, d_out[, rank-parallel's third]), r, input axis,
# output axis, input cut; the leaves' cut is model_dims' of the axes
LINEAR = [
    ("column", (8, 12), 4, cm.EMBED, cm.HEADS, False),
    ("row", (12, 8), 4, cm.HEADS, cm.EMBED, True),
    ("row_whole_x", (12, 8), 4, cm.HEADS, cm.EMBED, False),
    ("rank", (10, 8, 6), 4, None, cm.EMBED, False),
    # m - r = 7 does not divide: u_hat whole, v_tilde by rank
    ("column_u_whole", (8, 11), 4, cm.EMBED, cm.MLP, False),
    # r = 3 does not divide: v_tilde whole, u_hat by out
    ("column_v_whole", (8, 13), 3, cm.EMBED, cm.HEADS, False),
    # an input of 11 does not divide: v_tilde whole, u_hat by rank
    ("row_v_whole", (11, 8), 4, cm.MLP, cm.EMBED, False),
    # m - r = 0: stage 1 alone
    ("column_no_tail", (8, 4), 4, cm.EMBED, cm.HEADS, False),
]
LINEAR_IDS = [c[0] for c in LINEAR]
MOE = [("deepseek-moe-16b", "nodrop", 3)]
# name, arch, variant, budget index; batch 2, 8 prompt tokens, 4 steps,
# 16 positions
DECODE = [("gpt2_b09", "gpt2-small", "default", -2),
          ("gpt2_b07", "gpt2-small", "default", 3),
          ("deepseek_b09", "deepseek-moe-16b", "nodrop_aux0", -2),
          ("deepseek_b07", "deepseek-moe-16b", "nodrop_aux0", 3)]
DECODE_IDS = [c[0] for c in DECODE]
B, PROMPT, STEPS, CACHE = 2, 8, 4, 16


def _spec(whole, r, in_axis, out_axis) -> dict:
    n, m = whole[0], whole[1]
    return {"v_tilde": cm.ParamSpec((n, r), (in_axis, cm.RANK)),
            "u_hat": cm.ParamSpec((m - r, r), (out_axis, cm.RANK)),
            "perm_inv": cm.ParamSpec((m,), (None,), "zeros", torch.int32)}


def _mesh():
    return D.Mesh(D.device_array(["cpu"] * 2, (1, 2)), ("data", "model"))


def _dims(spec) -> dict:
    return D.model_dims(_mesh(), cm.axes_tree(spec), spec)


def _gar_arrays(rng, spec) -> dict:
    """Every leaf of a GAR spec tree: the floating ones drawn at a 1/sqrt
    fan-in scale, each ``perm_inv`` row a permutation (int64)."""
    out = {}
    for path, s in cm.tree_items(spec, is_leaf=cm.is_spec):
        if s.dtype == torch.int32:
            m = s.shape[-1]
            rows = [rng.permutation(m) for _ in range(
                int(np.prod(s.shape[:-1])))]
            out[path] = np.stack(rows).reshape(s.shape).astype(np.int64)
        elif s.init == "normal":
            fan = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            out[path] = (rng.standard_normal(s.shape) / np.sqrt(fan)
                         ).astype(np.float32)
        else:
            out[path] = 0.1 * rng.standard_normal(s.shape).astype(
                np.float32)
    return out


def _write_inputs(path: Path) -> dict:
    rng = np.random.default_rng(31)
    a = {}
    for name, whole, r, ia, oa, _ in LINEAR:
        pre = f"tp/gar/{name}"
        for k, t in _gar_arrays(rng, _spec(whole, r, ia, oa)).items():
            a[f"{pre}/p/{k}"] = t
        a[f"{pre}/x"] = rng.standard_normal((3, 5, whole[0])).astype(
            np.float32)
        a[f"{pre}/ct"] = rng.standard_normal((3, 5, whole[1])).astype(
            np.float32)
    for arch, var, budget in MOE:
        cfg = ranks.variant(arch, var)
        pre = f"tp/garmoe/{arch}/{budget}"
        for k, t in _gar_arrays(rng, ranks.gar_moe_spec(cfg, budget)
                                ).items():
            a[f"{pre}/p/{k}"] = t
        for k in ("x", "ct"):
            a[f"{pre}/{k}"] = rng.standard_normal((1, 3, cfg.d_model)
                                                  ).astype(np.float32)
    for name, arch, var, budget in DECODE:
        cfg = ranks.variant(arch, var)
        pre = f"tp/decode/{name}"
        spec = SP.model_param_specs(cfg, mode="gar", budget_index=budget)[0]
        for k, t in _gar_arrays(rng, spec).items():
            a[f"{pre}/p/{k}"] = t
        a[f"{pre}/tokens"] = rng.integers(
            0, cfg.vocab_size, (B, PROMPT + STEPS)).astype(np.int32)
    np.savez(path / "inputs.npz", **a)
    return a


# ------------------------------------------------------- the reference

REF_SCRIPT = textwrap.dedent('''
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.distributed.sharding import param_shardings
    from repro.distributed.meshctx import mesh_context
    from repro.launch import specs as SP
    from repro.launch.mesh import make_mesh
    from repro.models import common as cm
    from repro.models import transformer as tfm

    d = sys.argv[1]
    cases = json.loads(sys.argv[2])
    b, prompt, steps, cache_len = json.loads(sys.argv[3])
    inp = np.load(os.path.join(d, "inputs.npz"))
    out = {}

    def variant(arch, name):
        cfg = get_config(arch, smoke=True)
        if name == "default":
            return cfg
        m = dataclasses.replace(cfg.moe, capacity_factor=float(
            cfg.moe.num_experts), router_aux_weight=0.0)
        return dataclasses.replace(cfg, moe=m)

    def path_str(kp):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in kp)

    def tree(prefix, spec):
        leaves, tdef = jax.tree_util.tree_flatten_with_path(
            spec, is_leaf=cm.is_spec)
        return jax.tree_util.tree_unflatten(tdef, [
            jnp.asarray(inp[prefix + "/" + path_str(k)], s.dtype)
            for k, s in leaves])

    mesh = make_mesh((1, 2), ("data", "model"))
    for name, arch, var, budget in cases:
        cfg = variant(arch, var)
        pre = "tp/decode/" + name
        pspecs, paxes = SP.model_param_specs(cfg, mode="gar",
                                             budget_index=budget)
        params = tree(pre + "/p", pspecs)
        tokens = jnp.asarray(inp[pre + "/tokens"])
        shp = ShapeConfig("d", cache_len, b, "decode")
        with mesh_context(mesh):
            state = tfm.init_decode_state(cfg, b, cache_len,
                                          dtype=jnp.float32)
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
        out["ref/decode/" + name] = np.concatenate(logits, 1)
    np.savez(os.path.join(d, "ref_gar.npz"), **out)
    print("REFOK")
''')


# ------------------------------------------------------------ the pool

def _jobs() -> list:
    lin = [{"name": n, "whole": list(w),
            "dims": _dims(_spec(w, r, ia, oa)), "x_cut": cut}
           for n, w, r, ia, oa, cut in LINEAR]
    return [
        {"kind": "tp_gar_linear", "mesh": MESH, "cases": lin},
        {"kind": "tp_gar_moe", "mesh": MESH,
         "cases": [list(c) for c in MOE]},
        *[{"kind": "tp_decode", "mesh": MESH, "mode": "gar",
           "budget": budget,
           "case": [name, arch, var, MESH, B, "float32", PROMPT, STEPS,
                    CACHE]}
          for name, arch, var, budget in DECODE],
    ]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The pool's results and the reference's, computed once."""
    tmp = tmp_path_factory.mktemp("tp_gar")
    inputs = _write_inputs(tmp)
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(tmp), json.dumps(DECODE),
         json.dumps([B, PROMPT, STEPS, CACHE])], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    end = time.monotonic() + DEADLINE
    try:
        pool = run_pool(tmp, (1, 2), _jobs(), end - time.monotonic())
        out, err = proc.communicate(timeout=max(end - time.monotonic(), 1.0))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == 0 and "REFOK" in out, err[-3000:]
    return {"pool": pool, "ref": dict(np.load(tmp / "ref_gar.npz")),
            "inputs": inputs}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.size == 0 and b.size == 0:
        return 0.0
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-12)


# ------------------------------------------------------------ (a)

@pytest.mark.parametrize("case", LINEAR, ids=LINEAR_IDS)
def test_gar_linear_parts_match_whole(world, case):
    """Each rank's part of a GAR product against the whole one: the
    output (kept as the rank's columns where the product is column-
    parallel and they divide), the input's gradient (the rank's columns
    where its input is cut) and each factor's (the rank's part)."""
    name, whole, r, ia, oa, cut = case
    inp, pool = world["inputs"], world["pool"]
    pre = f"tp/gar/{name}"
    spec = _spec(whole, r, ia, oa)
    dims = _dims(spec)
    assert any(d is not None for d in dims.values()), dims
    assert dims["perm_inv"] is None
    p = {k: torch.as_tensor(inp[f"{pre}/p/{k}"]) for k in spec}
    for k in ("v_tilde", "u_hat"):
        p[k].requires_grad_(True)
    x = torch.as_tensor(inp[f"{pre}/x"]).requires_grad_(True)
    y = cm.linear(p, x)
    torch.sum(y * torch.as_tensor(inp[f"{pre}/ct"])).backward()
    z, tail = kref.gar_matmul_ref(
        x.detach().double().reshape(-1, whole[0]), p["v_tilde"].detach()
        .double(), p["u_hat"].detach().double())
    plain = torch.cat([z, tail], -1)[:, p["perm_inv"]].reshape(y.shape)
    column = oa in (cm.HEADS, cm.MLP) and (
        dims["u_hat"] == 0 or dims["v_tilde"] == 1)
    cols = whole[1] // 2 if column and whole[1] % 2 == 0 else whole[1]
    for m, res in enumerate(pool):
        assert int(res[f"{pre}/cols"]) == cols
        assert _rel(res[f"{pre}/y"], y.detach().numpy()) < 1e-5
        assert _rel(res[f"{pre}/y"], plain.numpy()) < 1e-5
        gx = x.grad.numpy()
        if cut:
            gx = np.split(gx, 2, axis=-1)[m]
        assert _rel(res[f"{pre}/gx"], gx) < 1e-4
        for k in ("v_tilde", "u_hat"):
            g = p[k].grad.numpy()
            if dims[k] is not None:
                g = np.split(g, 2, axis=dims[k])[m]
            assert res[f"{pre}/g/{k}"].shape == g.shape, k
            assert _rel(res[f"{pre}/g/{k}"], g) < 1e-4, k


@pytest.mark.parametrize("case", LINEAR, ids=LINEAR_IDS)
def test_gar_linear_moves_only_z_and_the_tail(case):
    """The collectives of a rank's GAR product, traced on ``meta`` as rank
    0 of a fake world of two (``launch/trace_analysis.py``, as the dry
    run counts them): all-gathers of the rank's columns of z (``v_tilde``
    by rank) and rows of the tail (``u_hat`` by out), all-reduces of a
    partial z (``v_tilde`` by in) and a partial tail (``u_hat`` by rank),
    and nothing else: no weight crosses the ranks."""
    name, whole, r, ia, oa, cut = case
    spec = _spec(whole, r, ia, oa)
    dims = _dims(spec)
    t, m, mt = 15, whole[1], whole[1] - r
    DR.fake_world(2)
    try:
        mesh = D.mesh_over_world((1, 2), ("data", "model"))
        p = {k: torch.empty(SP.shard_shape(mesh, pl, s.shape),
                            dtype=torch.float32 if k != "perm_inv"
                            else torch.int64, device="meta")
             for (k, s), pl in zip(sorted(spec.items()), cm.tree_leaves(
                 D.param_shardings(mesh, cm.axes_tree(spec), spec),
                 is_leaf=D.sharding.is_placement))}
        x = torch.empty(3, 5, whole[0] // 2 if cut else whole[0],
                        device="meta")
        with D.mesh_context(mesh):
            _, fig = TA.trace(lambda a, b: cm.linear(a, b, whole=whole),
                              p, x, memory=False)
    finally:
        D.shutdown_world()
    gathered = (t * r // 2 if dims["v_tilde"] == 1 else 0) + (
        t * mt // 2 if dims["u_hat"] == 0 else 0)
    summed = (t * r if dims["v_tilde"] == 0 else 0) + (
        t * mt if dims["u_hat"] == 1 else 0)
    got = fig["collective_bytes"]
    assert got["all-gather"] == 4 * gathered and \
        got["all-reduce"] == 4 * summed, got
    assert fig["collective_bytes_total"] == 4 * (gathered + summed) \
        <= 4 * t * m


@pytest.mark.parametrize("arch,var,budget", MOE)
def test_gar_experts_over_a_ranks_experts_match_whole(world, arch, var,
                                                      budget):
    """``moe_apply`` with GAR experts over each rank's E / 2 (their own
    ``perm_inv`` rows) and the shared experts' GAR leaves cut over
    'model': the output and aux within 1e-5 of the whole layer's, the
    input's and every factor's gradient within 1e-4."""
    cfg = ranks.variant(arch, var)
    pre = f"tp/garmoe/{arch}/{budget}"
    inp = world["inputs"]
    spec = ranks.gar_moe_spec(cfg, budget)
    dims = D.sharding.dim_leaves(D.rank_dims(cfg, _mesh(),
                                             cm.axes_tree(spec), spec))
    assert sum(d is not None for d in dims) > 9, dims
    p = ranks.tree_from(inp, f"{pre}/p", spec)
    p = cm.tree_map(lambda t: t.requires_grad_(t.is_floating_point()), p)
    x = torch.as_tensor(inp[f"{pre}/x"]).requires_grad_(True)
    y, aux = tmoe.moe_apply(p, x, cfg)
    (torch.sum(y * torch.as_tensor(inp[f"{pre}/ct"])) + aux).backward()
    for res in world["pool"]:
        assert int(res[f"{pre}/held"]) * 2 == cfg.moe.num_experts
        assert _rel(res[f"{pre}/y"], y.detach().numpy()) < 1e-5
        assert _rel(res[f"{pre}/aux"], aux.detach().numpy()) < 1e-5
        assert _rel(res[f"{pre}/gx"], x.grad.numpy()) < 1e-4
        for path, leaf in cm.tree_items(p):
            if leaf.is_floating_point():
                assert _rel(res[f"{pre}/g/{path}"], leaf.grad.numpy()) \
                    < 1e-4, path


# ------------------------------------------------------------ (b), (c)

def _one_rank_decode(world, case) -> np.ndarray:
    """The cell's prompt and steps on one rank, whole (no mesh)."""
    name, arch, var, budget = case
    cfg = ranks.variant(arch, var)
    pre = f"tp/decode/{name}"
    pspecs, _ = SP.model_param_specs(cfg, mode="gar", budget_index=budget)
    params = ranks.tree_from(world["inputs"], f"{pre}/p", pspecs)
    tokens = torch.as_tensor(world["inputs"][f"{pre}/tokens"])
    state = SP.cache_specs(cfg, ShapeConfig("d", CACHE, B, "decode"),
                           dtype=torch.float32, device="cpu")
    dec = SP.make_decode_step(cfg)
    with torch.no_grad():
        lg, state = tfm.prefill(params, cfg, state, tokens[:, :PROMPT])
        logits = [lg]
        for i in range(STEPS):
            lg, state = dec(params, state, {
                "tokens": tokens[:, PROMPT + i:PROMPT + i + 1]})
            logits.append(lg[:, None])
    return torch.cat(logits, 1).numpy()


@pytest.mark.parametrize("case", DECODE, ids=DECODE_IDS)
def test_gar_decode_matches_one_rank_and_reference(world, case):
    """The gar-mode prefill and decode steps on each rank's part of every
    leaf and of the cache: the logits within 1e-5 of their max of one
    rank's and within 1e-4 of the reference's jitted with its
    placements."""
    one = _one_rank_decode(world, case)
    key = f"tp/decode/{case[0]}/logits"
    for res in world["pool"]:
        assert _rel(res[key], one) < 1e-5
        assert _rel(res[key], world["ref"][f"ref/decode/{case[0]}"]) < 1e-4


@pytest.mark.parametrize("case", DECODE, ids=DECODE_IDS)
def test_gar_decode_rank_holds_placed_bytes(world, case):
    """Each rank's bytes of parameters and cache: twice the dry run's
    ``placed(fsdp=False)`` for the gar decode cell (float32 and int64
    against bfloat16 and int32)."""
    name, arch, var, budget = case
    cfg = ranks.variant(arch, var)
    pspecs, paxes = SP.model_param_specs(cfg, mode="gar",
                                         budget_index=budget)
    want = DR.placed(cfg, ShapeConfig("d", CACHE, B, "decode"), _mesh(),
                     pspecs, paxes, "gar", fsdp=False)["bytes_per_device"]
    for res in world["pool"]:
        params, cache = res[f"tp/decode/{name}/bytes"]
        assert params == 2 * want["params"]
        assert cache == 2 * want["cache"]
