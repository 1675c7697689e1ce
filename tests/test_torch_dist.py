"""The port's mesh path across ranks against the JAX package's on forced
host devices, on the CPU: ``moe_apply_ep`` at meshes (1, 2), (2, 1),
(2, 2) and (1, 4), PowerSGD over 2 and 4 data ranks, the placement
functions and the cost model's mesh divisors, on deepseek-moe-16b's smoke
config (top-2 of 8) and llama4-scout-17b-a16e's (top-1 of 4); the
training launcher across ranks is ``tests/test_torch_dist_launcher.py``'s,
on this file's harness (``build_world``, ``run_pool``).

Ranks are CPU processes over gloo (``tests/torch_dist_ranks.py``): one
pool per mesh shape runs that shape's jobs, every process group with a
30 s timeout, and every process is waited for within one deadline, past
which the test fails and the processes are killed. One subprocess with 8 forced
host devices (as ``tests/test_system.py`` runs ``moe_apply_ep``) writes
the reference's numbers, while the pools run. Inputs are drawn here with
numpy from a seed and read by both.

Tolerances, float32 throughout: ``moe_apply_ep``'s output 1e-4 of its
max (the reference's own bound against its global path); gradients
1e-4 of each leaf's max (the same products in other orders, and the
all-to-all's exchange); ``aux`` at data 1 within float32 rounding of
the reference's (2e-6 relative: the router's product and the means sum
in other orders in the two libraries). PowerSGD: the per-leaf bounds of
``tests/test_torch_nestedness.py``. Two launcher steps: losses 1e-3
relative against the reference's launcher (the tolerance of
``tests/test_torch_train.py``'s launcher comparison); against the
one-rank port at no drop and no aux loss, losses 1e-4 relative and
parameters 2e-3 of each leaf's max (Adam's normalised step of an entry
whose gradient is rounding noise, as in ``tests/test_torch_train_modes.py``).
"""
import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import ShapeConfig as JShape
from repro.launch.costmodel import memory_traffic as jtraffic
from repro.models import common as jcm
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch import distributed as tdist
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.core import flexrank as TFR
from repro_torch.launch import train as ttrain
from repro_torch.launch.costmodel import memory_traffic as ttraffic
from repro_torch.models import common as tcm
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
SRC = str(HERE.parent / "src")
ARCHS = ["deepseek-moe-16b", "llama4-scout-17b-a16e"]
MOE_MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
B, S = 4, 16                   # the MoE inputs, and the launcher's batch
DEADLINE = 300                 # seconds for every process of the file

sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))
import torch_dist_ranks as ranks  # noqa: E402

# the launcher's other modes and Muon across ranks, at no drop and no aux.
# Muon on deepseek only: llama4's top-1 gate, renormalised, is 1 whatever
# the router says, so without the aux loss its router's gradient is
# rounding noise (singular values ~1e-9), which Muon's Newton-Schulz turns
# into a full-size step that another summation order changes whole
MODES = [(a, "flexrank", "adamw") for a in ARCHS] + [
    (a, "flexrank_kd", "adamw") for a in ARCHS] + [
    ("deepseek-moe-16b", "flexrank_kd", "muon"),
    ("deepseek-moe-16b", "dense", "muon")]
MODE_RUNS = [[a, "nodrop_aux0", m, o] for a, m, o in MODES]


# ------------------------------------------------------------ inputs

def _draw(rng, shape):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)


def _psgd_tree(rng):
    def n(*s):
        return rng.standard_normal(s).astype(np.float32)
    return {"a": n(64, 48), "b": n(3, 32, 40), "c": n(16), "d": n(8, 8),
            "segments/0/w": n(40, 96)}


def _write_inputs(path: Path) -> dict:
    """Every input of the pools and the reference, drawn with numpy; the
    dense weights are the reference launcher's own (``instantiate`` from
    ``PRNGKey(0)``), as ``tests/test_torch_mesh.py`` gives them to the
    port."""
    rng = np.random.default_rng(27)
    arrays = {}
    for arch in ARCHS:
        cfg = tget(arch, smoke=True)
        for p, s in tcm.tree_items(tmoe.moe_spec(cfg), is_leaf=tcm.is_spec):
            arrays[f"moe/{arch}/p/{p}"] = _draw(rng, s.shape)
        for k in ("x", "ct"):
            arrays[f"moe/{arch}/{k}"] = rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)
        jcfg = jget(arch, smoke=True)
        dense = bridge.params_to_torch(jax.tree.map(np.asarray, jcm.instantiate(
            jtfm.model_spec(jcfg), jax.random.PRNGKey(0))))
        for p, t in tcm.tree_items(dense):
            arrays[f"dense/{arch}/{p}"] = t.numpy()
    for k, v in _psgd_tree(rng).items():
        arrays[f"psgd/tmpl/{k}"] = np.zeros_like(v)
    for step in range(3):
        for r in range(4):
            for k, v in _psgd_tree(rng).items():
                arrays[f"psgd/s{step}r{r}/{k}"] = v
    np.savez(path / "inputs.npz", **arrays)
    return arrays


# ------------------------------------------------------- the reference

REF_SCRIPT = textwrap.dedent('''
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.configs import get_config
    from repro.core import flexrank as FR
    from repro.distributed import sharding as S
    from repro.distributed.meshctx import mesh_context, logical_to_spec
    from repro.launch import train as jtrain
    from repro.launch.mesh import make_mesh
    from repro.models import moe, common as cm, transformer as T
    from repro.optim import compression as JC
    import dataclasses
    try:
        from jax import shard_map
        import functools
        shard_map = functools.partial(shard_map, check_vma=False)
    except ImportError:
        from jax.experimental.shard_map import shard_map

    d = sys.argv[1]
    inp = np.load(os.path.join(d, "inputs.npz"))
    out, specs = {}, {}

    def variant(arch, name):
        cfg = get_config(arch, smoke=True)
        if name == "default":
            return cfg
        m = dataclasses.replace(cfg.moe,
                                capacity_factor=float(cfg.moe.num_experts))
        return dataclasses.replace(cfg, moe=m)

    def _nest(flat):
        tree = {}
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

    def loss(p, x, ct, cfg, kind, fn):
        y, aux = fn(p, x, cfg)
        l = jnp.sum(y * ct) + (aux if kind == "aux" else 0.0)
        return l, (y, aux)

    def grad_fn():
        # a new function for each mesh: jit's cache does not key on the
        # mesh that moe_apply_ep reads while tracing
        def f(*a):
            return loss(*a)
        return jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True),
                       static_argnums=(3, 4, 5))

    part = sys.argv[5]
    for arch in (sys.argv[3].split(",") if part == "moe" else []):
        pre = "moe/" + arch
        x, ct = (jnp.asarray(inp[pre + "/" + k]) for k in ("x", "ct"))
        for name, kind in (("default", "aux"), ("nodrop", "aux"),
                           ("nodrop", "out")):
            cfg = variant(arch, name)
            p = tree(pre + "/p", moe.moe_spec(cfg))
            if (name, kind) == ("nodrop", "out"):
                (_, (y, _)), (gp, gx) = grad_fn()(p, x, ct, cfg, kind,
                                                  moe.moe_apply)
                put(pre + "/global/grad", gp)
                out[pre + "/global/gx"] = np.asarray(gx)
                out[pre + "/global/out"] = np.asarray(y)
            for shape in json.loads(sys.argv[4]):
                with mesh_context(make_mesh(tuple(shape), ("data", "model"))):
                    (_, (y, aux)), (gp, gx) = grad_fn()(
                        p, x, ct, cfg, kind, moe.moe_apply_ep)
                key = "%s/%dx%d/%s_%s" % (pre, shape[0], shape[1], name, kind)
                out[key + "/out"] = np.asarray(y)
                out[key + "/aux"] = np.asarray(aux)
                out[key + "/gx"] = np.asarray(gx)
                put(key + "/grad", gp)

    # PowerSGD over 2 and 4 data devices, under shard_map
    cfg = JC.PowerSGDConfig(rank=4, min_compress_size=256)
    tmpl = _nest({k[len("psgd/tmpl/"):]: jnp.asarray(v)
                  for k, v in inp.items() if k.startswith("psgd/tmpl/")})
    for nd in ((2, 4) if part == "rest" else ()):
        mesh = make_mesh((nd,), ("data",))
        st = JC.init(tmpl, cfg, seed=3)
        q = jax.tree.map(lambda a: jnp.stack([a] * nd), st.q)
        e = jax.tree.map(lambda a: jnp.stack([a] * nd), st.error)

        def body(g, q, e):
            sq = lambda t: jax.tree.map(lambda a: a[0], t)
            g2, st2, _ = JC.compress_decompress(
                sq(g), JC.PowerSGDState(q=sq(q), error=sq(e)), cfg,
                axis_name="data")
            ex = lambda t: jax.tree.map(lambda a: a[None], t)
            return ex(g2), ex(st2.q), ex(st2.error)
        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),) * 3,
                              out_specs=(P("data"),) * 3))
        for step in range(3):
            g = [_nest({k.split("/", 2)[2]: v for k, v in inp.items()
                        if k.startswith("psgd/s%dr%d/" % (step, r))})
                 for r in range(nd)]
            g = jax.tree.map(lambda *a: jnp.stack(a), *g)
            g, q, e = f(g, q, e)
            for r in range(nd):
                at = lambda t: jax.tree.map(lambda a: a[r], t)
                put("psgd%d/%d/r%d/g" % (nd, step, r), at(g))
                put("psgd%d/%d/r%d/q" % (nd, step, r), at(q))
                put("psgd%d/%d/r%d/e" % (nd, step, r), at(e))

    # the launcher on meshes of the first prod(shape) devices
    for arch in (part[len("main:"):].split(",") if part.startswith("main:")
                 else []):
        for shape in ((2, 1), (2, 2)):
            n = shape[0] * shape[1]
            jtrain.elastic_remesh = (
                lambda s, a, n=n: S.elastic_remesh(s, a,
                                                   devices=jax.devices()[:n]))
            _, losses = jtrain.main(
                ["--arch", arch, "--smoke", "--steps", "2", "--seq-len",
                 "16", "--batch", "4", "--mesh-shape", "%d,%d" % shape])
            out["main/%s/%dx%d" % (arch, shape[0], shape[1])] = np.asarray(
                losses)

    # placements
    def norm(p):
        return [None if e is None else [e] if isinstance(e, str)
                else list(e) for e in p]
    AXES = [("batch", "seq", "heads"), ("batch", None, "mlp"),
            ("layers", "experts", "embed", "mlp"), ("embed", "rank"),
            ("vocab", "embed"), ("seq", "kv_heads", "sp"), ("rank", "mlp")]
    for shape, names in ((((2, 2), ("data", "model")),
                          ((1, 4), ("data", "model")),
                          ((2, 2, 2), ("pod", "data", "model")))
                         if part == "rest" else ()):
        n = int(np.prod(shape))
        mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)
        key = "x".join(map(str, shape))
        specs[key + "/logical"] = [norm(logical_to_spec(mesh, a))
                                   for a in AXES]
        specs[key + "/batch"] = [norm(S.batch_spec(mesh, extra_dims=k))
                                 for k in (1, 2)]
        specs[key + "/seq_cache"] = norm(S.seq_sharded_cache(
            mesh, time_axis=2, ndim=5).spec)
        specs[key + "/replicated"] = norm(S.replicated(mesh).spec)
        for arch in sys.argv[3].split(","):
            for smoke in (True, False):
                cfg = get_config(arch, smoke=smoke)
                for kind, spec in (("dense", T.model_spec(cfg)),
                                   ("fact", FR.factorized_spec(cfg))):
                    axes = cm.axes_tree(spec)
                    for tag, kw in (("plain", {}), ("shapes", dict(shapes=spec)),
                                    ("fsdp", dict(shapes=spec, fsdp=True))):
                        sh = S.param_shardings(mesh, axes, **kw)
                        specs["%s/%s/%s/%s/%s" % (key, arch, smoke, kind, tag)] = [
                            [path_str(kp), norm(s.spec)] for kp, s in
                            jax.tree_util.tree_flatten_with_path(sh)[0]]
    tag = part.replace(":", "_").replace(",", "_")
    np.savez(os.path.join(d, "ref_%s.npz" % tag), **out)
    with open(os.path.join(d, "ref_specs_%s.json" % tag), "w") as f:
        json.dump(specs, f)
    print("REFOK")
''')


# ----------------------------------------------------------- the ranks

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get(
        "PYTHONPATH", ""), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "XLA_FLAGS"):
        env.pop(k, None)
    return env


def run_pool(tmp: Path, shape, jobs, deadline: float) -> list:
    """Run ``jobs`` on a world of ``prod(shape)`` rank processes; returns
    each rank's results. A rank that fails, or a pool past ``deadline``
    seconds, fails the test and kills every rank of the pool."""
    world = shape[0] * shape[1]
    d = tmp / f"pool_{shape[0]}x{shape[1]}"
    d.mkdir()
    shutil.copy(tmp / "inputs.npz", d / "inputs.npz")
    spec = {"world": world, "shape": list(shape), "port": _free_port(),
            "main_port": _free_port(), "dir": str(d), "jobs": jobs}
    (d / "spec.json").write_text(json.dumps(spec))
    logs = [open(d / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "torch_dist_ranks.py"),
         str(d / "spec.json"), str(r)], env=_env(), stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    t0 = time.monotonic()
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad or time.monotonic() - t0 > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        for f in logs:
            f.close()
    codes = [p.returncode for p in procs]
    if codes != [0] * world:
        tails = "\n".join(f"--- rank {r} (exit {c})\n"
                          + (d / f"rank{r}.log").read_text()[-3000:]
                          for r, c in enumerate(codes))
        pytest.fail(f"pool {shape}: exits {codes} after "
                    f"{time.monotonic() - t0:.1f} s\n{tails}")
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]


def _dense(arch):
    inputs = np.load(_STATE["tmp"] / "inputs.npz")
    return ranks.tree_from(inputs, f"dense/{arch}",
                           ttfm.model_spec(tget(arch, smoke=True)))


_STATE: dict = {}

# the reference's work in parallel processes: the MoE layer, PowerSGD and
# the placements (the launcher's is ``tests/test_torch_dist_launcher.py``'s)
REF_PARTS = ["moe", "rest"]

POOLS = {
    (1, 2): [{"kind": "moe", "archs": ARCHS}],
    (2, 1): [{"kind": "moe", "archs": ARCHS}, {"kind": "powersgd"}],
    (2, 2): [{"kind": "moe", "archs": ARCHS}],
    (1, 4): [{"kind": "moe", "archs": ARCHS}],
    (4, 1): [{"kind": "powersgd"}],
}


def build_world(tmp: Path, pools: dict, ref_parts: list, before=None,
                beside=None) -> dict:
    """Every pool's results and the reference's parts: the inputs drawn
    into ``tmp``, the reference's subprocesses started, ``beside(tmp)``
    (if given) run in a thread while ``before(tmp)`` (if given) and then
    the pools run, every process within ``DEADLINE``. Returns the pools',
    the reference's, the placements' and ``beside``'s results."""
    _STATE["tmp"] = tmp
    _write_inputs(tmp)
    refs = [subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(tmp), str(HERE),
         ",".join(ARCHS), json.dumps(MOE_MESHES), part], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in ref_parts]
    side: dict = {}
    thread = None
    if beside is not None:
        thread = threading.Thread(target=beside, args=(tmp, side),
                                  daemon=True)
        thread.start()
    end = time.monotonic() + DEADLINE

    def left():
        return max(end - time.monotonic(), 1.0)
    try:
        if before is not None:
            before(tmp)
        results = {}
        for shape, jobs in pools.items():
            results[shape] = run_pool(tmp, shape, jobs, left())
        done = [ref.communicate(timeout=left()) for ref in refs]
        if thread is not None:
            thread.join(timeout=left())
            assert not thread.is_alive(), "the thread beside the pools hangs"
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.wait(timeout=30)
    ref, specs = {}, {}
    for part, proc, (out, err) in zip(ref_parts, refs, done):
        assert proc.returncode == 0 and "REFOK" in out, err[-3000:]
        tag = part.replace(":", "_").replace(",", "_")
        ref.update(np.load(tmp / f"ref_{tag}.npz"))
        specs.update(json.loads((tmp / f"ref_specs_{tag}.json").read_text()))
    return {"pools": results, "ref": ref, "specs": specs, "tmp": tmp,
            "side": side}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every pool's results and the reference's, computed once."""
    return build_world(tmp_path_factory.mktemp("dist"), POOLS, REF_PARTS)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-12)


def _by(pool, shape):
    """The pool's results as ``{(data index, model index): results}``."""
    return {divmod(r, shape[1]): res for r, res in enumerate(pool)}


def _grads_whole(res, key, shape, names):
    """A gradient leaf of the global loss from the ranks: an expert leaf's
    slices concatenated over 'model' and summed over the data ranks; any
    other leaf summed over the data ranks (model rank 0's)."""
    nd, nm = shape
    g = f"{key}/grad/{names}"
    if names.startswith("experts"):
        return sum(np.concatenate([res[(d, m)][g] for m in range(nm)])
                   for d in range(nd))
    return sum(res[(d, 0)][g] for d in range(nd))


# ------------------------------------------------------- moe_apply_ep

@pytest.mark.parametrize("shape", MOE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_ep_matches_reference(world, arch, shape):
    """Output, aux and every gradient of ``sum(out * ct) + aux`` at the
    default capacity (per-slice drops) and at no drop, against the
    reference's ``moe_apply_ep`` (and ``jax.grad`` through it) on the
    same mesh of forced devices."""
    res, ref = _by(world["pools"][shape], shape), world["ref"]
    nd, nm = shape
    names = [p for p, _ in tcm.tree_items(tmoe.moe_spec(
        tget(arch, smoke=True)), is_leaf=tcm.is_spec)]
    # top-1: the renormalised gate is p / p, exactly 1, so the output's
    # part of the router's gradient is 0 and each library returns its own
    # float32 rounding of it; that noise, measured in both as the router's
    # gradient of sum(out * ct) at no drop, is allowed twice over
    top1 = tget(arch, smoke=True).moe.top_k == 1
    noise = float(np.abs(ref[f"moe/{arch}/global/grad/router/w"]).max()
                  + np.abs(_grads_whole(res, f"moe/{arch}/nodrop_out",
                                        shape, "router/w")).max())
    for name in ("default_aux", "nodrop_aux"):
        key = f"moe/{arch}/{name}"
        rkey = f"moe/{arch}/{shape[0]}x{shape[1]}/{name}"
        out = np.concatenate([res[(d, 0)][f"{key}/out"] for d in range(nd)])
        assert _rel(out, ref[f"{rkey}/out"]) < 1e-4, name
        gx = np.concatenate([res[(d, 0)][f"{key}/gx"] for d in range(nd)])
        assert _rel(gx, ref[f"{rkey}/gx"]) < 1e-4, name
        # the reference's aux is data shard 0's (its out_specs P() with
        # check_vma=False); at data 1 that is the whole of it
        np.testing.assert_allclose(res[(0, 0)][f"{key}/aux"],
                                   ref[f"{rkey}/aux"], rtol=2e-6)
        for n in names:
            got, want = _grads_whole(res, key, shape, n), \
                ref[f"{rkey}/grad/{n}"]
            if n == "router/w" and top1:
                assert np.abs(got - want).max() <= \
                    1e-4 * np.abs(want).max() + 2 * noise, (name, n)
            else:
                assert _rel(got, want) < 1e-4, (name, n)


@pytest.mark.parametrize("shape", MOE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_ep_gradients_replicated_and_global(world, arch, shape):
    """The gradient trap: after backward, the router's and the shared
    experts' gradients and the input's are identical on every 'model'
    rank of a data group; with the expert slices put together and the data
    ranks summed, the gradients of ``sum(out * ct)`` at no drop are the
    one-rank ``moe_apply``'s. The reference's own EP gradient equals its
    global path's there too."""
    res, ref = _by(world["pools"][shape], shape), world["ref"]
    nd, nm = shape
    cfg = ranks.variant(arch, "nodrop")
    inputs = np.load(world["tmp"] / "inputs.npz")
    p = ranks.tree_from(inputs, f"moe/{arch}/p", tmoe.moe_spec(cfg))
    p = tcm.tree_map(lambda t: t.requires_grad_(True), p)
    x = torch.as_tensor(inputs[f"moe/{arch}/x"]).requires_grad_(True)
    y, _ = tmoe.moe_apply(p, x, cfg)
    torch.sum(y * torch.as_tensor(inputs[f"moe/{arch}/ct"])).backward()
    key = f"moe/{arch}/nodrop_out"
    for d in range(nd):
        for k, v in res[(d, 0)].items():
            if k.startswith(key) and "/experts/" not in k and "/out" not in k:
                for m in range(1, nm):
                    np.testing.assert_array_equal(res[(d, m)][k], v, k)
    out = np.concatenate([res[(d, 0)][f"{key}/out"] for d in range(nd)])
    assert _rel(out, y.detach().numpy()) < 1e-4
    gx = np.concatenate([res[(d, 0)][f"{key}/gx"] for d in range(nd)])
    assert _rel(gx, x.grad.numpy()) < 1e-4
    for n, leaf in tcm.tree_items(p):
        got = _grads_whole(res, key, shape, n)
        rkey = f"moe/{arch}/{shape[0]}x{shape[1]}/nodrop_out/grad/{n}"
        if n == "router/w" and cfg.moe.top_k == 1:
            # 0 in exact arithmetic (the gate p / p): rounding noise in all
            scale = 1e-4 * float(np.abs(x.grad.numpy()).max())
            for g in (got, leaf.grad.numpy(), ref[rkey]):
                assert np.abs(g).max() < scale
            continue
        assert _rel(got, leaf.grad.numpy()) < 1e-4, n
        assert _rel(ref[rkey], ref[f"moe/{arch}/global/grad/{n}"]) < 1e-4, n


# ------------------------------------------------------------ PowerSGD

@pytest.mark.parametrize("nd", [2, 4])
def test_powersgd_over_the_data_axis_matches_reference(world, nd):
    """Three steps of ``compress_decompress(axis_name="data")`` on each
    data rank's own gradients against the reference's under
    ``shard_map``: every rank's ghat and error within 1e-4 of the leaf's
    gradient max, and its Q (column signs fixed) within 1e-4."""
    from test_torch_nestedness import _sign_fixed
    pool = world["pools"][(nd, 1)]
    ref = world["ref"]
    inputs = np.load(world["tmp"] / "inputs.npz")
    for step in range(3):
        for r, res in enumerate(pool):
            for k in [k for k in res if k.startswith(f"psgd/{step}/g/")]:
                path = k.split("/", 3)[3]
                scale = max(float(np.abs(inputs[f"psgd/s{step}r{q}/{path}"])
                                  .max()) for q in range(nd))
                rk = f"psgd{nd}/{step}/r{r}"
                assert np.abs(res[k] - ref[f"{rk}/g/{path}"]).max() \
                    < 1e-4 * scale, (step, r, path)
                e, q = (res[f"psgd/{step}/{w}/{path}"] for w in "eq")
                if e.size:
                    assert np.abs(e - ref[f"{rk}/e/{path}"]).max() \
                        < 1e-4 * scale, (step, r, path)
                    assert _rel(_sign_fixed(q), _sign_fixed(
                        ref[f"{rk}/q/{path}"])) < 1e-4, (step, r, path)
            # the mean is the same on every rank
            for k in res:
                if k.startswith(f"psgd/{step}/g/"):
                    np.testing.assert_array_equal(res[k], pool[0][k])


# ------------------------------------------------------------ launcher

def test_dims_of_another_tree_raise():
    """A tree cut with dims worked out from another tree's spec (the
    factorized spec's for the dense teacher) raises instead of pairing
    leaves by position."""
    cfg = tget("deepseek-moe-16b", smoke=True)
    mesh = _mesh((1, 1), ("data", "model"))
    fspec = TFR.factorized_spec(cfg)
    dims = tdist.model_dims(mesh, tcm.axes_tree(fspec), fspec)
    dense = ttrain.dense_init(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="another tree"):
        tdist.shard_tree(dense, dims, mesh)
    own = tdist.model_dims(mesh, tcm.axes_tree(ttfm.model_spec(cfg)),
                           dense)
    assert tdist.shard_tree(dense, own, mesh) is not None


@pytest.mark.parametrize("cards,want", [
    (["GPU-a", "GPU-b"], "nccl"), (["GPU-a"], "nccl"),
    (["GPU-a", "GPU-a"], "gloo"), (["GPU-a", "GPU-b", "GPU-a"], "gloo"),
    ([None, None], "gloo"), (["GPU-a", None], "gloo")],
    ids=["own-cards", "one-card", "shared", "two-share", "cpu", "mixed"])
def test_backend_needs_a_card_a_rank(cards, want):
    """NCCL only where every rank's card (by its UUID, whatever each rank's
    visible devices number it) is its own."""
    assert tdist.backend_for(cards) == want


def test_launcher_names_its_backend(monkeypatch, capsys):
    """The launcher started from ``torchrun``'s environment, a world of
    one on the CPU: gloo, named on the ``[mesh]`` line, and torn down."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    try:
        _, losses = ttrain.main(["--arch", "gpt2-small", "--smoke",
                                 "--device", "cpu", "--steps", "1",
                                 "--seq-len", "16", "--batch", "2",
                                 "--mode", "dense", "--mesh-shape", "1,1"])
    finally:
        tdist.shutdown_world()
    assert len(losses) == 1 and not tdist.in_world()
    out = capsys.readouterr().out
    assert "[mesh] 1,1 -> {'data': 1, 'model': 1} on cpu, gloo" in out, out


# ---------------------------------------------------------- placements

def _mesh(shape, names):
    return tdist.Mesh(tdist.device_array(["cpu"] * int(np.prod(shape)),
                                         shape), names)


def _norm(spec):
    return [None if e is None else list(e) for e in spec]


MESH_NAMES = {"2x2": ((2, 2), ("data", "model")),
              "1x4": ((1, 4), ("data", "model")),
              "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.mark.parametrize("key", list(MESH_NAMES))
def test_placements_match_reference(world, key):
    """``logical_to_spec``, ``batch_spec``, ``seq_sharded_cache``,
    ``replicated`` and ``param_shardings`` (plain, with shapes, with
    ``fsdp``) against the reference's ``PartitionSpec``s on the same
    mesh, for the smoke and full configs, dense and factorized."""
    from repro_torch.distributed import sharding as TS
    specs = world["specs"]
    mesh = _mesh(*MESH_NAMES[key])
    axes = [("batch", "seq", "heads"), ("batch", None, "mlp"),
            ("layers", "experts", "embed", "mlp"), ("embed", "rank"),
            ("vocab", "embed"), ("seq", "kv_heads", "sp"), ("rank", "mlp")]
    assert [_norm(tdist.logical_to_spec(mesh, a)) for a in axes] == \
        specs[f"{key}/logical"]
    assert [_norm(tdist.batch_spec(mesh, extra_dims=k)) for k in (1, 2)] \
        == specs[f"{key}/batch"]
    assert _norm(tdist.seq_sharded_cache(mesh, time_axis=2, ndim=5)) == \
        specs[f"{key}/seq_cache"]
    assert _norm(tdist.replicated(mesh)) == specs[f"{key}/replicated"]
    for arch in ARCHS:
        for smoke in (True, False):
            cfg = tget(arch, smoke=smoke)
            for kind, spec in (("dense", ttfm.model_spec(cfg)),
                               ("fact", TFR.factorized_spec(cfg))):
                ax = tcm.axes_tree(spec)
                for tag, kw in (("plain", {}), ("shapes", dict(shapes=spec)),
                                ("fsdp", dict(shapes=spec, fsdp=True))):
                    got = [[p, _norm(s)] for p, s in tcm.tree_items(
                        tdist.param_shardings(mesh, ax, **kw),
                        is_leaf=TS.is_placement)]
                    assert got == specs[
                        f"{key}/{arch}/{smoke}/{kind}/{tag}"], (arch, kind,
                                                                 tag)


# ---------------------------------------------------------- cost model

@pytest.mark.parametrize("mesh_shape", [
    {"data": 2, "model": 2}, {"data": 16, "model": 16},
    {"pod": 2, "data": 16, "model": 16}], ids=["2x2", "16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS + ["gpt2-small"])
def test_memory_traffic_matches_reference_on_meshes(arch, mesh_shape):
    """Every component of a train, a prefill and a decode step on one
    device of the mesh, exactly the reference's."""
    for kind, seq, batch in (("train", 4096, 256), ("prefill", 2048, 32),
                             ("decode", 2048, 64)):
        j = jtraffic(jget(arch), JShape("x", seq, batch, kind),
                     mesh_shape=mesh_shape)
        t = ttraffic(tget(arch), TShape("x", seq, batch, kind),
                     mesh_shape=mesh_shape)
        assert t == j and list(t) == list(j), kind


@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_production_mesh_needs_its_ranks(multi_pod):
    """The reference's (16, 16) and (2, 16, 16) meshes: with one device
    (no world) both packages raise ``ValueError``."""
    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh as tmesh
    with pytest.raises(ValueError, match="must be >= the product"):
        jmesh.make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(ValueError, match="must be >= the product"):
        tmesh.make_production_mesh(multi_pod=multi_pod)
