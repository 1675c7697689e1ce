"""The port's training modes against the JAX package's, on the CPU at the
smoke configs: ``launch/specs.py:make_train_step`` in the ``dense`` and
``flexrank`` modes for three families, activation checkpointing
(``remat_blocks``), Muon, and the launcher's every ``--mode`` x
``--optimizer``.

Tolerances, float32 throughout: a train step's loss 1e-5 relative (the
same products in other orders, through 2 layers); the parameters after 3
AdamW steps 2e-3 of each leaf's max (an entry whose gradient is rounding
noise around zero gets Adam's normalised step of either sign, up to the
learning rate a step); Newton-Schulz 1e-5 of the output's max (5
iterations of float32 products); Muon's parameters, momenta and AdamW
moments after 3 steps 1e-5 of each leaf's max. Remat against no remat is
bit for bit: the same operations recomputed.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import data as jdata
from repro.configs import get_config
from repro.core import flexrank as JFR
from repro.launch import specs as JSP
from repro.models import common as jcm
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.optim import muon as jmuon
from repro_torch import bridge, threefry
from repro_torch.configs import get_config as tget
from repro_torch.core import distill as tdistill
from repro_torch.launch import specs as TSP
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcm
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import muon as tmuon

torch.set_num_threads(1)

SEQ, BATCH = 32, 2
ARCHS = ["gpt2-small", "rwkv6-3b", "zamba2-7b"]


def _leaf_rel(a, b) -> float:
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-12)


def draw_tree(spec, seed: int):
    """Numpy weights over a JAX spec tree, scaled as ``instantiate``
    scales them (normal leaves N(0, 1/fan_in), ones kept); the leaves
    initialised to zeros are drawn from 0.2 x N(0, 1), so that every
    leaf's gradient counts."""
    rng = np.random.default_rng(seed)

    def draw(s):
        if s.init == "ones":
            return np.ones(s.shape, np.float32)
        scale = 0.2 if s.init == "zeros" else 1.0 / np.sqrt(
            s.shape[-2] if len(s.shape) >= 2 else s.shape[-1])
        return (scale * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree.map(draw, spec, is_leaf=jcm.is_spec)


def _params(arch, mode, seed=0):
    cfg = get_config(arch, smoke=True)
    spec = (jtfm.model_spec(cfg) if mode == "dense"
            else JFR.factorized_spec(cfg))
    npp = draw_tree(spec, seed)
    return (cfg, tget(arch, smoke=True), jax.tree.map(jnp.asarray, npp),
            tcm.tree_map(lambda t: t.requires_grad_(True),
                         bridge.params_to_torch(npp)))


# ------------------------------------------------------ make_train_step

@pytest.mark.parametrize("mode", ["dense", "flexrank"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_train_step_matches_jax(arch, mode):
    """Three steps of each package's ``make_train_step`` (under remat in
    both) from the same weights, batches and keys."""
    cfg, tcfg, pj, pt = _params(arch, mode)
    src = jdata.make_source(cfg.vocab_size, SEQ, BATCH, seed=0)
    opt_j = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    opt_t = tadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    step_j = jax.jit(JSP.make_train_step(cfg, opt_j, mode=mode))
    step_t = TSP.make_train_step(tcfg, opt_t, mode=mode)
    sj, st = jadamw.init(pj), tadamw.init(pt)
    for step in range(3):
        tokens = src.batch_at(step)["tokens"]
        pj, sj, mj = step_j(pj, sj, {"tokens": jnp.asarray(tokens)},
                            jax.random.fold_in(jax.random.PRNGKey(1), step))
        pt, st, mt = step_t(pt, st, {"tokens": torch.as_tensor(tokens)},
                            threefry.fold_in(threefry.prng_key(1), step))
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=1e-5)
    assert st.step == int(sj.step) == 3
    for (path, a), b in zip(tcm.tree_items(pt), jax.tree.leaves(pj)):
        assert _leaf_rel(a, b) < 2e-3, path


def test_flexrank_mode_draws_rows_of_the_uniform_table():
    """``--mode flexrank``'s table is ``uniform_table`` over the first 7
    budgets, the JAX package's, and a step's row is the reference's
    ``randint``."""
    from repro.core import profiles as jprof
    from repro_torch.core import flexrank as TFR
    from repro_torch.core import profiles as tprof
    cfg, tcfg = get_config("gpt2-small"), tget("gpt2-small")
    infos_j, infos_t = JFR.group_infos(cfg), TFR.group_infos(tcfg)
    args = ([i.path for i in infos_j], [i.full_rank for i in infos_j],
            cfg.flexrank.budgets[:7])
    tj, tt = jprof.uniform_table(*args), tprof.uniform_table(*args)
    np.testing.assert_array_equal(tt.table, tj.table)
    assert tt.budgets == tj.budgets and tt.max_ranks == tj.max_ranks
    assert [i.path for i in infos_t] == args[0]
    for step in range(20):
        key = jax.random.fold_in(jax.random.PRNGKey(1), step)
        assert TFR.budget_draw(threefry.fold_in(threefry.prng_key(1), step),
                               7) == int(jax.random.randint(key, (), 0, 7))


# ---------------------------------------------------------------- remat

def _loss_and_grads(cfg, params, tokens, mode, remat, frontend=None):
    for p in tcm.tree_leaves(params):
        p.grad = None
    ranks = None
    if mode == "flexrank":
        from repro_torch.core import flexrank as TFR
        infos = TFR.group_infos(cfg)
        rows = np.stack([np.asarray([max(1, i.full_rank // 2)
                                     for i in infos], np.int32)])
        ranks = TFR.ranks_tree(cfg, infos, rows, 0)
    ctx = ttfm.remat_blocks() if remat else torch.enable_grad()
    with ctx:
        logits, aux = ttfm.forward(params, cfg, tokens[:, :-1], ranks=ranks,
                                   frontend=frontend)
        loss = tdistill.cross_entropy(logits, tokens[:, 1:]) + aux
        loss.backward()
    return loss.detach(), [torch.zeros(()) if p.grad is None else
                           p.grad.clone() for p in tcm.tree_leaves(params)]


@pytest.mark.parametrize("arch,mode", [
    ("gpt2-small", "dense"), ("gpt2-small", "flexrank"),
    ("rwkv6-3b", "flexrank"), ("zamba2-7b", "dense"),
    ("zamba2-7b", "flexrank"), ("deepseek-moe-16b", "dense"),
    ("seamless-m4t-medium", "flexrank"),
    ("llama-3.2-vision-11b", "dense")])
def test_remat_changes_no_value_or_gradient(arch, mode):
    """Every layer body (a zamba unit's and its Mamba2 layers', a vision
    unit's and its self blocks', the encoder's) through ``checkpoint``:
    the loss and every gradient bit for bit those without it."""
    cfg, tcfg, _, pt = _params(arch, mode)
    tokens = torch.as_tensor(jdata.make_source(
        cfg.vocab_size, SEQ, BATCH, seed=0).batch_at(0)["tokens"])
    frontend = None
    if tcfg.family in ("audio", "vlm"):
        frontend = torch.as_tensor(np.random.default_rng(1).standard_normal(
            (BATCH, 16, tcfg.frontend_dim)).astype(np.float32))
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(fn, *a, **kw):
        calls.append(fn.__name__)
        return real(fn, *a, **kw)
    torch.utils.checkpoint.checkpoint = counting
    try:
        l1, g1 = _loss_and_grads(tcfg, pt, tokens, mode, True, frontend)
    finally:
        torch.utils.checkpoint.checkpoint = real
    l0, g0 = _loss_and_grads(tcfg, pt, tokens, mode, False, frontend)
    assert calls, "remat_blocks checkpointed no layer body"
    if arch == "zamba2-7b":
        assert "unit" in calls and "mamba_layer" in calls
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# ----------------------------------------------------------------- muon

@pytest.mark.parametrize("shape", [(24, 16), (16, 24), (3, 12, 20),
                                   (2, 2, 20, 12)])
def test_newton_schulz_matches_jax(shape):
    """A matrix, tall or wide, as the reference's ``newton_schulz``; a
    stack slice by slice, as its ``vmap`` over the slices."""
    g = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    out = tmuon.newton_schulz(torch.as_tensor(g)).numpy()
    flat = jnp.asarray(g.reshape((-1,) + shape[-2:]))
    ref = np.asarray(jax.vmap(jmuon.newton_schulz)(flat)).reshape(shape)
    assert _leaf_rel(out, ref) < 1e-5


def _muon_tree(rng):
    """Stacked matrices, an embedding-like table, vectors, a scalar."""
    def n(*s):
        return (0.1 * rng.standard_normal(s)).astype(np.float32)
    return {"embed": n(96, 16), "final_norm": n(16),
            "segments": [{"attn": {"q": {"u": n(2, 16, 8), "v": n(2, 16, 8)},
                                   "w": n(2, 16, 32)},
                          "ln": n(2, 16)}],
            "experts": n(2, 3, 8, 12), "gate": n()}


def test_muon_three_steps_match_jax():
    rng = np.random.default_rng(0)
    params = _muon_tree(rng)
    grads = [_muon_tree(rng) for _ in range(3)]
    cfg_j = jmuon.MuonConfig(lr=1e-2, adamw=jadamw.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=3))
    cfg_t = tmuon.MuonConfig(lr=1e-2, adamw=tadamw.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=3))
    pj = jax.tree.map(jnp.asarray, params)
    pt = bridge.params_to_torch(params)
    sj, st = jmuon.init(pj, cfg_j), tmuon.init(pt, cfg_t)
    assert [tuple(m.shape) for m in tcm.tree_leaves(st.momentum)] == [
        m.shape for m in jax.tree.leaves(sj.momentum)]
    step_j = jax.jit(lambda p, g, s: jmuon.apply_updates(p, g, s, cfg_j))
    for g in grads:
        pj, sj, _ = step_j(pj, jax.tree.map(jnp.asarray, g), sj)
        pt, st, _ = tmuon.apply_updates(pt, bridge.params_to_torch(g), st,
                                        cfg_t)
    assert st.step == int(sj.step) == 3
    assert st.adamw_state.step == int(sj.adamw_state.step) == 3
    for tree_t, tree_j in ((pt, pj), (st.momentum, sj.momentum),
                           (st.adamw_state.mu, sj.adamw_state.mu),
                           (st.adamw_state.nu, sj.adamw_state.nu)):
        for (path, a), b in zip(tcm.tree_items(tree_t),
                                jax.tree.leaves(tree_j)):
            assert tuple(a.shape) == b.shape, path
            if a.numel():
                assert _leaf_rel(a, b) < 1e-5, path


def test_muon_overwrites_matrices_from_the_pre_update_value():
    """The port's AdamW writes in place, yet a matrix leaf moves by Muon's
    step from its value before the AdamW pass, and its AdamW moments
    advance (clipped by the norm of every gradient)."""
    rng = np.random.default_rng(3)
    pt = bridge.params_to_torch(_muon_tree(rng))
    g = bridge.params_to_torch(_muon_tree(rng))
    before = tcm.tree_map(lambda t: t.clone(), pt)
    cfg = tmuon.MuonConfig(lr=1e-2, nesterov=False, adamw=tadamw.AdamWConfig(
        lr=1e-3, warmup_steps=1, weight_decay=0.0, clip_norm=None))
    st = tmuon.init(pt, cfg)
    pt, st, _ = tmuon.apply_updates(pt, g, st, cfg)
    w0, gw = before["segments"][0]["attn"]["w"], g["segments"][0]["attn"]["w"]
    # slices of 16 x 32: scale sqrt(max(1, 16 / 32)) = 1
    o = tmuon.newton_schulz(gw)
    torch.testing.assert_close(pt["segments"][0]["attn"]["w"],
                               w0 - o * float(np.float32(1e-2)), rtol=0,
                               atol=1e-7)
    torch.testing.assert_close(st.adamw_state.mu["segments"][0]["attn"]["w"],
                               0.1 * gw, rtol=1e-6, atol=0)


# ------------------------------------------------------------- launcher

@pytest.mark.parametrize("optimizer", ["adamw", "muon"])
@pytest.mark.parametrize("mode", ["dense", "flexrank", "flexrank_kd"])
def test_launcher_every_mode_and_optimizer(mode, optimizer, capsys):
    params, losses = ttrain.main([
        "--smoke", "--device", "cpu", "--steps", "3", "--seq-len", "16",
        "--batch", "2", "--mode", mode, "--optimizer", optimizer])
    assert len(losses) == 3 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert f"# training: {mode}, {optimizer}, 3 steps" in out
    assert ("[elastic eval]" in out) == mode.startswith("flexrank")
    factorized = "u" in params["segments"][0]["attn"]["q"]
    assert factorized == mode.startswith("flexrank")


def test_launcher_grad_compress_changes_no_step(capsys):
    """``--grad-compress`` is parsed and never read by the reference: one
    line says so, and the losses are those of the run without it."""
    args = ["--smoke", "--device", "cpu", "--steps", "2", "--seq-len", "16",
            "--batch", "2"]
    _, plain = ttrain.main(args)
    capsys.readouterr()
    _, compressed = ttrain.main(args + ["--grad-compress"])
    out = capsys.readouterr().out
    assert out.count("[grad-compress]") == 1
    assert "parsed and not read" in out and "uncompressed" in out
    assert compressed == plain
