"""The port's training slice against the JAX package's, on the CPU, at the
smoke config (gpt2 smoke, seq 32, batch 2): data, budget draws, taps and
moments, DataSVD decomposition and the profile table, the contiguous
forward at every budget row, the consolidation loss and its gradients,
AdamW, four steps of the training loop, and the serving launcher's state.

Exact where the arithmetic is integer or a copy (batches, budget draws,
tap keys, tables, bridged states). Tolerances, float32 throughout:
moments 1e-5 of their max (one sum of 512 rows in another order); curves
1e-3 of their max (eigh and SVD of two LAPACK call paths, then squared
twice); logits and losses 1e-4 relative, gradients 1e-3 of each leaf's max
(two frameworks' matmuls and softmaxes, through 2 layers and back);
AdamW 1e-5 relative, as its only difference is the rounding of a few
float32 operations; four training steps 1e-3 relative on the losses (the
rounding differences pass through Adam's normalization).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import data as jdata
from repro.configs import get_config
from repro.core import flexrank as JFR
from repro.models import common as jcm
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro_torch import bridge, threefry
from repro_torch import data as tdata
from repro_torch.configs import get_config as tget
from repro_torch.core import flexrank as TFR
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcm
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw as tadamw

torch.set_num_threads(1)

SEQ, BATCH = 32, 2


def _rel(a, b) -> float:
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-12)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def st():
    """JAX dense weights; both packages calibrate, decompose and DP-select
    from them (the port from the bridged copy)."""
    cfg = get_config("gpt2-small", smoke=True)
    tcfg = tget("gpt2-small", smoke=True)
    src_j = jdata.make_source(cfg.vocab_size, SEQ, BATCH, seed=0)
    src_t = tdata.make_source(tcfg.vocab_size, SEQ, BATCH, seed=0)
    dense = jcm.instantiate(jtfm.model_spec(cfg), jax.random.PRNGKey(0))
    dense_t = bridge.params_to_torch(_np_tree(dense))
    mom_j = JFR.collect_moments(dense, cfg,
                                jdata.calibration_batches(src_j, 8))
    mom_t = TFR.collect_moments(dense_t, tcfg,
                                tdata.calibration_batches(src_t, 8))
    fact_j, curves_j = JFR.decompose(dense, cfg, mom_j)
    fact_t, curves_t = TFR.decompose(dense_t, tcfg, mom_t)
    table_j, infos_j = JFR.build_table(cfg, curves_j)
    table_t, infos_t = TFR.build_table(tcfg, curves_t)
    return dict(cfg=cfg, tcfg=tcfg, src_j=src_j, src_t=src_t, dense=dense,
                dense_t=dense_t, mom_j=mom_j, mom_t=mom_t, fact_j=fact_j,
                fact_t=fact_t, curves_j=curves_j, curves_t=curves_t,
                table_j=table_j, table_t=table_t, infos_j=infos_j,
                infos_t=infos_t)


# ------------------------------------------------------------------ data

def test_batches_bit_exact(tmp_path):
    for vocab, seq, batch, seed in ((512, SEQ, BATCH, 0), (50257, 16, 3, 5)):
        sj = jdata.make_source(vocab, seq, batch, seed=seed)
        stt = tdata.make_source(vocab, seq, batch, seed=seed)
        for step in (0, 1, 7, 10_000):
            np.testing.assert_array_equal(stt.batch_at(step)["tokens"],
                                          sj.batch_at(step)["tokens"])
    path = tmp_path / "tokens.bin"
    np.random.default_rng(3).integers(0, 1000, 4096).astype(
        np.uint16).tofile(path)
    mj = jdata.make_source(1000, 20, 4, seed=2, path=str(path))
    mt = tdata.make_source(1000, 20, 4, seed=2, path=str(path))
    for a, b in zip(tdata.calibration_batches(mt, 3),
                    jdata.calibration_batches(mj, 3)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("num_k", [7, 3, 1, 13])
def test_budget_draws_bit_exact(num_k):
    """64 steps of the training loop's draw, ``randint(fold_in(
    PRNGKey(seed + 1), step), (), 0, K)``."""
    seed = 4
    base = jax.random.PRNGKey(seed + 1)
    want = [int(jax.random.randint(jax.random.fold_in(base, s), (), 0,
                                   num_k)) for s in range(64)]
    key = threefry.prng_key(seed + 1)
    got = [TFR.budget_draw(threefry.fold_in(key, s), num_k)
           for s in range(64)]
    assert got == want


# ----------------------------------------------------- taps and DataSVD

def test_tap_keys_and_moments(st):
    assert sorted(st["mom_t"]) == sorted(st["mom_j"])
    assert "segments/0/@0/attn/q" in st["mom_t"]
    for key, (m_j, c_j) in st["mom_j"].items():
        m_t, c_t = st["mom_t"][key]
        assert c_t == c_j == BATCH * SEQ * 8
        assert _rel(m_t, m_j) < 1e-5, key
    back = bridge.moments_to_numpy(bridge.moments_to_torch(st["mom_j"]))
    for key, (m, c) in st["mom_j"].items():
        np.testing.assert_array_equal(back[key][0], m)
        assert back[key][1] == c


def test_curves_close_and_table_identical(st):
    assert sorted(st["curves_t"]) == sorted(st["curves_j"])
    for path, c_j in st["curves_j"].items():
        assert _rel(st["curves_t"][path], c_j) < 1e-3, path
    tj, tt = st["table_j"], st["table_t"]
    np.testing.assert_array_equal(tt.table, tj.table)
    assert (tt.layer_names, tt.budgets, tt.max_ranks) == \
        (tj.layer_names, tj.budgets, tj.max_ranks)
    assert st["infos_t"] == bridge.group_infos(st["infos_j"])


def test_factors_agree_through_truncations(st):
    """Sign- and rotation-free comparison of the DataSVD factors: the
    truncated products ``u_r v_r^T`` at the smallest row's ranks and at
    full rank."""
    for info in st["infos_t"]:
        lj = jcm.tree_get(st["fact_j"], info.path)
        lt = tcm.tree_get(st["fact_t"], info.path)
        for r in (int(st["table_t"].table[0][info.col]), info.full_rank):
            u_j, v_j = np.asarray(lj["u"])[0], np.asarray(lj["v"])[0]
            w_j = u_j[:, :r] @ v_j[:, :r].T
            w_t = lt["u"][0, :, :r] @ lt["v"][0, :, :r].T
            assert _rel(w_t, w_j) < 1e-3, (info.path, r)


# --------------------------------------------------------------- forward

def test_forward_logits_every_row(st):
    """The contiguous forward of the JAX factors (bridged) at every budget
    row, and of the dense weights."""
    cfg, tcfg = st["cfg"], st["tcfg"]
    fact_t = bridge.params_to_torch(_np_tree(st["fact_j"]))
    tokens = st["src_j"].batch_at(3)["tokens"][:, :-1]
    tdev_j = JFR.table_device(st["table_j"])
    tdev_t = TFR.table_host(st["table_t"])
    fwd_j = jax.jit(lambda p, k: jtfm.forward(
        p, cfg, jnp.asarray(tokens),
        ranks=JFR.ranks_tree(cfg, st["infos_j"], tdev_j, k))[0])
    for k in range(tdev_t.shape[0]):
        l_j = fwd_j(st["fact_j"], jnp.asarray(k))
        l_t, aux = ttfm.forward(fact_t, tcfg, torch.as_tensor(tokens),
                                ranks=TFR.ranks_tree(tcfg, st["infos_t"],
                                                     tdev_t, k))
        assert l_t.shape == (BATCH, SEQ, tcfg.vocab_size)
        assert _rel(l_t, l_j) < 1e-4, k
        assert float(aux) == 0.0
    l_j, _ = jtfm.forward(st["dense"], cfg, jnp.asarray(tokens))
    l_t, _ = ttfm.forward(st["dense_t"], tcfg, torch.as_tensor(tokens))
    assert _rel(l_t, l_j) < 1e-4


def test_forward_raises_on_unported_branches():
    """Both branches that once raised are ported. Cross-attention: over a
    source of 7 positions it gives what the source's cached K/V
    (``compute_cross_kv``) give at one query token. The decode cache: a
    prompt through an empty cache gives the cacheless output and advances
    ``idx``."""
    from repro_torch.models import attention as tattn
    tcfg = tget("gpt2-small", smoke=True)
    p = tcm.instantiate(tattn.attn_spec(tcfg),
                        torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    src = torch.randn(2, 7, tcfg.d_model, generator=torch.Generator()
                      .manual_seed(2))
    cross = dict(positions=torch.arange(1), window=1 << 30, causal=False,
                 use_rope=False)
    y_src, c_src = tattn.attn_apply(p, x[:, :1], tcfg, kv_source=src,
                                    **cross)
    y_kv, _ = tattn.attn_apply(p, x[:, :1], tcfg,
                               static_kv=tattn.compute_cross_kv(p, tcfg, src),
                               **cross)
    assert c_src is None and y_src.shape == (2, 1, tcfg.d_model)
    assert float((y_kv - y_src).abs().max()) < 1e-5 * float(
        y_src.abs().max())
    pos = torch.arange(5)
    y, _ = tattn.attn_apply(p, x, tcfg, positions=pos, window=1 << 30)
    cache = tcm.tree_map(lambda a: a[0] if isinstance(a, torch.Tensor)
                         else a, tattn.init_kv_cache(
                             tcfg, 2, 8, dtype=torch.float32))
    y_c, new = tattn.attn_apply(p, x, tcfg, positions=pos, window=1 << 30,
                                cache=cache)
    assert new["idx"] == 5 and not new["k"][:, 5:].any()
    assert float((y_c - y).abs().max()) < 1e-5 * float(y.abs().max())


# ------------------------------------------------- loss, grads, AdamW

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kd_weight,temperature", [(1.0, 1.0), (0.7, 2.0)])
def test_distill_losses_match_jax(masked, kd_weight, temperature):
    from repro.core import distill as jd
    from repro_torch.core import distill as td
    rng = np.random.default_rng(int(masked) + int(10 * kd_weight))
    s, t = (rng.standard_normal((2, 5, 40)).astype(np.float32) * 3
            for _ in range(2))
    labels = rng.integers(0, 40, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32) if masked else None
    feats = [rng.standard_normal((2, 5, 8)).astype(np.float32)
             for _ in range(2)]

    def both(name, *args, **kw):
        kw_j = {k: (None if v is None else jnp.asarray(v))
                if k == "mask" else v for k, v in kw.items()}
        kw_t = {k: (None if v is None else torch.as_tensor(v))
                if k == "mask" else v for k, v in kw.items()}
        return (float(getattr(td, name)(*map(torch.as_tensor, args), **kw_t)),
                float(getattr(jd, name)(*map(jnp.asarray, args), **kw_j)))

    pairs = [both("consolidation_loss", s, t, labels, kd_weight=kd_weight,
                  temperature=temperature, mask=mask),
             both("kl_distill", s, t, temperature=temperature, mask=mask),
             both("cross_entropy", s, labels, mask=mask),
             both("feature_match", *feats, mask=mask)]
    for got, want in pairs:
        assert got == pytest.approx(want, rel=1e-5)

def _key_for_row(k: int, num_k: int) -> int:
    """A seed whose ``PRNGKey`` draws budget row ``k``."""
    return next(i for i in range(1000)
                if TFR.budget_draw(threefry.prng_key(i), num_k) == k)


def test_consolidation_loss_and_grads_fixed_row(st):
    cfg, tcfg = st["cfg"], st["tcfg"]
    num_k = st["table_t"].table.shape[0]
    seed = _key_for_row(num_k // 2, num_k)
    batch = st["src_j"].batch_at(2)
    loss_j = JFR.make_consolidation_loss(cfg, st["infos_j"],
                                         JFR.table_device(st["table_j"]),
                                         st["dense"])
    (l_j, aux_j), g_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        st["fact_j"], {"tokens": jnp.asarray(batch["tokens"])},
        jax.random.PRNGKey(seed))
    params = bridge.params_to_torch(_np_tree(st["fact_j"]))
    params = tcm.tree_map(lambda t: t.requires_grad_(True), params)
    loss_t = TFR.make_consolidation_loss(tcfg, st["infos_t"],
                                         TFR.table_host(st["table_t"]),
                                         st["dense_t"])
    l_t, aux_t = loss_t(params, {"tokens": torch.as_tensor(batch["tokens"])},
                        threefry.prng_key(seed))
    l_t.backward()
    assert aux_t["budget_k"] == int(aux_j["budget_k"]) == num_k // 2
    assert abs(float(l_t.detach()) - float(l_j)) / abs(float(l_j)) < 1e-4
    flat_j = jax.tree_util.tree_flatten_with_path(g_j)[0]
    assert len(flat_j) == len(tcm.tree_leaves(params))
    for path, g in flat_j:
        leaf = params
        for p in path:
            leaf = leaf[getattr(p, "key", getattr(p, "idx", None))]
        assert _rel(leaf.grad, g) < 1e-3, jax.tree_util.keystr(path)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_matches_jax(schedule):
    cfg_j = jadamw.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=12,
                               schedule=schedule)
    cfg_t = tadamw.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=12,
                               schedule=schedule)
    for step in range(0, 15):
        want = float(jadamw.schedule_lr(cfg_j, jnp.asarray(step)))
        assert tadamw.schedule_lr(cfg_t, step) == pytest.approx(want,
                                                                rel=1e-6)


def test_adamw_three_steps_match_jax(st):
    """Three updates from the same gradients, warmup then cosine decay,
    clipping active; the decayed leaves include the (1, d) stacked norm
    scales, as in the reference."""
    params_np = _np_tree(st["fact_j"])
    rng = np.random.default_rng(5)
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05)
                          .astype(np.float32), params_np) for _ in range(3)]
    cfg_j = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    cfg_t = tadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    p_j, s_j = jax.tree.map(jnp.asarray, params_np), jadamw.init(params_np)
    p_t = bridge.params_to_torch(params_np)
    s_t = tadamw.init(p_t)
    update_j = jax.jit(lambda p, g, s: jadamw.apply_updates(p, g, s, cfg_j))
    for g in grads:
        p_j, s_j, m_j = update_j(p_j, jax.tree.map(jnp.asarray, g), s_j)
        p_t, s_t, m_t = tadamw.apply_updates(p_t, bridge.params_to_torch(g),
                                             s_t, cfg_t)
        assert float(m_t["grad_norm"]) == pytest.approx(
            float(m_j["grad_norm"]), rel=1e-5)
    assert s_t.step == int(s_j.step) == 3
    for tree_t, tree_j in ((p_t, p_j), (s_t.mu, s_j.mu), (s_t.nu, s_j.nu)):
        for a, b in zip(tcm.tree_leaves(tree_t), jax.tree.leaves(tree_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)
    ln = tcm.tree_get(p_t, "segments/0/ln_attn")
    assert ln.shape == (1, st["tcfg"].d_model) and ln.abs().max() > 0
    step, mu, nu = bridge.adamw_state_to_numpy(s_t)
    back = bridge.adamw_state_to_torch(jadamw.AdamWState(step, mu, nu))
    assert back.step == 3
    for a, b in zip(tcm.tree_leaves(back.nu), tcm.tree_leaves(s_t.nu)):
        assert torch.equal(a, b)


# ----------------------------------------------------------- the loop

def _jax_loop(cfg, dense, state, source, steps, lr, seed):
    """``repro.launch.train.main``'s flexrank_kd loop, fed ``dense`` and
    the state ``build_flexrank_state`` made from it and ``source``."""
    params, table, infos = state
    opt_cfg = jadamw.AdamWConfig(lr=lr, warmup_steps=min(100, steps // 10 + 1),
                                 total_steps=steps)
    opt_state = jadamw.init(params)
    loss_fn = JFR.make_consolidation_loss(cfg, infos, JFR.table_device(table),
                                          dense)

    @jax.jit
    def step_fn(params, opt_state, batch, rng):
        (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, batch, rng)
        params, opt_state, _ = jadamw.apply_updates(params, grads, opt_state,
                                                    opt_cfg)
        return params, opt_state, metrics

    losses, rows = [], []
    for step in range(steps):
        batch = {"tokens": jnp.asarray(source.batch_at(step)["tokens"])}
        rng = jax.random.fold_in(jax.random.PRNGKey(seed + 1), step)
        params, opt_state, metrics = step_fn(params, opt_state, batch, rng)
        losses.append(float(metrics["loss"]))
        rows.append(int(metrics["budget_k"]))
    return losses, rows


def test_four_steps_match_reference_loop(st):
    losses_j, rows_j = _jax_loop(
        st["cfg"], st["dense"], (st["fact_j"], st["table_j"], st["infos_j"]),
        st["src_j"], 4, 1e-3, 0)
    res = ttrain.run(st["tcfg"], st["dense_t"], st["src_t"], steps=4,
                     lr=1e-3, seed=0, log=lambda s: None)
    assert res.budget_rows == rows_j
    np.testing.assert_allclose(res.losses, losses_j, rtol=1e-3)
    assert all(np.isfinite(res.eval_after))


def test_launcher_cli_and_unported_flags(tmp_path):
    """The launcher at the smoke config: the reference's default mode
    (dense), then every flag. ``--mesh-shape`` holds the reference's
    behaviour on one device: ``4,1`` shrinks to 1 x 1 and trains, ``2,2``
    fails the reference's assertion (it raised ``NotImplementedError``
    before the one-device mesh was ported)."""
    base = ["--smoke", "--device", "cpu", "--steps", "2", "--seq-len", "16",
            "--batch", "2"]
    params, losses = ttrain.main(base)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "w" in params["segments"][0]["attn"]["q"]        # dense
    for flags in (["--mode", "flexrank_kd"], ["--mode", "flexrank"],
                  ["--optimizer", "muon"], ["--grad-compress"],
                  ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "1"],
                  ["--mesh-shape", "4,1"]):
        _, losses = ttrain.main(base + flags)
        assert len(losses) == 2 and all(np.isfinite(losses)), flags
    with pytest.raises(AssertionError,
                       match="1 devices cannot host model dim 2"):
        ttrain.main(base + ["--mesh-shape", "2,2"])


def test_serve_launcher_state_matches_jax(st):
    """The serving launchers' state builders from the same dense weights:
    ``repro.launch.serve`` calibrates on ``make_source(V, 64, 4, seed)``
    (``launch/serve.py:203-206``) and so must the port's."""
    cfg, tcfg = st["cfg"], st["tcfg"]
    source = jdata.make_source(cfg.vocab_size, 64, 4, seed=0)
    # repro.launch.train.build_flexrank_state, its stages kept apart to
    # read the curves
    moments = JFR.collect_moments(st["dense"], cfg,
                                  jdata.calibration_batches(source, 8))
    _, curves_j = JFR.decompose(st["dense"], cfg, moments)
    table_j, infos_j = JFR.build_table(cfg, curves_j)
    _, table_t, infos_t = tserve.serving_state(tcfg, st["dense_t"], 0)
    np.testing.assert_array_equal(table_t.table, table_j.table)
    assert infos_t == bridge.group_infos(infos_j)
    moments_t = TFR.collect_moments(st["dense_t"], tcfg,
                                    tdata.calibration_batches(
                                        tdata.make_source(tcfg.vocab_size,
                                                          64, 4, seed=0), 8))
    _, curves_t = TFR.decompose(st["dense_t"], tcfg, moments_t)
    for path, c in curves_j.items():
        assert _rel(curves_t[path], c) < 1e-3, path


# ------------------------------------------- test_flexrank_pipeline port

def test_consolidation_reduces_kd_loss():
    """Port of ``tests/test_flexrank_pipeline.py``'s test of the same name:
    from a (JAX-)pretrained base, 90 consolidation steps with the port's
    loss and AdamW improve the smallest submodel's eval CE."""
    from repro.launch import specs as SP
    cfg = get_config("gpt2-small", smoke=True)
    tcfg = tget("gpt2-small", smoke=True)
    src = jdata.SyntheticTokens(cfg.vocab_size, 32, 4, seed=0)
    params = jcm.instantiate(jtfm.model_spec(cfg), jax.random.PRNGKey(0))
    opt_cfg = jadamw.AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=60)
    step = jax.jit(SP.make_train_step(cfg, opt_cfg))
    opt = jadamw.init(params)
    for i in range(60):
        b = {"tokens": jnp.asarray(src.batch_at(i)["tokens"])}
        params, opt, _ = step(params, opt, b, jax.random.PRNGKey(i))
    dense = bridge.params_to_torch(_np_tree(params))
    tsrc = tdata.SyntheticTokens(tcfg.vocab_size, 32, 4, seed=0)
    fact, table, infos = ttrain.build_flexrank_state(tcfg, dense, tsrc,
                                                     calib_batches=3)
    tdev = TFR.table_host(table)
    loss_fn = TFR.make_consolidation_loss(tcfg, infos, tdev, dense)
    opt_cfg = tadamw.AdamWConfig(lr=3e-3, warmup_steps=3, total_steps=90)
    params = tcm.tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          fact)
    state = tadamw.init(params)

    def tokens(i):
        return {"tokens": torch.as_tensor(tsrc.batch_at(i)["tokens"])}

    ce_before = TFR.eval_budget_loss(params, tcfg, infos, tdev,
                                     tokens(10_000), 0)
    for i in range(90):
        params, state, _ = ttrain.train_step(params, state, loss_fn, opt_cfg,
                                             tokens(i), threefry.prng_key(i))
    ce_after = TFR.eval_budget_loss(params, tcfg, infos, tdev,
                                    tokens(10_000), 0)
    assert ce_after < ce_before, (ce_before, ce_after)
