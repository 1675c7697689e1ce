"""The port's audio encoder-decoder family (seamless-m4t-medium) against
the JAX package's, on the CPU, at the smoke config; the helpers here also
serve ``tests/test_torch_vision.py`` (llama-3.2-vision-11b).

Held for the family: the parameter and factorized specs, the groups and
the DP table; ``attn_apply`` over a source and over cached K/V, and
``compute_cross_kv``; ``run_encoder``; ``forward`` with and without a
frontend, dense and under a ``ranks`` tree; ``init_decode_state`` with
cross buffers, ``attach_cross_kv`` and the bridge's round trip of that
state; ``prefill``/``decode_step`` with the source every step and with the
cached cross K/V, against the reference and against ``forward``; the
cached prefill of S > 1 (both packages raise); ``collect_moments`` with
and without a frontend; the GAR-deployed rows' ``forward(frontend=)``; the
drain engine's streams through ``generate(mode="auto")``; the serving
launcher; one flexrank_kd consolidation step.

Weights are numpy draws bridged into both packages; the zero-initialized
leaves (norm scales) are drawn at 0.2 x N(0, 1) and every cross block's
``gate`` from U(0.5, 1.5): at its zero init ``tanh(gate)`` hides the
cross-attention output, and a check would hold nothing of it.
Tolerances, float32, relative to the reference's max: one block 1e-5 (the
same arithmetic), logits 1e-4 (a whole model), moments 1e-5, curves 1e-3,
the consolidation loss 1e-4 and its gradients 1e-3 of each leaf's max, as
in ``tests/test_torch_recurrent.py``.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import data as jdata
from repro.configs import get_config
from repro.core import flexrank as JFR
from repro.models import attention as jattn
from repro.models import common as jcm
from repro.models import transformer as jtfm
from repro_torch import bridge, threefry
from repro_torch import data as tdata
from repro_torch.configs import get_config as tget
from repro_torch.core import flexrank as TFR
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcm
from repro_torch.models import transformer as ttfm

torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
BATCH, PROMPT, STEPS, MAX_LEN = 2, 10, 4, 24
SEQ, CALIB = 16, 2
TOL_BLOCK = 1e-5
TOL_LOGITS = 1e-4
# the source's length: audio frames for the encoder; the vision config's
# own patch count
SOURCE_LEN = {"seamless-m4t-medium": 12, "llama-3.2-vision-11b": 17}
# groups of the text-only calibration that no moment covers (plain SVD):
# the cross blocks' 7 and frontend_proj, and seamless's 7 encoder groups
PLAIN_SVD = {"seamless-m4t-medium": (15, 22), "llama-3.2-vision-11b": (8, 15)}
# tap keys with and without a frontend
TAP_KEYS = {"seamless-m4t-medium": (42, 14), "llama-3.2-vision-11b": (21, 14)}


def _rel(a, b) -> float:
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-12)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cross_blocks(cfg, tree):
    """The cross blocks' subtrees of a parameter tree."""
    return [tree["segments"][i]["cross"] for i, s in enumerate(cfg.segments)
            if s.kind in ("decoder", "vision_unit")]


@functools.lru_cache(maxsize=None)
def _dense(arch):
    """(cfg, port cfg, numpy dense params): normal leaves N(0, 1/fan_in),
    zero-initialized ones 0.2 x N(0, 1), every cross ``gate`` U(0.5,
    1.5)."""
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(7)

    def draw(spec):
        scale = 0.2 if spec.init == "zeros" else 1.0 / np.sqrt(
            spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1])
        return (scale * rng.standard_normal(spec.shape)).astype(np.float32)

    dense = jax.tree.map(draw, jtfm.model_spec(cfg), is_leaf=jcm.is_spec)
    for blk in _cross_blocks(cfg, dense):
        blk["gate"] = rng.uniform(0.5, 1.5, blk["gate"].shape).astype(
            np.float32)
    return cfg, tget(arch, smoke=True), dense


def _frontend(arch, seed=11, batch=BATCH):
    cfg = get_config(arch, smoke=True)
    return np.random.default_rng(seed).standard_normal(
        (batch, SOURCE_LEN[arch], cfg.frontend_dim)).astype(np.float32)


def _tokens(arch, n=PROMPT + STEPS):
    cfg = get_config(arch, smoke=True)
    return np.random.default_rng(9).integers(
        0, cfg.vocab_size, (BATCH, n)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _state(arch):
    """Both packages calibrate text only (as the launchers do) on the
    first ``CALIB`` batches of one synthetic source, DataSVD-decompose
    and DP-select, from the same dense weights."""
    cfg, tcfg, dense = _dense(arch)
    src_j = jdata.make_source(cfg.vocab_size, SEQ, BATCH, seed=0)
    src_t = tdata.make_source(tcfg.vocab_size, SEQ, BATCH, seed=0)
    dense_j = jax.tree.map(jnp.asarray, dense)
    dense_t = bridge.params_to_torch(dense)
    mom_j = JFR.collect_moments(dense_j, cfg,
                                jdata.calibration_batches(src_j, CALIB))
    mom_t = TFR.collect_moments(dense_t, tcfg,
                                tdata.calibration_batches(src_t, CALIB))
    fact_j, curves_j = JFR.decompose(dense_j, cfg, mom_j)
    fact_t, curves_t = TFR.decompose(dense_t, tcfg, mom_t)
    table_j, infos_j = JFR.build_table(cfg, curves_j)
    table_t, infos_t = TFR.build_table(tcfg, curves_t)
    return dict(cfg=cfg, tcfg=tcfg, src_j=src_j, dense_j=dense_j,
                dense_t=dense_t, mom_j=mom_j, mom_t=mom_t, fact_j=fact_j,
                curves_j=curves_j, curves_t=curves_t, table_j=table_j,
                table_t=table_t, infos_j=infos_j, infos_t=infos_t)


def _params(arch, which):
    """Both packages' params: dense, or a budget row GAR-deployed from the
    JAX factors ("row0", "top")."""
    st = _state(arch)
    if which == "dense":
        tree = _dense(arch)[2]
    else:
        k = 0 if which == "row0" else st["table_j"].table.shape[0] - 1
        tree = _np_tree(JFR.gar_deploy(st["fact_j"], st["cfg"],
                                       st["infos_j"], st["table_j"], k))
    return jax.tree.map(jnp.asarray, tree), bridge.params_to_torch(tree)


def _source(arch, p_j, p_t, fr):
    """The decode steps' per-step source (audio: the encoder's output;
    vlm: the raw patches) and the projected source ``attach_cross_kv``
    takes, in both packages."""
    cfg, tcfg = _dense(arch)[:2]
    fr_j, fr_t = jnp.asarray(fr), torch.as_tensor(fr)
    if cfg.family == "audio":
        enc_j = jtfm.run_encoder(p_j, cfg, fr_j)
        enc_t = ttfm.run_encoder(p_t, tcfg, fr_t)
        return (enc_j, enc_t), (enc_j, enc_t)
    return (fr_j, fr_t), (jcm.linear(p_j["frontend_proj"], fr_j),
                          tcm.linear(p_t["frontend_proj"], fr_t))


# ------------------------------------------------------- shared checks

def check_specs_and_groups(arch):
    """The dense and factorized specs are the same trees of the same
    shapes; the groups are the reference's, in its order."""
    cfg, tcfg = _dense(arch)[:2]
    for j_fn, t_fn in ((jtfm.model_spec, ttfm.model_spec),
                       (JFR.factorized_spec, TFR.factorized_spec)):
        items_j = [(jax.tree_util.keystr(p), s.shape) for p, s in
                   jax.tree_util.tree_flatten_with_path(
                       j_fn(cfg), is_leaf=jcm.is_spec)[0]]
        items_t = [(jax.tree_util.keystr(p), s.shape) for p, s in
                   jax.tree_util.tree_flatten_with_path(
                       t_fn(tcfg), is_leaf=tcm.is_spec)[0]]
        assert items_t == items_j
    infos_t = TFR.group_infos(tcfg)
    assert infos_t == bridge.group_infos(JFR.group_infos(cfg))
    assert "frontend_proj" in [i.path for i in infos_t]


def check_cross_attn_apply(arch, which):
    """The first cross block's attention over a source (q from 5 tokens,
    k/v from the source, no RoPE) and over the source's cached K/V at one
    query token; ``compute_cross_kv`` (``k_norm`` applied)."""
    cfg, tcfg = _dense(arch)[:2]
    p_j, p_t = _params(arch, which)
    blk_j = jax.tree.map(lambda a: a[0], _cross_blocks(cfg, p_j)[0]["attn"])
    blk_t = tcm.tree_map(lambda a: a[0], _cross_blocks(tcfg, p_t)[0]["attn"])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((BATCH, 5, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((BATCH, SOURCE_LEN[arch], cfg.d_model)
                              ).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)
    kw_j = dict(positions=jnp.asarray(pos), window=1 << 30, causal=False,
                use_rope=False)
    kw_t = dict(positions=torch.as_tensor(pos), window=1 << 30,
                causal=False, use_rope=False)
    y_j, _ = jattn.attn_apply(blk_j, jnp.asarray(x), cfg,
                              kv_source=jnp.asarray(src), **kw_j)
    with torch.no_grad():
        y_t, c_t = tattn.attn_apply(blk_t, torch.as_tensor(x), tcfg,
                                    kv_source=torch.as_tensor(src), **kw_t)
    assert c_t is None
    assert _rel(y_t, y_j) < TOL_BLOCK
    k_j, v_j = jattn.compute_cross_kv(blk_j, cfg, jnp.asarray(src))
    with torch.no_grad():
        k_t, v_t = tattn.compute_cross_kv(blk_t, tcfg, torch.as_tensor(src))
    assert _rel(k_t, k_j) < TOL_BLOCK and _rel(v_t, v_j) < TOL_BLOCK
    kw_j["positions"], kw_t["positions"] = jnp.arange(1), torch.arange(1)
    y_j, _ = jattn.attn_apply(blk_j, jnp.asarray(x[:, :1]), cfg,
                              static_kv=(k_j, v_j), **kw_j)
    with torch.no_grad():
        y_t, _ = tattn.attn_apply(blk_t, torch.as_tensor(x[:, :1]), tcfg,
                                  static_kv=(k_t, v_t), **kw_t)
    assert _rel(y_t, y_j) < TOL_BLOCK
    # the cached K/V give the source's output at that token
    with torch.no_grad():
        y_s, _ = tattn.attn_apply(blk_t, torch.as_tensor(x[:, :1]), tcfg,
                                  kv_source=torch.as_tensor(src), **kw_t)
    assert _rel(y_t, y_s.numpy()) < TOL_BLOCK


def check_forward(arch, which, with_frontend):
    """Logits of ``forward`` dense or under the top and bottom rows'
    ranks trees (factorized params), with and without a frontend."""
    st = _state(arch)
    cfg, tcfg = st["cfg"], st["tcfg"]
    toks = _tokens(arch)
    fr = _frontend(arch) if with_frontend else None
    fr_j = None if fr is None else jnp.asarray(fr)
    fr_t = None if fr is None else torch.as_tensor(fr)
    if which == "dense":
        cases = [(st["dense_j"], None, st["dense_t"], None)]
    else:
        fact_t = bridge.params_to_torch(_np_tree(st["fact_j"]))
        tdev_j, tdev_t = JFR.table_device(st["table_j"]), \
            TFR.table_host(st["table_t"])
        cases = [(st["fact_j"], JFR.ranks_tree(cfg, st["infos_j"], tdev_j,
                                               jnp.asarray(k)),
                  fact_t, TFR.ranks_tree(tcfg, st["infos_t"], tdev_t, k))
                 for k in (0, tdev_t.shape[0] - 1)]
    for p_j, r_j, p_t, r_t in cases:
        l_j, _ = jtfm.forward(p_j, cfg, jnp.asarray(toks), ranks=r_j,
                              frontend=fr_j)
        with torch.no_grad():
            l_t, aux = ttfm.forward(p_t, tcfg, torch.as_tensor(toks),
                                    ranks=r_t, frontend=fr_t)
        assert l_t.shape == (BATCH, toks.shape[1], cfg.vocab_size)
        assert _rel(l_t, l_j) < TOL_LOGITS
        assert float(aux) == 0.0


def check_decode_state_and_bridge(arch):
    """``init_decode_state(cross_kv_len=)``: the reference's leaves, paths
    and shapes (``None`` for an encoder segment, each ``idx`` shaped like
    its block's lead dims); ``attach_cross_kv`` fills the buffers as the
    reference does; ``has_cross_kv``; a state of random leaves goes
    through the bridge and back exactly."""
    cfg, tcfg = _dense(arch)[:2]
    t = SOURCE_LEN[arch]
    st_j = jtfm.init_decode_state(cfg, BATCH, MAX_LEN, cross_kv_len=t)
    st_t = ttfm.init_decode_state(tcfg, BATCH, MAX_LEN, cross_kv_len=t)
    assert ttfm.has_cross_kv(st_t) and jtfm.has_cross_kv(st_j)
    assert not ttfm.has_cross_kv(ttfm.init_decode_state(tcfg, BATCH,
                                                        MAX_LEN))
    flat_j = jax.tree_util.tree_flatten_with_path(st_j)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(
        bridge.decode_state_to_numpy(st_t))[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (_, a_t), (_, a_j) in zip(flat_t, flat_j):
        assert a_t.shape == a_j.shape
    assert [c is None for c in st_t["segments"]] == \
        [c is None for c in st_j["segments"]]
    assert st_t["segments"][-1]["cross_k"].dtype == torch.bfloat16
    # attach, float32, dense and deployed
    for which in ("dense", "row0"):
        p_j, p_t = _params(arch, which)
        _, (src_j, src_t) = _source(arch, p_j, p_t, _frontend(arch))
        a_j = jtfm.attach_cross_kv(p_j, cfg, jtfm.init_decode_state(
            cfg, BATCH, MAX_LEN, dtype=jnp.float32, cross_kv_len=t), src_j)
        with torch.no_grad():
            a_t = ttfm.attach_cross_kv(p_t, tcfg, ttfm.init_decode_state(
                tcfg, BATCH, MAX_LEN, dtype=torch.float32, cross_kv_len=t),
                src_t)
        c_j, c_t = a_j["segments"][-1], a_t["segments"][-1]
        for key in ("cross_k", "cross_v"):
            assert float(c_t[key].abs().max()) > 0
            assert _rel(c_t[key], c_j[key]) < TOL_BLOCK
    st32 = jtfm.init_decode_state(cfg, BATCH, MAX_LEN, dtype=jnp.float32,
                                  cross_kv_len=t)
    rng = np.random.default_rng(3)
    st_np = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.asarray(a).dtype) if a.ndim > 2 else np.full(a.shape, 7, a.dtype),
        st32)
    back = bridge.decode_state_to_numpy(bridge.decode_state_to_torch(st_np))
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_n = jax.tree_util.tree_flatten_with_path(st_np)[0]
    assert [p for p, _ in flat_b] == [p for p, _ in flat_n]
    for (_, a), (_, b) in zip(flat_b, flat_n):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def check_decode_with_source(arch, which):
    """``prefill(kv_source=)`` of 10 tokens, then single ``decode_step``s
    with the source every step: logits against the reference's at every
    call and against ``forward(frontend=)`` of the whole sequence."""
    cfg, tcfg = _dense(arch)[:2]
    p_j, p_t = _params(arch, which)
    toks, fr = _tokens(arch), _frontend(arch)
    (s_j, s_t), _ = _source(arch, p_j, p_t, fr)
    st_j = jtfm.init_decode_state(cfg, BATCH, MAX_LEN, dtype=jnp.float32)
    st_t = ttfm.init_decode_state(tcfg, BATCH, MAX_LEN, dtype=torch.float32)
    feeds = [toks[:, :PROMPT]] + [toks[:, PROMPT + i:PROMPT + i + 1]
                                  for i in range(STEPS)]
    outs = []
    with torch.no_grad():
        for i, feed in enumerate(feeds):
            l_j, st_j = jtfm.decode_step(p_j, cfg, st_j, jnp.asarray(feed),
                                         kv_source=s_j)
            fn = ttfm.prefill if i == 0 else ttfm.decode_step
            l_t, st_t = fn(p_t, tcfg, st_t, torch.as_tensor(feed),
                           kv_source=s_t)
            assert _rel(l_t, l_j) < TOL_LOGITS, i
            outs.append(l_t)
        full, _ = ttfm.forward(p_t, tcfg, torch.as_tensor(toks),
                               frontend=torch.as_tensor(fr))
    assert st_t["pos"] == int(st_j["pos"]) == PROMPT + STEPS
    assert _rel(torch.cat(outs, dim=1), full.numpy()) < TOL_LOGITS


def check_decode_cached(arch, which):
    """``attach_cross_kv`` once, then one token a step from the first
    prompt token: logits against the reference's at every step and
    against ``forward(frontend=)``; the state's cross buffers unchanged
    and the rest within 1e-5 of the reference's after the last step."""
    cfg, tcfg = _dense(arch)[:2]
    p_j, p_t = _params(arch, which)
    toks, fr = _tokens(arch), _frontend(arch)
    _, (src_j, src_t) = _source(arch, p_j, p_t, fr)
    t = SOURCE_LEN[arch]
    st_j = jtfm.attach_cross_kv(p_j, cfg, jtfm.init_decode_state(
        cfg, BATCH, MAX_LEN, dtype=jnp.float32, cross_kv_len=t), src_j)
    outs = []
    with torch.no_grad():
        st_t = ttfm.attach_cross_kv(p_t, tcfg, ttfm.init_decode_state(
            tcfg, BATCH, MAX_LEN, dtype=torch.float32, cross_kv_len=t),
            src_t)
        cross0 = st_t["segments"][-1]["cross_k"].clone()
        for i in range(toks.shape[1]):
            feed = toks[:, i:i + 1]
            l_j, st_j = jtfm.decode_step(p_j, cfg, st_j, jnp.asarray(feed))
            l_t, st_t = ttfm.decode_step(p_t, tcfg, st_t,
                                         torch.as_tensor(feed))
            assert _rel(l_t, l_j) < TOL_LOGITS, i
            outs.append(l_t)
        full, _ = ttfm.forward(p_t, tcfg, torch.as_tensor(toks),
                               frontend=torch.as_tensor(fr))
    assert _rel(torch.cat(outs, dim=1), full.numpy()) < TOL_LOGITS
    assert torch.equal(st_t["segments"][-1]["cross_k"], cross0)
    back = bridge.decode_state_to_numpy(st_t)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(st_j)):
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, np.asarray(b))
        else:
            assert _rel(a, b) < TOL_BLOCK


def check_cached_prefill_raises(arch):
    """Over cached cross K/V a prompt of S > 1 (not the source's length)
    raises in both packages: the reference's key positions come from the
    queries there and its mask does not broadcast."""
    cfg, tcfg = _dense(arch)[:2]
    p_j, p_t = _params(arch, "dense")
    _, (src_j, src_t) = _source(arch, p_j, p_t, _frontend(arch))
    t = SOURCE_LEN[arch]
    toks = _tokens(arch)[:, :PROMPT]
    st_j = jtfm.attach_cross_kv(p_j, cfg, jtfm.init_decode_state(
        cfg, BATCH, MAX_LEN, dtype=jnp.float32, cross_kv_len=t), src_j)
    with pytest.raises(ValueError):
        jtfm.prefill(p_j, cfg, st_j, jnp.asarray(toks))
    with torch.no_grad():
        st_t = ttfm.attach_cross_kv(p_t, tcfg, ttfm.init_decode_state(
            tcfg, BATCH, MAX_LEN, dtype=torch.float32, cross_kv_len=t),
            src_t)
        with pytest.raises(ValueError, match="one query token"):
            ttfm.prefill(p_t, tcfg, st_t, torch.as_tensor(toks))


def check_moments(arch, with_frontend):
    """``collect_moments`` keys equal the reference's (cross taps under
    the layer, encoder taps under the encoder's layers, none for
    ``frontend_proj``), counts equal, moments within 1e-5."""
    st = _state(arch)
    cfg, tcfg = st["cfg"], st["tcfg"]
    if with_frontend:
        fn = lambda batch: _frontend(arch, seed=int(batch["tokens"][0, 0]))
        batches_j = jdata.calibration_batches(st["src_j"], 1)
        mom_j = JFR.collect_moments(st["dense_j"], cfg, batches_j,
                                    frontend_fn=fn)
        mom_t = TFR.collect_moments(st["dense_t"], tcfg, batches_j,
                                    frontend_fn=fn)
    else:
        mom_j, mom_t = st["mom_j"], st["mom_t"]
    assert sorted(mom_t) == sorted(mom_j)
    assert len(mom_t) == TAP_KEYS[arch][0 if with_frontend else 1]
    assert not any("frontend_proj" in k for k in mom_t)
    cross = "segments/1/@0/cross/attn/k" if cfg.family == "audio" \
        else "segments/0/@0/cross/attn/k"
    assert (cross in mom_t) == with_frontend
    for key, (m_j, c_j) in mom_j.items():
        m_t, c_t = mom_t[key]
        assert c_t == c_j
        assert _rel(m_t, m_j) < TOL_BLOCK, key


def check_table(arch):
    """Text-only calibration: the groups without a moment take plain SVD
    (``plain_svd_groups`` counts them), the curves agree within 1e-3 and
    the DP table is the reference's."""
    st = _state(arch)
    plain = TFR.plain_svd_groups(st["tcfg"], st["mom_t"])
    assert (len(plain), len(st["infos_t"])) == PLAIN_SVD[arch]
    assert "frontend_proj" in plain
    assert all("cross" in p or p == "frontend_proj"
               or st["cfg"].segments[int(p.split("/")[1])].kind == "encoder"
               for p in plain)
    for path, c_j in st["curves_j"].items():
        assert _rel(st["curves_t"][path], c_j) < 1e-3, path
    np.testing.assert_array_equal(st["table_t"].table, st["table_j"].table)
    assert st["table_t"].layer_names == st["table_j"].layer_names


def check_deployed_rows(arch):
    """``gar_deploy`` from the same factors at the bottom and top rows:
    the port's deployed leaves within 1e-5 of the reference's and the
    deployed row's ``forward(frontend=)`` within 1e-4."""
    st = _state(arch)
    cfg, tcfg = st["cfg"], st["tcfg"]
    fact_t = bridge.params_to_torch(_np_tree(st["fact_j"]))
    toks, fr = _tokens(arch), _frontend(arch)
    for which, k in (("row0", 0), ("top", st["table_t"].table.shape[0] - 1)):
        p_j, p_bridged = _params(arch, which)
        with torch.no_grad():
            p_t = TFR.gar_deploy(fact_t, tcfg, st["infos_t"],
                                 st["table_t"], k)
        leaf_t = tcm.tree_get(p_t, "frontend_proj")
        leaf_j = tcm.tree_get(p_bridged, "frontend_proj")
        assert torch.equal(leaf_t["perm_inv"], leaf_j["perm_inv"])
        for key in ("u_hat", "v_tilde"):       # u_hat is empty at full rank
            if leaf_j[key].numel():
                assert _rel(leaf_t[key], leaf_j[key].numpy()) < TOL_BLOCK
        l_j, _ = jtfm.forward(p_j, cfg, jnp.asarray(toks),
                              frontend=jnp.asarray(fr))
        with torch.no_grad():
            l_t, _ = ttfm.forward(p_t, tcfg, torch.as_tensor(toks),
                                  frontend=torch.as_tensor(fr))
        assert _rel(l_t, l_j) < TOL_LOGITS, which


def check_drain_streams(arch):
    """``generate(mode="auto")`` routes the family to drain on both
    engines (text-only requests: the cross blocks are skipped): greedy
    and top-k streams identical, prompts of mixed lengths, more requests
    than ``max_batch``."""
    from repro.serving import ElasticEngine as JaxEngine
    from repro.serving import Request as JaxRequest
    from repro.serving import SamplingParams as JaxSampling
    from repro_torch.serving import ElasticEngine, Request, SamplingParams
    st = _state(arch)
    cfg, tcfg = st["cfg"], st["tcfg"]
    assert not ttfm.paged_compatible(tcfg)
    spec = [(9, 5, 0.4, False), (12, 5, 1.0, True), (5, 3, 0.4, True),
            (7, 4, 1.0, False), (11, 5, 0.4, False)]
    rng = np.random.default_rng(0)
    jreqs, treqs = [], []
    for i, (plen, new, budget, sampled) in enumerate(spec):
        prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        knobs = (dict(temperature=0.8, top_k=20, seed=50 + i)
                 if sampled else None)
        jreqs.append(JaxRequest(prompt=prompt, max_new_tokens=new,
                                budget=budget,
                                sampling=knobs and JaxSampling(**knobs)))
        treqs.append(Request(prompt=prompt, max_new_tokens=new,
                             budget=budget,
                             sampling=knobs and SamplingParams(**knobs)))
    jeng = JaxEngine(cfg, st["fact_j"], st["table_j"], st["infos_j"],
                     max_batch=2, max_len=32)
    teng = ElasticEngine(tcfg, bridge.params_to_torch(_np_tree(
        st["fact_j"])), bridge.profile_table(st["table_j"]),
        bridge.group_infos(st["infos_j"]), max_batch=2, max_len=32,
        device="cpu")
    ref = jeng.generate(jreqs, mode="auto")
    got = teng.generate(treqs, mode="auto")
    for i, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(b.tokens, np.asarray(a.tokens),
                                      err_msg=f"request {i}")
        assert b.budget_row == a.budget_row
    s = teng.last_metrics.summary()
    assert s["decode_steps"] > 0 and not s["mixed_iterations"]


def check_launcher(arch, capsys):
    """The serving launcher on the family: ``auto`` picks drain, and the
    state line counts the plain-SVD groups."""
    from repro_torch.launch import serve
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--requests", "3", "--max-new", "3", "--budgets",
                      "0.4,1.0"])
    assert [len(r.tokens) for r in res] == [11] * 3
    out = capsys.readouterr().out
    plain, groups = PLAIN_SVD[arch]
    assert f"{plain} of {groups} groups plain SVD" in out
    assert "# serving:" in out and "# iteration split" not in out


def _key_for_row(k: int, num_k: int) -> int:
    return next(i for i in range(1000)
                if TFR.budget_draw(threefry.prng_key(i), num_k) == k)


def check_consolidation_step(arch):
    """One flexrank_kd consolidation loss (text only, at budget row 0)
    and its gradients against the reference's: loss within 1e-4, every
    gradient leaf within 1e-3 of its max (the encoder's, never reached by
    text, zero on both sides)."""
    st = _state(arch)
    cfg, tcfg = st["cfg"], st["tcfg"]
    num_k = st["table_t"].table.shape[0]
    seed = _key_for_row(0, num_k)
    batch = st["src_j"].batch_at(2)
    loss_j = JFR.make_consolidation_loss(cfg, st["infos_j"],
                                         JFR.table_device(st["table_j"]),
                                         st["dense_j"])
    (l_j, aux_j), g_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        st["fact_j"], {"tokens": jnp.asarray(batch["tokens"])},
        jax.random.PRNGKey(seed))
    params = tcm.tree_map(lambda t: t.requires_grad_(True),
                          bridge.params_to_torch(_np_tree(st["fact_j"])))
    loss_t = TFR.make_consolidation_loss(tcfg, st["infos_t"],
                                         TFR.table_host(st["table_t"]),
                                         st["dense_t"])
    l_t, aux_t = loss_t(params, {"tokens": torch.as_tensor(batch["tokens"])},
                        threefry.prng_key(seed))
    l_t.backward()
    assert aux_t["budget_k"] == int(aux_j["budget_k"]) == 0
    assert abs(float(l_t.detach()) - float(l_j)) / abs(float(l_j)) < 1e-4
    flat_j = jax.tree_util.tree_flatten_with_path(g_j)[0]
    assert len(flat_j) == len(tcm.tree_leaves(params))
    for path, g in flat_j:
        leaf = params
        for p in path:
            leaf = leaf[getattr(p, "key", getattr(p, "idx", None))]
        grad = torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
        g = np.asarray(g)
        if not np.abs(g).max():
            assert not grad.abs().max(), jax.tree_util.keystr(path)
            continue
        assert _rel(grad, g) < 1e-3, jax.tree_util.keystr(path)


# ------------------------------------------------------- the audio tests

def test_specs_and_groups():
    check_specs_and_groups(ARCH)


@pytest.mark.parametrize("which", ["dense", "row0"])
def test_cross_attn_apply_matches_jax(which):
    check_cross_attn_apply(ARCH, which)


@pytest.mark.parametrize("ranks", [False, True])
def test_run_encoder_matches_jax(ranks):
    """The encoder over 12 frames: ``frontend_proj`` (full rank under a
    ranks tree), bidirectional blocks with RoPE, ``final_norm``."""
    st = _state(ARCH)
    cfg, tcfg = st["cfg"], st["tcfg"]
    fr = _frontend(ARCH)
    if ranks:
        p_j, p_t = st["fact_j"], bridge.params_to_torch(_np_tree(
            st["fact_j"]))
        r_j = JFR.ranks_tree(cfg, st["infos_j"],
                             JFR.table_device(st["table_j"]), jnp.asarray(0))
        r_t = TFR.ranks_tree(tcfg, st["infos_t"],
                             TFR.table_host(st["table_t"]), 0)
    else:
        p_j, p_t, r_j, r_t = st["dense_j"], st["dense_t"], None, None
    e_j = jtfm.run_encoder(p_j, cfg, jnp.asarray(fr), r_j)
    with torch.no_grad():
        e_t = ttfm.run_encoder(p_t, tcfg, torch.as_tensor(fr), r_t)
    assert e_t.shape == (BATCH, SOURCE_LEN[ARCH], cfg.d_model)
    assert _rel(e_t, e_j) < TOL_BLOCK


@pytest.mark.parametrize("with_frontend", [True, False])
@pytest.mark.parametrize("which", ["dense", "ranks"])
def test_forward_matches_jax(which, with_frontend):
    check_forward(ARCH, which, with_frontend)


def test_decode_state_and_bridge():
    check_decode_state_and_bridge(ARCH)


@pytest.mark.parametrize("which", ["dense", "row0"])
def test_decode_with_source_matches_jax(which):
    check_decode_with_source(ARCH, which)


@pytest.mark.parametrize("which", ["dense", "top"])
def test_decode_cached_cross_kv_matches_jax(which):
    check_decode_cached(ARCH, which)


def test_cached_prefill_raises_in_both():
    check_cached_prefill_raises(ARCH)


@pytest.mark.parametrize("with_frontend", [True, False])
def test_moments_match_jax(with_frontend):
    check_moments(ARCH, with_frontend)


def test_table_identical():
    check_table(ARCH)


def test_deployed_rows_match_jax():
    check_deployed_rows(ARCH)


def test_drain_streams_identical():
    check_drain_streams(ARCH)


def test_launcher_serves_on_cpu(capsys):
    check_launcher(ARCH, capsys)


def test_consolidation_step_matches_jax():
    check_consolidation_step(ARCH)
