"""The port's carried decode state against the JAX package's, on the CPU,
at the smoke configs: the recurrences with an initial state
(``wkv_chunked``, ``ssd_chunked``), the conv and token-shift carries,
``rwkv_apply``/``mamba_apply`` over a prefill and three single-token
steps, ``init_decode_state`` for every ported family, the contiguous
``prefill``/``decode_step`` on dense weights and on a GAR-deployed row,
and the port's own decode against its forward.

Weights are numpy draws bridged into both packages (every leaf that the
specs initialize to zero is drawn small instead, as in
``tests/test_torch_recurrent.py``, so the decays and mixes are
exercised). Decode states are float32 on both sides, as the drain engine
builds them. Tolerances, float32 throughout, relative to the reference's
max: the chunked recurrences and the carries 1e-5 (the same arithmetic);
block outputs and state leaves 1e-5; logits 1e-4 (a whole model, as the
forward's in ``tests/test_torch_train.py``); the port's decode against
its forward 1e-4 (other chunkings of the same recurrences: a prefill of
the whole prompt and single steps against the forward's chunks).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config
from repro.core import flexrank as JFR
from repro.models import common as jcm
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_config as tget
from repro_torch.core import flexrank as TFR
from repro_torch.models import common as tcm
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm

torch.set_num_threads(1)

ARCHS = ("gpt2-small", "gemma3-27b", "rwkv6-3b", "zamba2-7b")
BATCH, STEPS, MAX_LEN = 2, 3, 40
# prompt lengths: gemma3's passes its 16-token window; rwkv6's is two of
# its 16-step chunks (a longer prompt must be a multiple of the chunk);
# zamba2's is no multiple of its 32-step chunk (the stateful scan runs the
# prompt as one chunk)
PROMPT = {"gpt2-small": 12, "gemma3-27b": 24, "rwkv6-3b": 32,
          "zamba2-7b": 20}


def _rel(a, b) -> float:
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-12)


@functools.lru_cache(maxsize=None)
def _dense(arch, seed=0):
    """(cfg, port cfg, JAX dense params, numpy dense params)."""
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(seed)

    def draw(spec):
        if spec.init == "ones":
            return np.ones(spec.shape, np.float32)
        scale = 0.2 if spec.init == "zeros" else 1.0 / np.sqrt(
            spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1])
        return (scale * rng.standard_normal(spec.shape)).astype(np.float32)

    dense = jax.tree.map(draw, jtfm.model_spec(cfg), is_leaf=jcm.is_spec)
    return cfg, tget(arch, smoke=True), jax.tree.map(jnp.asarray, dense), \
        dense


# ------------------------------------------------ recurrences and carries

def _wkv_inputs(b, s, h, n, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32)
               for _ in range(3))
    w = (10.0 ** rng.uniform(-3, 0, (b, s, h, n))).astype(np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    st = rng.standard_normal((b, h, n, n)).astype(np.float32)
    return (r, k, v, w, u), st


@pytest.mark.parametrize("s", [1, 8, 24])
def test_wkv_chunked_initial_state_matches_jax(s):
    """S = 1, one chunk (8) and three chunks, from a random state."""
    arrays, st = _wkv_inputs(2, s, 3, 8, s)
    y_j, f_j = jrwkv.wkv_chunked(*map(jnp.asarray, arrays), chunk=8,
                                 initial_state=jnp.asarray(st))
    y_t, f_t = trwkv.wkv_chunked(*map(torch.as_tensor, arrays), chunk=8,
                                 initial_state=torch.as_tensor(st))
    assert _rel(y_t, y_j) < 1e-5
    assert _rel(f_t, f_j) < 1e-5


@pytest.mark.parametrize("s", [1, 8, 24])
def test_ssd_chunked_initial_state_matches_jax(s):
    rng = np.random.default_rng(100 + s)
    b, h, p, g, n = 2, 4, 8, 2, 8
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((b, s, h))) * 0.5).astype(np.float32)
    a = -np.abs(rng.standard_normal(h)).astype(np.float32)
    bb, cc = (rng.standard_normal((b, s, g, n)).astype(np.float32)
              for _ in range(2))
    st = rng.standard_normal((b, h, n, p)).astype(np.float32)
    arrays = (x, dt, a, bb, cc)
    y_j, f_j = jssm.ssd_chunked(*map(jnp.asarray, arrays), chunk=8,
                                initial_state=jnp.asarray(st))
    y_t, f_t = tssm.ssd_chunked(*map(torch.as_tensor, arrays), chunk=8,
                                initial_state=torch.as_tensor(st))
    assert _rel(y_t, y_j) < 1e-5
    assert _rel(f_t, f_j) < 1e-5


@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_and_token_shift_carries_match_jax(s, with_state):
    rng = np.random.default_rng(7 * s + with_state)
    x = rng.standard_normal((2, s, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32)
    prev = rng.standard_normal((2, 6)).astype(np.float32)
    y_j, c_j = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(st) if with_state else None)
    y_t, c_t = tssm._causal_conv(torch.as_tensor(x), torch.as_tensor(w),
                                 torch.as_tensor(st) if with_state else None)
    assert c_t.shape == c_j.shape == (2, 3, 6)
    assert _rel(y_t, y_j) < 1e-5
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    sh_j = jrwkv._token_shift(jnp.asarray(x),
                              jnp.asarray(prev) if with_state else None)
    sh_t = trwkv._token_shift(torch.as_tensor(x),
                              torch.as_tensor(prev) if with_state else None)
    np.testing.assert_array_equal(sh_t.numpy(), np.asarray(sh_j))


def _block_steps(apply_j, apply_t, p_j, p_t, cfg, tcfg, state_np, xs):
    """The block over a prefill and single-token steps on both sides;
    every output and every state leaf within 1e-5."""
    st_j = jax.tree.map(jnp.asarray, state_np)
    st_t = {k: torch.tensor(v) for k, v in state_np.items()}
    for x in xs:
        y_j, st_j = apply_j(p_j, jnp.asarray(x), cfg, state=st_j)
        y_t, st_t = apply_t(p_t, torch.as_tensor(x), tcfg, state=st_t)
        assert _rel(y_t, y_j) < 1e-5
        assert sorted(st_t) == sorted(st_j)
        for key in st_j:
            assert st_t[key].dtype == torch.float32, key
            assert tuple(st_t[key].shape) == st_j[key].shape, key
            assert _rel(st_t[key], st_j[key]) < 1e-5, key


def _steps_inputs(d, prompt, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((BATCH, s, d)).astype(np.float32)
            for s in (prompt,) + (1,) * STEPS]


def test_rwkv_apply_with_state_matches_jax():
    cfg, tcfg, dense_j, dense = _dense("rwkv6-3b")
    p_j = jax.tree.map(lambda a: a[0], dense_j["segments"][0])
    p_t = bridge.params_to_torch(jax.tree.map(lambda a: a[0],
                                              dense["segments"][0]))
    state = jax.tree.map(lambda a: np.asarray(a[0]),
                         jrwkv.init_rwkv_state(cfg, BATCH, num_instances=1))
    _block_steps(jrwkv.rwkv_apply, trwkv.rwkv_apply, p_j, p_t, cfg, tcfg,
                 state, _steps_inputs(cfg.d_model, 32, 1))


def test_mamba_apply_with_state_matches_jax():
    cfg, tcfg, dense_j, dense = _dense("zamba2-7b")
    p_j = jax.tree.map(lambda a: a[0], dense_j["segments"][1]["mamba"])
    p_t = bridge.params_to_torch(jax.tree.map(
        lambda a: a[0], dense["segments"][1]["mamba"]))
    state = jax.tree.map(lambda a: np.asarray(a[0]),
                         jssm.init_mamba_state(cfg, BATCH, num_instances=1))
    _block_steps(jssm.mamba_apply, tssm.mamba_apply, p_j, p_t, cfg, tcfg,
                 state, _steps_inputs(cfg.d_model, 20, 2))


# ------------------------------------------------------- decode states

@pytest.mark.parametrize("arch", ARCHS)
def test_init_decode_state_leaves_match_jax(arch):
    """Default dtypes (bfloat16 K/V, float32 recurrent states): every leaf
    of the bridged state has the reference's shape and dtype name, and the
    zamba units' states do not share memory."""
    cfg = get_config(arch, smoke=True)
    tcfg = tget(arch, smoke=True)
    st_j = jtfm.init_decode_state(cfg, BATCH, MAX_LEN)
    st_t = ttfm.init_decode_state(tcfg, BATCH, MAX_LEN)
    assert st_t["pos"] == 0
    leaves_j = jax.tree_util.tree_flatten_with_path(st_j)[0]
    leaves_t = jax.tree_util.tree_flatten_with_path(
        bridge.decode_state_to_numpy(st_t))[0]
    assert [p for p, _ in leaves_t] == [p for p, _ in leaves_j]
    dtypes = dict(tcm.tree_items(st_t))
    for (path, a_t), (_, a_j) in zip(leaves_t, leaves_j):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", "")))
                       for k in path)
        assert a_t.shape == a_j.shape, key
        want = str(a_j.dtype)
        got = (str(dtypes[key].dtype).replace("torch.", "")
               if isinstance(dtypes.get(key), torch.Tensor) else
               str(a_t.dtype))
        assert got == want, key
        assert not np.any(np.asarray(a_j, np.float32)), key
        assert not np.any(np.asarray(a_t, np.float32)), key
    if arch == "zamba2-7b":
        ssd = st_t["segments"][0]["mamba"]["ssd"]
        ssd[1, 0] += 1.0
        assert not ssd[0].any() and not ssd[1, 1].any()


def test_decode_state_bridge_round_trip():
    cfg, tcfg = get_config("zamba2-7b", smoke=True), tget("zamba2-7b",
                                                           smoke=True)
    st_j = jtfm.init_decode_state(cfg, BATCH, MAX_LEN, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    st_np = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.asarray(a).dtype) if a.ndim > 1 else np.full(a.shape, 7, a.dtype),
        st_j)
    st_t = bridge.decode_state_to_torch(st_np)
    assert st_t["pos"] == 7 and st_t["segments"][0]["attn"]["idx"] == 7
    back = bridge.decode_state_to_numpy(st_t)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(st_np)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------- prefill and decode, models

@functools.lru_cache(maxsize=None)
def _gar_row(arch):
    """Both packages' params of budget row 0, GAR-deployed from plain-SVD
    factors of the dense weights (no calibration: the deploy path is what
    is held here)."""
    cfg, tcfg, dense_j, dense = _dense(arch)
    fact_j, curves = JFR.decompose(dense_j, cfg, None)
    table_j, infos_j = JFR.build_table(cfg, curves)
    gar_j = JFR.gar_deploy(fact_j, cfg, infos_j, table_j, 0)
    gar_t = TFR.gar_deploy(bridge.params_to_torch(
        jax.tree.map(np.asarray, fact_j)), tcfg, bridge.group_infos(infos_j),
        bridge.profile_table(table_j), 0)
    return gar_j, gar_t


def _params(arch, which):
    cfg, tcfg, dense_j, dense = _dense(arch)
    if which == "dense":
        return cfg, tcfg, dense_j, bridge.params_to_torch(dense)
    return (cfg, tcfg) + _gar_row(arch)


def _tokens(cfg, arch):
    rng = np.random.default_rng(len(arch))
    return rng.integers(0, cfg.vocab_size,
                        (BATCH, PROMPT[arch] + STEPS)).astype(np.int32)


@pytest.mark.parametrize("which", ["dense", "gar"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_jax(arch, which):
    """A prefill of the prompt, then three single-token steps on both
    sides: logits within 1e-4, every state leaf within 1e-5 after the last
    step, positions advanced alike."""
    cfg, tcfg, p_j, p_t = _params(arch, which)
    toks = _tokens(cfg, arch)
    n = PROMPT[arch]
    st_j = jtfm.init_decode_state(cfg, BATCH, MAX_LEN, dtype=jnp.float32)
    st_t = ttfm.init_decode_state(tcfg, BATCH, MAX_LEN, dtype=torch.float32)
    step_j = jax.jit(lambda p, st, tok: jtfm.decode_step(p, cfg, st, tok))
    feeds = [toks[:, :n]] + [toks[:, n + i:n + i + 1] for i in range(STEPS)]
    with torch.no_grad():
        for i, feed in enumerate(feeds):
            l_j, st_j = step_j(p_j, st_j, jnp.asarray(feed))
            fn = ttfm.prefill if i == 0 else ttfm.decode_step
            l_t, st_t = fn(p_t, tcfg, st_t, torch.as_tensor(feed))
            assert l_t.shape == (BATCH, feed.shape[1], tcfg.vocab_size)
            assert _rel(l_t, l_j) < 1e-4, i
    assert st_t["pos"] == int(st_j["pos"]) == n + STEPS
    back = bridge.decode_state_to_numpy(st_t)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(st_j)):
        assert a.shape == b.shape
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, np.asarray(b))
        else:
            assert _rel(a, b) < 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port's own parity, as the reference's ``test_decode_matches_
    forward``: prefill and single steps give the logits of the forward
    over the whole sequence, within 1e-4."""
    cfg, tcfg, _, p_t = _params(arch, "dense")
    toks = torch.as_tensor(_tokens(cfg, arch))
    n = PROMPT[arch]
    with torch.no_grad():
        full, _ = ttfm.forward(p_t, tcfg, toks)
        st = ttfm.init_decode_state(tcfg, BATCH, MAX_LEN,
                                    dtype=torch.float32)
        logits, st = ttfm.prefill(p_t, tcfg, st, toks[:, :n])
        outs = [logits]
        for i in range(STEPS):
            logits, st = ttfm.decode_step(p_t, tcfg, st,
                                          toks[:, n + i:n + i + 1])
            outs.append(logits)
    assert _rel(torch.cat(outs, dim=1), full.numpy()) < 1e-4


def test_decode_cache_overflow_raises():
    _, tcfg, _, p_t = _params("gpt2-small", "dense")
    st = ttfm.init_decode_state(tcfg, 1, 4, dtype=torch.float32)
    with pytest.raises(ValueError, match="cannot take"):
        ttfm.prefill(p_t, tcfg, st, torch.zeros((1, 5), dtype=torch.int64))
