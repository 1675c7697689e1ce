"""The port's vision family (llama-3.2-vision-11b: units of self-attention
blocks and one gated cross-attention block over projected image patches)
against the JAX package's, on the CPU, at the smoke config (one unit of 2
self blocks and the cross block, 17 patches of width 96).

The checks and their tolerances are ``tests/test_torch_audio.py``'s, run
here on the vision config; besides them, the projection of the raw
patches that ``decode_step`` makes when no cross K/V is cached, and the
nested self caches of a unit.
"""
import jax.numpy as jnp
import pytest
import torch

from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.models import transformer as ttfm
from test_torch_audio import (
    BATCH, MAX_LEN, TOL_LOGITS, _dense, _frontend, _params, _rel, _tokens,
    check_cached_prefill_raises, check_consolidation_step,
    check_cross_attn_apply, check_decode_cached,
    check_decode_state_and_bridge, check_decode_with_source,
    check_deployed_rows, check_drain_streams, check_forward, check_launcher,
    check_moments, check_specs_and_groups, check_table)

ARCH = "llama-3.2-vision-11b"


def test_specs_and_groups():
    check_specs_and_groups(ARCH)


@pytest.mark.parametrize("which", ["dense", "row0"])
def test_cross_attn_apply_matches_jax(which):
    check_cross_attn_apply(ARCH, which)


@pytest.mark.parametrize("with_frontend", [True, False])
@pytest.mark.parametrize("which", ["dense", "ranks"])
def test_forward_matches_jax(which, with_frontend):
    check_forward(ARCH, which, with_frontend)


def test_decode_state_and_bridge():
    """Besides the shared checks: a unit's self caches are (U, P, B, T,
    Hkv, D) with ``idx`` (U, P) in the reference's layout, and every unit
    and block has zeros of its own."""
    check_decode_state_and_bridge(ARCH)
    cfg, tcfg = _dense(ARCH)[:2]
    seg = cfg.segments[0]
    st = ttfm.init_decode_state(tcfg, BATCH, MAX_LEN)
    selfs = st["segments"][0]["selfs"]
    assert selfs["k"].shape == (seg.count, seg.self_per_unit, BATCH,
                                MAX_LEN, cfg.num_kv_heads,
                                cfg.resolved_head_dim)
    assert selfs["k"][0, 0].data_ptr() != selfs["k"][0, 1].data_ptr()
    assert bridge.decode_state_to_numpy(st)["segments"][0]["selfs"][
        "idx"].shape == (seg.count, seg.self_per_unit)


@pytest.mark.parametrize("which", ["dense", "row0"])
def test_decode_with_source_matches_jax(which):
    check_decode_with_source(ARCH, which)


@pytest.mark.parametrize("which", ["dense", "top"])
def test_decode_cached_cross_kv_matches_jax(which):
    check_decode_cached(ARCH, which)


def test_projected_source_equals_raw_patches():
    """``decode_step`` projects raw patches (width ``frontend_dim``) by
    ``frontend_proj`` when no cross K/V is cached; handing it the
    projected source instead gives the same logits."""
    cfg, tcfg = _dense(ARCH)[:2]
    p_j, p_t = _params(ARCH, "dense")
    fr = torch.as_tensor(_frontend(ARCH))
    toks = torch.as_tensor(_tokens(ARCH))
    with torch.no_grad():
        proj = fr @ p_t["frontend_proj"]["w"]
        outs = []
        for src in (fr, proj):
            st = ttfm.init_decode_state(tcfg, BATCH, MAX_LEN,
                                        dtype=torch.float32)
            outs.append(ttfm.prefill(p_t, tcfg, st, toks, kv_source=src)[0])
    assert _rel(outs[0], outs[1].numpy()) < TOL_LOGITS
    st_j = jtfm.init_decode_state(cfg, BATCH, MAX_LEN, dtype=jnp.float32)
    l_j, _ = jtfm.prefill(p_j, cfg, st_j, jnp.asarray(toks.numpy()),
                          kv_source=jnp.asarray(fr.numpy()))
    assert _rel(outs[0], l_j) < TOL_LOGITS


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
