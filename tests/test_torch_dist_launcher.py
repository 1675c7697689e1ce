"""The training launcher's mesh path across ranks, on the CPU: two steps
at (2, 1) and (2, 2) against the reference's ``main(["--mesh-shape",
...])`` on forced host devices and against one rank (and, in its flexrank
modes and with Muon, at (1, 2) and (2, 2)), checkpoints across world
sizes, an agreed preemption, and ``dist_check.py`` (``chip_smoke.py``'s
phase 21) rehearsed at smoke size, on deepseek-moe-16b's and
llama4-scout-17b-a16e's smoke configs. The harness, the inputs, the
reference's script and the tolerances are ``tests/test_torch_dist.py``'s
(split from it so that the two run on two workers).
"""
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config as tget
from repro_torch.data import make_source
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcm

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))
import dist_check  # noqa: E402
import test_torch_dist as harness  # noqa: E402
import torch_dist_ranks as ranks  # noqa: E402
from test_torch_dist import (ARCHS, B, DEADLINE, MODE_RUNS, MODES, S,  # noqa: E402
                             _by, _dense, _free_port, _rel)

# the reference's launcher, one arch a process
REF_PARTS = [f"main:{a}" for a in ARCHS]

POOLS = {
    (1, 2): [{"kind": "train", "runs": MODE_RUNS}],
    (2, 1): [{"kind": "main", "arch": "deepseek-moe-16b"},
             {"kind": "train", "runs": [["llama4-scout-17b-a16e", "default"],
                                        ["deepseek-moe-16b", "nodrop_aux0"],
                                        ["llama4-scout-17b-a16e",
                                         "nodrop_aux0"]]}],
    (2, 2): [{"kind": "train", "runs": [[a, v] for a in ARCHS
                                        for v in ("default", "nodrop_aux0")]
              + MODE_RUNS},
             {"kind": "ckpt", "arch": "deepseek-moe-16b"},
             {"kind": "sigterm", "arch": "deepseek-moe-16b"}],
}


def _one_rank_ckpt(d: Path, arch: str) -> None:
    """Two steps of the launcher on one rank, checkpointed into ``d``."""
    cfg = tget(arch, smoke=True)
    ttrain.run(cfg, _dense(arch), make_source(cfg.vocab_size, S, B, seed=0),
               steps=2, mode="dense", eval_before=False, ckpt_dir=str(d),
               log=lambda m: None)


def _rehearse(tmp: Path, into: dict) -> None:
    """``chip_smoke.py``'s phase 21 at the smoke size on the CPU, gloo for
    its world of one: ``into["result"]``, or ``into["error"]``."""
    d = tmp / "phase21"
    d.mkdir()
    spec = dict(arch="deepseek-moe-16b", smoke=True, cut=False,
                device="cpu", backend_a="gloo", batch=2, seq=16, steps=2,
                port_a=_free_port(), port_b=_free_port(), dir=str(d),
                tol_loss=1e-4, tol_param=2e-3, leaf_share=1e-6,
                tol_logits=2e-4, lowrank={"arch": "gpt2-small", "layers": 2},
                decode={"prompt": 12, "cache": 32, "steps": 8},
                gar={"seed": 0})
    try:
        into["result"] = dist_check.run_pair(spec, DEADLINE)
    except RuntimeError as e:
        into["error"] = str(e)


def _checkpoints(tmp: Path) -> None:
    """The one-rank checkpoint the (2, 2) pool restores, and the pool's
    checkpoint and preemption directories."""
    _one_rank_ckpt(tmp / "one_rank", "deepseek-moe-16b")
    for job in POOLS[(2, 2)]:
        if job["kind"] == "ckpt":
            job.update(write=str(tmp / "written"), read=str(tmp / "read"))
            shutil.copytree(tmp / "one_rank", tmp / "read")
        elif job["kind"] == "sigterm":
            job.update(dir=str(tmp / "sigterm"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every pool's results, the reference's and the rehearsal's, computed
    once."""
    w = harness.build_world(tmp_path_factory.mktemp("dist_launcher"), POOLS,
                            REF_PARTS, before=_checkpoints, beside=_rehearse)
    w["rehearsal"] = w["side"]
    return w


# ------------------------------------------------------------ launcher

@pytest.mark.parametrize("shape", [(2, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_two_launcher_steps_match_reference(world, arch, shape):
    """Two steps of the launcher across ranks (its command line, with the
    world started from the environment, for deepseek at (2, 1)) against
    the reference's ``main(["--mesh-shape", ...])`` on forced devices; and
    every rank holds the same losses and replicated leaves."""
    pool = world["pools"][shape]
    if arch == "deepseek-moe-16b" and shape == (2, 1):
        losses = [r[f"main/{arch}/losses"] for r in pool]
    else:
        losses = [r[f"train/{arch}/default/losses"] for r in pool]
        _same_replicated(pool, f"train/{arch}/default", shape)
    for got in losses[1:]:
        np.testing.assert_array_equal(got, losses[0])
    want = world["ref"][f"main/{arch}/{shape[0]}x{shape[1]}"]
    assert len(losses[0]) == 2
    np.testing.assert_allclose(losses[0], want, rtol=1e-3)


def _same_replicated(pool, key, shape):
    """After the steps every rank of the mesh holds the same leaves, a
    leaf cut over 'model' (its part narrower than the whole leaf: the
    experts, and tensor-parallel the heads, MLP columns and vocabulary)
    the same within its 'model' column."""
    res = _by(pool, shape)
    for k, v in res[(0, 0)].items():
        if k.startswith(f"{key}/local/"):
            whole = res[(0, 0)][k.replace("/local/", "/params/", 1)]
            for (d, m), other in res.items():
                if v.shape == whole.shape or m == 0:
                    np.testing.assert_array_equal(other[k], v, k)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_two_launcher_steps_match_one_rank(world, arch, shape):
    """At no drop and no aux loss (the function every mesh computes the
    same), two steps across ranks against ``run`` on one rank over the
    whole batch: losses and the whole parameters after step 2."""
    cfg = ranks.variant(arch, "nodrop_aux0")
    one = ttrain.run(cfg, _dense(arch),
                     make_source(cfg.vocab_size, S, B, seed=0), steps=2,
                     mode="dense", eval_before=False, log=lambda m: None)
    pool = world["pools"][shape]
    key = f"train/{arch}/nodrop_aux0"
    _same_replicated(pool, key, shape)
    np.testing.assert_allclose(pool[0][f"{key}/losses"], one.losses,
                               rtol=1e-4)
    for path, leaf in tcm.tree_items(one.params):
        for res in pool:
            assert _rel(res[f"{key}/params/{path}"],
                        leaf.detach().numpy()) < 2e-3, path


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch,mode,optimizer", MODES)
def test_launcher_modes_match_one_rank(world, arch, mode, optimizer, shape):
    """``--mode flexrank`` and ``flexrank_kd`` (whose dense teacher keeps
    its own experts' part) with AdamW or Muon, and ``dense`` with Muon,
    two steps across ranks at no drop and no aux loss against ``run`` on
    one rank over the whole batch: losses, the elastic eval's rows, the
    whole parameters after step 2, and the replicated leaves alike on
    every rank."""
    cfg = ranks.variant(arch, "nodrop_aux0")
    one = ttrain.run(cfg, _dense(arch),
                     make_source(cfg.vocab_size, S, B, seed=0), steps=2,
                     mode=mode, optimizer=optimizer, eval_before=False,
                     log=lambda m: None)
    pool = world["pools"][shape]
    key = f"train/{arch}/nodrop_aux0/{mode}/{optimizer}"
    _same_replicated(pool, key, shape)
    assert len(pool[0][f"{key}/eval"]) == len(one.eval_after)
    for res in pool:
        np.testing.assert_allclose(res[f"{key}/losses"], one.losses,
                                   rtol=1e-4)
        np.testing.assert_allclose(res[f"{key}/eval"], one.eval_after,
                                   rtol=1e-4)
        for path, leaf in tcm.tree_items(one.params):
            assert _rel(res[f"{key}/params/{path}"],
                        leaf.detach().numpy()) < 2e-3, path


def test_checkpoints_cross_world_sizes(world):
    """A checkpoint written at (2, 2) holds the whole model and restores on
    one rank; one written on one rank restores at (2, 2) (each rank its
    part) and training goes on from it."""
    tmp, pool = world["tmp"], world["pools"][(2, 2)]
    arch = "deepseek-moe-16b"
    cfg = tget(arch, smoke=True)
    mgr = CheckpointManager(str(tmp / "written"))
    assert mgr.all_steps() == [2]
    template = ttrain.run(cfg, _dense(arch), make_source(
        cfg.vocab_size, S, B, seed=0), steps=0, mode="dense",
        eval_before=False, log=lambda m: None)
    (params, state), step = mgr.restore((template.params,
                                         template.opt_state))
    assert step == 2 and state.step == 2
    for path, leaf in tcm.tree_items(params):
        for res in pool:
            np.testing.assert_array_equal(
                res[f"ckpt/written/params/{path}"], leaf.numpy(), path)
    (one, _), _ = CheckpointManager(str(tmp / "one_rank")).restore(
        (template.params, template.opt_state))
    for res in pool:
        assert int(res["ckpt/restored/start"]) == 2
        assert len(res["ckpt/restored/losses"]) == 0
        for path, leaf in tcm.tree_items(one):
            np.testing.assert_array_equal(
                res[f"ckpt/restored/params/{path}"], leaf.numpy(), path)
        resumed = res["ckpt/resumed/losses"]
        assert len(resumed) == 1 and np.isfinite(resumed).all()


def test_sigterm_to_one_rank_checkpoints_all_at_one_step(world):
    """A SIGTERM to the last rank after step 1 of 4: every rank stops
    after step 2, and the one checkpoint is step 2's."""
    for res in world["pools"][(2, 2)]:
        assert bool(res["sigterm/preempted"])
        assert int(res["sigterm/steps"]) == 2
    assert CheckpointManager(str(world["tmp"] / "sigterm")).all_steps() \
        == [2]


# ------------------------------------------------ the chip phase, rehearsed

def test_chip_phase_21_rehearses_on_the_cpu(world):
    """``dist_check.py`` (``chip_smoke.py``'s phase 21) at
    the smoke size: (a) bit for bit, (b) at (2, 1) and (1, 2) within its
    bounds, every collective timed, each (1, 2) rank holding ``placed``'s
    bytes; (c) gpt2-small's flexrank run at (1, 2) within its bounds, as
    many low-rank products on each rank as on one; (d) the greedy decode
    over the rank's part of the cache at (1, 2) and (2, 1) against one
    rank, ``placed``'s bytes, the rows written where they fall; (e) the
    GAR decode at (1, 2) against one rank, each rank's GAR products on its
    parts of the leaves."""
    assert "error" not in world["rehearsal"], world["rehearsal"]["error"]
    r = world["rehearsal"]["result"]
    assert len(r["a_losses"]) == 2
    for key in ("2x1", "1x2"):
        assert r[key]["loss_err"] < 1e-4 and r[key]["past"] == {}
        assert len(r[key]["allreduce_ms"]) == 2
    assert not r["2x1"]["split"] and r["1x2"]["split"]
    for b in r["1x2"]["bytes"]:
        assert b["have"]["params"] == b["placed"]["params"]
        assert b["have"]["optimizer"] + 4 == b["placed"]["optimizer"]
    assert r["c"]["loss_err"] < 1e-4 and r["c"]["past"] == {}
    assert [c["calls"] for c in r["c"]["ranks"]] == [r["c_one"]["calls"]] * 2
    assert r["logits_err"] < 2e-4
    assert len(r["a2a_ms"]["dispatch"]) == len(r["a2a_ms"]["return"]) == 3
    # (d): the prefill and 8 greedy steps over the rank's part of the cache
    d = r["d"]
    for key in ("1x2", "2x1"):
        assert d[key]["logits_err"] < 2e-4
        assert all(len(x["step_ms"]) == 8 for x in d[key]["ranks"])
    # the experts cut at decode: the (1, 2) rank's parameters are half of
    # every placed leaf, as in training
    assert [x["bytes"]["params"] for x in d["1x2"]["ranks"]] == [
        b["placed"]["params"] for b in r["1x2"]["bytes"]]
    # a batch of one: 16 rows a rank, the prompt's 12 and 4 steps on rank
    # 0, the last 4 steps on rank 1
    assert [x["rows"] for x in d["2x1"]["ranks"]] == [16, 4]
    assert all(2 * x["bytes"]["cache"] == d["2x1"]["one_cache"]
               for x in d["2x1"]["ranks"])
    # (e): the GAR decode at (1, 2), each rank on its parts of the GAR
    # leaves (their stage-2 products among them); no launches on the CPU
    e = r["e"]
    assert e["logits_err"] < 2e-4
    for x in e["ranks"]:
        assert len(x["step_ms"]) == 8 and x["tails"] and not x["foreign"]
        assert x["bytes"]["params"] < e["one_params"]


@pytest.mark.parametrize("window", [10 ** 9, 24])
def test_merge_over_sixteen_shards_matches_whole(window):
    """``dist_check.merge_check`` (``chip_smoke.py`` runs it at llama4's
    decode_32k layer): a bfloat16 cache of 128 rows cut into 16 shards, the
    query at position 89 (shards 12-15 wholly masked, and with a window
    of 24 shards 0-7 too), within 1e-5 of the output's max in float32 and
    at most one bfloat16 ulp of it (2^-7) in the cache's type."""
    got = dist_check.merge_check("cpu", batch=2, heads=8, kv_heads=2,
                                 head_dim=16, length=128, shards=16, pos=89,
                                 window=window)
    assert got["err"] < 1e-5 and got["bf16_err"] <= 2.0 ** -7


