"""The training launcher tensor-parallel over 'model' at (1, 2), on the
CPU: two steps of gpt2-small's smoke config dense with AdamW and with
Muon (its cut matrices orthogonalized whole) and in flexrank (with its
elastic eval) against one rank, and checkpoints across (1, 1) and
(1, 2), in one pool of two gloo ranks (``tests/torch_dist_ranks.py``'s
``tp_run``). Tolerances: losses 1e-5 relative, parameters 2e-3 of each
leaf's largest entry (Adam's normalised step of an entry whose gradient
is rounding noise, as ``tests/test_torch_dist.py`` allows).
"""
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import make_source
from repro_torch.launch import train as ttrain
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import torch_dist_ranks as ranks  # noqa: E402
from test_torch_dist import run_pool  # noqa: E402

DEADLINE = 180
RUNS = [["gpt2-small", "dense", "adamw"], ["gpt2-small", "dense", "muon"],
        ["gpt2-small", "flexrank", "adamw"]]
_STATE: dict = {}


def _one_rank_run(arch, mode, optimizer, **kw):
    cfg = get_config(arch, smoke=True)
    dense = ranks.tree_from(np.load(_STATE["tmp"] / "inputs.npz"),
                            f"dense/{arch}", tfm.model_spec(cfg))
    return ttrain.run(cfg, dense, make_source(cfg.vocab_size, 16, 4, seed=0),
                      steps=2, mode=mode, optimizer=optimizer,
                      eval_before=False, log=lambda m: None, **kw)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The pool's results, computed once, after the one-rank checkpoint
    it restores."""
    tmp = tmp_path_factory.mktemp("tp_launcher")
    _STATE["tmp"] = tmp
    cfg = get_config("gpt2-small", smoke=True)
    np.savez(tmp / "inputs.npz", **{
        f"dense/gpt2-small/{p}": t.numpy()
        for p, t in cm.tree_items(ttrain.dense_init(cfg, 0, "cpu"))})
    end = time.monotonic() + DEADLINE
    _one_rank_run("gpt2-small", "dense", "adamw", ckpt_dir=str(tmp / "one"))
    shutil.copytree(tmp / "one", tmp / "read")
    job = {"kind": "tp_run", "mesh": "1x2", "runs": RUNS,
           "ckpt": {"write": str(tmp / "written"), "read": str(tmp / "read")}}
    pool = run_pool(tmp, (1, 2), [job], end - time.monotonic())
    return {"pool": pool, "tmp": tmp}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-12)


# ------------------------------------------------------------ launcher

@pytest.mark.parametrize("mode,optimizer", [("dense", "adamw"),
                                            ("dense", "muon"),
                                            ("flexrank", "adamw")])
def test_launcher_at_1x2_matches_one_rank(world, mode, optimizer):
    """Two launcher steps of gpt2-small at (1, 2), Muon orthogonalizing its
    cut matrices whole: losses, the elastic eval and the whole parameters
    against one rank."""
    one = _one_rank_run("gpt2-small", mode, optimizer)
    key = f"tp/run/gpt2-small/{mode}/{optimizer}"
    for res in world["pool"][:2]:
        np.testing.assert_allclose(res[f"{key}/losses"], one.losses,
                                   rtol=1e-5)
        for path, leaf in cm.tree_items(one.params):
            assert _rel(res[f"{key}/params/{path}"],
                        leaf.detach().numpy()) < 2e-3, path
    local = [k for k in world["pool"][0] if k.startswith(f"{key}/local/")]
    assert any(not np.array_equal(world["pool"][0][k], world["pool"][1][k])
               for k in local), "no leaf is cut over 'model'"


def test_checkpoints_cross_1x1_and_1x2(world):
    """A checkpoint written at (1, 2) holds the whole model and restores on
    one rank; one written on one rank restores at (1, 2), where training
    goes on from it."""
    tmp, pool = world["tmp"], world["pool"]
    cfg = get_config("gpt2-small", smoke=True)
    template = _one_rank_run("gpt2-small", "dense", "adamw")
    (params, state), step = CheckpointManager(str(tmp / "written")).restore(
        (template.params, template.opt_state))
    assert step == 2 and state.step == 2
    for path, leaf in cm.tree_items(params):
        for res in pool:
            np.testing.assert_array_equal(
                res[f"tp/run/gpt2-small/dense/adamw/params/{path}"],
                leaf.numpy(), path)
    for res in pool:
        assert int(res["tp/ckpt/restored/start"]) == 2
        assert len(res["tp/ckpt/restored/losses"]) == 1
        assert np.isfinite(res["tp/ckpt/restored/losses"]).all()
    # the step after the restore is the one-rank run's third
    third = ttrain.run(cfg, ranks.tree_from(
        np.load(tmp / "inputs.npz"), "dense/gpt2-small",
        tfm.model_spec(cfg)), make_source(cfg.vocab_size, 16, 4, seed=0),
        steps=3, ckpt_dir=str(tmp / "one"), mode="dense", eval_before=False,
        log=lambda m: None)
    for res in pool:
        np.testing.assert_allclose(res["tp/ckpt/restored/losses"],
                                   third.losses, rtol=1e-5)


