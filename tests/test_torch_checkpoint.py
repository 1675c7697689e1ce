"""The port's checkpointing and preemption against the JAX package's, on
the CPU: checkpoints interchange with ``repro.checkpoint.CheckpointManager``
in both directions, leaf for leaf and bit for bit, for ``(params,
AdamWState)`` and ``(params, MuonState)``; torn writes, keep-last-k, the
async save's host snapshot, ``PreemptionGuard``, and the launcher's
restart path, bit for bit against an uninterrupted run. Everything here
is exact: a checkpoint is a copy.
"""
import os
import signal

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import get_config
from repro.core import flexrank as JFR
from repro.models import common as jcm
from repro.optim import adamw as jadamw
from repro.optim import muon as jmuon
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed import PreemptionGuard
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcm
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import muon as tmuon

torch.set_num_threads(1)


def _jax_state(optimizer):
    """Factorized gpt2 smoke params and an optimizer state with non-zero
    moments and step, as the JAX package makes them."""
    cfg = get_config("gpt2-small", smoke=True)
    params = jcm.instantiate(JFR.factorized_spec(cfg), jax.random.PRNGKey(0))
    grads = jax.tree.map(lambda p: 0.1 * jnp.ones_like(p) + p, params)
    opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    if optimizer == "muon":
        mcfg = jmuon.MuonConfig(adamw=opt)
        state = jmuon.init(params, mcfg)
        params, state, _ = jmuon.apply_updates(params, grads, state, mcfg)
    else:
        state = jadamw.init(params)
        params, state, _ = jadamw.apply_updates(params, grads, state, opt)
    return params, state


def _port_template(params_j, optimizer):
    pt = bridge.params_to_torch(jax.tree.map(np.asarray, params_j))
    if optimizer == "muon":
        return pt, tmuon.init(pt, tmuon.MuonConfig())
    return pt, tadamw.init(pt)


def _leaves_equal(tree_t, tree_j):
    lt, lj = tcm.tree_leaves(tree_t), jax.tree.leaves(tree_j)
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        b = np.asarray(b)
        if isinstance(a, int):
            assert a == int(b) and b.dtype == np.int32
        else:
            a = a.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)


@pytest.mark.parametrize("optimizer", ["adamw", "muon"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, optimizer):
    params, state = _jax_state(optimizer)
    JManager(str(tmp_path), async_save=False).save(1, (params, state))
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 1
    tree, step = mgr.restore(_port_template(params, optimizer))
    assert step == 1
    _leaves_equal(tree, (params, state))
    assert isinstance(tree[1].step, int) and tree[1].step == 1


@pytest.mark.parametrize("optimizer", ["adamw", "muon"])
def test_port_checkpoint_restores_in_jax(tmp_path, optimizer):
    params, state = _jax_state(optimizer)
    template = _port_template(params, optimizer)
    # the port's tree holding the JAX state's values, its step an int
    JManager(str(tmp_path / "a"), async_save=False).save(3, (params, state))
    tree, _ = CheckpointManager(str(tmp_path / "a")).restore(template)
    CheckpointManager(str(tmp_path / "b")).save(7, tree, blocking=True)
    zeros = jax.tree.map(jnp.zeros_like, (params, state))
    back, step = JManager(str(tmp_path / "b")).restore(zeros)
    assert step == 7
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves((params, state))):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a), np.asarray(b))
    names = set(np.load(tmp_path / "b" / "step_000000007" /
                        "shard_00000.npz").files)
    assert "[1]::.step" in names and "[0]::['embed']" in names
    if optimizer == "muon":
        assert "[1]::.adamw_state::.mu::['final_norm']" in names


def test_torn_writes_are_ignored_and_last_k_kept(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    for s in (1, 2, 3):
        mgr.save(s, {"w": tree["w"] + s})
    assert mgr.all_steps() == [2, 3]
    # a torn step: no COMMIT marker, or a leftover .tmp directory
    os.makedirs(tmp_path / "step_000000009")
    os.makedirs(tmp_path / "step_000000010.tmp")
    open(tmp_path / "step_000000010.tmp" / "COMMIT", "w").close()
    assert mgr.latest_step() == 3
    out, step = mgr.restore({"w": torch.zeros(2, 3)})
    assert step == 3 and torch.equal(out["w"], tree["w"] + 3)
    # a missing key keeps the template's value
    out, _ = mgr.restore({"w": torch.zeros(2, 3), "b": torch.ones(2)})
    assert torch.equal(out["b"], torch.ones(2))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tree)


def test_async_save_holds_the_pre_step_values(tmp_path):
    """``save`` returns before the file is written; the in-place
    optimizer step that follows at once must not reach the checkpoint."""
    rng = np.random.default_rng(0)
    params = {"w": torch.as_tensor(rng.standard_normal((256, 256),
                                                       dtype=np.float32)),
              "b": torch.zeros(256)}
    state = tadamw.init(params)
    want = {k: v.clone() for k, v in params.items()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, (params, state))
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    for _ in range(3):
        tadamw.apply_updates(params, grads, state,
                             tadamw.AdamWConfig(lr=1.0, warmup_steps=1))
    mgr.wait()
    assert not torch.equal(params["w"], want["w"])
    (out, st), _ = mgr.restore((params, tadamw.init(params)))
    assert torch.equal(out["w"], want["w"]) and torch.equal(out["b"],
                                                            want["b"])
    assert st.step == 0 and not st.mu["w"].any()


def test_preemption_guard_on_sigusr1():
    prev = signal.getsignal(signal.SIGUSR1)
    guard = PreemptionGuard(signals=(signal.SIGUSR1,))
    try:
        assert not guard.requested
        os.kill(os.getpid(), signal.SIGUSR1)
        assert guard.requested
    finally:
        guard.restore()
    assert signal.getsignal(signal.SIGUSR1) is prev


def _sigterm_after(n):
    def hook(step):
        if step == n:
            os.kill(os.getpid(), signal.SIGTERM)
    return hook


@pytest.mark.parametrize("optimizer", ["adamw", "muon"])
def test_preempted_and_resumed_run_equals_uninterrupted(tmp_path, optimizer):
    """``flexrank_kd``, 4 steps, a checkpoint every 2: SIGTERM after step
    1 saves at step 2 and returns; the restart runs steps 2-3. Losses and
    final parameters equal the uninterrupted run's, bit for bit; a third
    invocation finds the run finished and returns no loss."""
    args = ["--smoke", "--device", "cpu", "--steps", "4", "--seq-len", "16",
            "--batch", "2", "--mode", "flexrank_kd", "--optimizer", optimizer,
            "--ckpt-every", "2"]
    full_p, full_l = ttrain.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    ck = str(tmp_path / "b")
    prev = signal.getsignal(signal.SIGTERM)
    _, first = ttrain.main(args + ["--ckpt-dir", ck],
                           step_hook=_sigterm_after(1))
    assert len(first) == 2
    assert CheckpointManager(ck).all_steps() == [2]
    assert signal.getsignal(signal.SIGTERM) is prev
    resumed_p, second = ttrain.main(args + ["--ckpt-dir", ck])
    assert first + second == full_l
    for a, b in zip(tcm.tree_leaves(resumed_p), tcm.tree_leaves(full_p)):
        assert torch.equal(a, b)
    assert CheckpointManager(ck).all_steps() == [2, 4]
    _, third = ttrain.main(args + ["--ckpt-dir", ck])
    assert third == []


def test_second_finished_invocation_returns_nothing(tmp_path):
    """The port's counterpart of ``tests/test_infra.py``'s restart test:
    8 dense steps with a checkpoint every 4, then the same command."""
    args = ["--smoke", "--device", "cpu", "--steps", "8", "--ckpt-dir",
            str(tmp_path / "ck"), "--ckpt-every", "4", "--seq-len", "32",
            "--batch", "2"]
    _, losses = ttrain.main(args)
    assert len(losses) == 8
    _, losses = ttrain.main(args)
    assert losses == []
