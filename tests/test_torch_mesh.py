"""The training launcher's preemption and mesh against the JAX package's,
on the CPU at the gpt2 smoke config.

A SIGTERM during the set-up (sent from inside ``build_flexrank_state``)
takes one step, saves ``step_000000001`` and returns in both launchers,
with losses equal within 1e-3 relative (the same tolerance as the
launchers' 4-step comparison in ``test_torch_train.py``); a SIGTERM during
the final elastic eval kills nothing. ``--mesh-shape 4,1`` shrinks to the
one device and trains as without the flag (the port bit for bit); ``2,2``
fails the reference's assertion in both. ``elastic_remesh``,
``timed_step``, ``make_mesh`` and ``single_device_mesh`` are held against
the reference's arithmetic. The port's launcher is given the JAX
package's dense weights, so both train the same model.
"""
import os
import signal

import numpy as np
import jax
import pytest
import torch

from repro.configs import get_config
from repro.core import flexrank as JFR
from repro.distributed import sharding as jsharding
from repro.launch import mesh as jmesh
from repro.launch import train as jtrain
from repro.models import common as jcm
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch import distributed as tdist
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import flexrank as TFR
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain

torch.set_num_threads(1)

SMALL = ["--smoke", "--seq-len", "16", "--batch", "2"]
CPU = [torch.device("cpu")]


def _jax_dense(cfg, seed, device):
    """The reference launcher's dense weights, ``instantiate(spec,
    PRNGKey(seed))``, as torch tensors on ``device``."""
    jcfg = get_config("gpt2-small", smoke=True)
    assert cfg.name == jcfg.name
    params = jcm.instantiate(jtfm.model_spec(jcfg), jax.random.PRNGKey(seed))
    return bridge.params_to_torch(jax.tree.map(np.asarray, params), device)


@pytest.fixture
def same_weights(monkeypatch):
    monkeypatch.setattr(ttrain, "dense_init", _jax_dense)


@pytest.fixture
def keep_sigterm():
    """The reference's ``main`` leaves its guard installed: put the
    handler back after each test."""
    prev = signal.getsignal(signal.SIGTERM)
    yield prev
    signal.signal(signal.SIGTERM, prev)


def _sigterm_first(fn):
    def wrapped(*args, **kw):
        os.kill(os.getpid(), signal.SIGTERM)
        return fn(*args, **kw)
    return wrapped


def test_sigterm_during_setup_saves_at_step_one(tmp_path, monkeypatch,
                                                same_weights, keep_sigterm):
    """Both launchers, ``--mode flexrank_kd --steps 3 --ckpt-dir``, with a
    SIGTERM sent before the calibration: one step, a blocking save at
    step 1, a return; the port's old handler is back afterwards."""
    monkeypatch.setattr(jtrain, "build_flexrank_state",
                        _sigterm_first(jtrain.build_flexrank_state))
    monkeypatch.setattr(ttrain, "build_flexrank_state",
                        _sigterm_first(ttrain.build_flexrank_state))
    args = SMALL + ["--mode", "flexrank_kd", "--steps", "3"]
    _, losses_j = jtrain.main(args + ["--ckpt-dir", str(tmp_path / "j")])
    signal.signal(signal.SIGTERM, keep_sigterm)
    _, losses_t = ttrain.main(args + ["--device", "cpu", "--ckpt-dir",
                                      str(tmp_path / "t")])
    assert signal.getsignal(signal.SIGTERM) is keep_sigterm
    assert len(losses_j) == len(losses_t) == 1
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-3)
    assert sorted(os.listdir(tmp_path / "j")) == ["step_000000001"]
    assert CheckpointManager(str(tmp_path / "t")).all_steps() == [1]


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
def test_sigterm_during_final_eval_kills_nothing(package, monkeypatch,
                                                 keep_sigterm):
    """A SIGTERM sent from the first call of the elastic eval after the
    last step: the run completes, every step's loss is returned, and the
    process lives on."""
    fr, main = ((JFR, jtrain.main) if package == "repro" else
                (TFR, lambda a: ttrain.main(a + ["--device", "cpu"])))
    calls = []

    def signalling(*args, **kw):
        if not calls:
            os.kill(os.getpid(), signal.SIGTERM)
        calls.append(1)
        return orig(*args, **kw)
    orig = fr.eval_budget_loss
    monkeypatch.setattr(fr, "eval_budget_loss", signalling)
    _, losses = main(SMALL + ["--mode", "flexrank_kd", "--steps", "2"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert len(calls) > 1            # every row was evaluated
    if package == "repro_torch":
        assert signal.getsignal(signal.SIGTERM) is keep_sigterm


def test_mesh_shape_4_1_trains_as_without_it(same_weights, capsys):
    """``--mesh-shape 4,1`` on one device: the port's losses are its own
    run's without the flag, bit for bit, and the reference's within
    1e-3."""
    args = SMALL + ["--mode", "dense", "--steps", "2"]
    _, plain = ttrain.main(args + ["--device", "cpu"])
    _, meshed = ttrain.main(args + ["--device", "cpu", "--mesh-shape",
                                    "4,1"])
    assert "[mesh] 4,1 -> {'data': 1, 'model': 1} on cpu" in \
        capsys.readouterr().out
    assert meshed == plain
    _, ref = jtrain.main(args + ["--mesh-shape", "4,1"])
    np.testing.assert_allclose(meshed, ref, rtol=1e-3)


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
def test_mesh_shape_2_2_fails_in_both(package):
    main = (jtrain.main if package == "repro" else
            lambda a: ttrain.main(a + ["--device", "cpu"]))
    with pytest.raises(AssertionError,
                       match="1 devices cannot host model dim 2"):
        main(SMALL + ["--steps", "1", "--mesh-shape", "2,2"])


@pytest.mark.parametrize("shape, names", [
    ((4, 1), ("data", "model")), ((4,), ("data",)), ((1, 1),
                                                     ("data", "model")),
    ((2, 2), ("data", "model")), ((3, 1, 1), ("pod", "data", "model"))])
def test_elastic_remesh_on_one_device_matches_jax(shape, names):
    try:
        want = dict(jsharding.elastic_remesh(shape, names).shape)
    except AssertionError as e:
        with pytest.raises(AssertionError, match=str(e)):
            tdist.elastic_remesh(shape, names, devices=CPU)
        return
    mesh = tdist.elastic_remesh(shape, names, devices=CPU)
    assert mesh.shape == want and mesh.axis_names == names
    assert mesh.devices.size == 1 and mesh.devices.flat[0] == CPU[0]


@pytest.mark.parametrize("shape, n, want", [
    ((4, 1), 4, (4, 1)), ((8, 2), 4, (2, 2)), ((1, 3), 6, (2, 3)),
    ((2, 2, 2), 8, (2, 2, 2)), ((2, 2), 3, None), ((1, 4), 6, None)])
def test_elastic_remesh_arithmetic(shape, n, want):
    """The leading axis takes what the model axes leave of ``n`` devices;
    a model dimension that does not divide ``n`` fails."""
    devs = [torch.device("cpu")] * n
    names = ("pod", "data", "model")[-len(shape):]
    if want is None:
        with pytest.raises(AssertionError, match="cannot host model dim"):
            tdist.elastic_remesh(shape, names, devices=devs)
        return
    mesh = tdist.elastic_remesh(shape, names, devices=devs)
    assert mesh.devices.shape == want
    assert mesh.shape == dict(zip(names, want))


def test_meshes_match_jax():
    assert tmesh.single_device_mesh("cpu").shape == dict(
        jmesh.single_device_mesh().shape)
    assert tmesh.make_mesh((1, 1), ("data", "model"), CPU).shape == dict(
        jmesh.make_mesh((1, 1), ("data", "model")).shape)
    for make in (jmesh.make_mesh, tmesh.make_mesh):
        with pytest.raises(AssertionError):
            make((2, 1), ("data", "model"),
                 None if make is jmesh.make_mesh else CPU)
    with pytest.raises(ValueError, match="2 mesh axes, 1 names"):
        tdist.Mesh(tdist.device_array(CPU, (1, 1)), ("data",))


def test_timed_step_returns_the_output_and_its_seconds():
    x = torch.arange(6.0)
    out, secs = tdist.timed_step(lambda a, k: (a * k, {"y": [a + k]}), x,
                                 k=2.0)
    ref_out, ref_secs = jsharding.timed_step(lambda a, k: (a * k, {"y": [
        a + k]}), np.arange(6.0, dtype=np.float32), k=2.0)
    assert torch.equal(out[0], torch.as_tensor(np.asarray(ref_out[0])))
    assert torch.equal(out[1]["y"][0],
                       torch.as_tensor(np.asarray(ref_out[1]["y"][0])))
    assert secs >= 0.0 and ref_secs >= 0.0
