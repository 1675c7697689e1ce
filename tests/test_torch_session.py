"""The port's streaming front door against the JAX engine's, on the CPU.

``ElasticEngine.serve_session`` serves a ``serving.session.StreamSession``
on a worker thread while clients submit and consume on an event loop,
with and without lookahead. Mirrors the streaming half of
``tests/test_async_engine.py``, with tolerance 0 on tokens: streamed
tokens arrive once each, in order, and equal the JAX engine's batch
streams; mid-stream and pre-admission cancels unwind and free their slots,
with the JAX engine's session run's ``cancelled`` flags and surviving
streams; a cancel lands mid speculative round; a slow consumer under
``stream_buffer=1`` is held back without losing a token; and the serving
launcher runs ``--stream --lookahead --arrival-rate 20 --cancel-nth 3``.

Every wait on the worker thread or the event loop is bounded, so a
deadlock fails the test instead of hanging the run. Shares the fixtures and
helpers of ``test_torch_async_engine.py``.
"""
import asyncio
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from repro_torch.serving.session import StreamSession
from repro_torch.spec import SpecConfig
from test_torch_async_engine import (MIX, _built_states, jax_engine,
                                     jax_streams, port_engine, requests,
                                     states, streams)  # noqa: F401

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 60.0          # bound on every wait for the engine thread
CANCELS = {2: 2, 5: 0}  # request -> cancel after this many tokens


def run_session(eng, reqs, session_cls=StreamSession, cancel_after=None,
                buffer=8, consumer_sleep=0.0):
    """Serve ``reqs`` through a session on a worker thread, every request
    submitted at once by its own client; returns per request (streamed
    tokens, Result, peak queue depth). ``cancel_after``: request -> cancel
    after that many tokens (0: before admission)."""
    errors = []

    def serve(session):
        try:
            eng.serve_session(session)
        except BaseException as e:        # surfaced by the test below
            errors.append(e)
            raise

    async def client(session, i, rq):
        ca = (cancel_after or {}).get(i)
        h = session.submit(rq)
        if ca == 0:
            h.cancel()
        toks, qpeak = [], 0
        async for tok in h.tokens():
            qpeak = max(qpeak, h.queue.qsize())
            toks.append(tok)
            if consumer_sleep:
                await asyncio.sleep(consumer_sleep)
            if ca is not None and len(toks) >= ca:
                h.cancel()
        return toks, await h.wait_result(), qpeak

    async def main():
        session = session_cls(stream_buffer=buffer)
        session.loop = asyncio.get_running_loop()
        worker = threading.Thread(target=serve, args=(session,),
                                  daemon=True)
        worker.start()
        try:
            outs = await asyncio.wait_for(
                asyncio.gather(*[client(session, i, r)
                                 for i, r in enumerate(reqs)]), WAIT_S)
        finally:
            session.close()
        await asyncio.wait_for(session.join(), WAIT_S)
        worker.join(WAIT_S)
        assert not worker.is_alive(), "the engine thread did not finish"
        return outs

    try:
        return asyncio.run(main())
    finally:
        assert not errors, errors


@pytest.fixture(scope="module")
def jax_batch(states):
    """The JAX engine's synchronous batch streams of MIX."""
    return jax_streams(MIX)


@pytest.fixture(scope="module")
def jax_cancelled(states):
    """The JAX engine's session run with CANCELS: (cancelled flags,
    streams of the requests that survived)."""
    from repro.serving import Request as JaxRequest
    from repro.serving import SamplingParams as JaxSampling
    from repro.serving.session import StreamSession as JaxSession
    cfg = states[0][0]
    reqs = requests(cfg, MIX, JaxRequest, JaxSampling)
    outs = run_session(jax_engine(), reqs, JaxSession, cancel_after=CANCELS,
                       buffer=1)
    flags = [res.cancelled for _, res, _ in outs]
    survivors = {i: toks for i, (toks, res, _) in enumerate(outs)
                 if not res.cancelled}
    return flags, survivors


def _port_requests():
    from repro_torch.serving import Request, SamplingParams
    return requests(_built_states()[1][0], MIX, Request, SamplingParams)


@pytest.mark.parametrize("lookahead", [False, True])
def test_stream_token_order_matches_batch(states, jax_batch, lookahead):
    """Streamed tokens arrive exactly once, in order, and equal both the
    final Result and the JAX engine's batch streams."""
    reqs = _port_requests()
    eng = port_engine(states, lookahead=lookahead)
    outs = run_session(eng, reqs)
    for i, (toks, res, _) in enumerate(outs):
        assert res is not None and not res.cancelled
        assert toks == streams([reqs[i]], [res])[0]
        assert toks == jax_batch[i]
    looked = eng.last_metrics.summary()["lookahead_iterations"]
    assert (looked > 0) == lookahead


@pytest.mark.parametrize("lookahead", [False, True])
def test_cancellation_unwinds_and_frees_slots(states, jax_batch,
                                              jax_cancelled, lookahead):
    """A mid-stream cancel and one before admission give cancelled Results
    whose tokens extend what was streamed and are a prefix of the batch
    stream; the survivors complete unchanged, which needs the cancelled
    slots to free (max_batch 2, 6 requests). The flags and surviving
    streams equal the JAX engine's session run's. ``stream_buffer=1``
    keeps the engine at most a token or two ahead of a client, so the
    cancel lands before request 2's last token."""
    reqs = _port_requests()
    eng = port_engine(states, lookahead=lookahead)
    outs = run_session(eng, reqs, cancel_after=CANCELS, buffer=1)
    flags, survivors = jax_cancelled
    assert [res.cancelled for _, res, _ in outs] == flags
    for i, (toks, res, _) in enumerate(outs):
        gen = streams([reqs[i]], [res])[0]
        if i in CANCELS:
            assert res.cancelled
            assert len(gen) < len(jax_batch[i])
            assert gen == jax_batch[i][:len(gen)]
            assert gen[:len(toks)] == toks
        else:
            assert not res.cancelled
            assert toks == gen == jax_batch[i] == survivors[i]
    assert eng.last_metrics.summary()["cancellations"] == 2


def test_cancellation_mid_spec_round(states):
    """A cancel of a request seated in the speculative decoder frees its
    slot pair at the next round boundary; the survivors equal the JAX
    engine's speculative batch streams."""
    from repro.serving import Request as JaxRequest
    from repro.serving import SamplingParams as JaxSampling
    from repro.serving import SpecConfig as JaxSpec
    cfg = states[0][0]
    jreqs = requests(cfg, MIX, JaxRequest, JaxSampling)
    want = streams(jreqs, jax_engine(spec=JaxSpec(
        draft_rank=0.9, spec_len=3)).generate(jreqs))
    reqs = _port_requests()
    eng = port_engine(states, spec=SpecConfig(draft_rank=0.9, spec_len=3))
    outs = run_session(eng, reqs, cancel_after={0: 2}, buffer=1)
    for i, (toks, res, _) in enumerate(outs):
        assert res.cancelled == (i == 0)
        if i:
            assert toks == want[i]
    assert eng.last_metrics.summary()["spec_rounds"] > 0


def test_slow_consumer_backpressure(states, jax_batch):
    """A stream_buffer of 1 bounds the engine-to-client pipeline: the
    handle never holds more than one undelivered token, and every token
    still arrives in order (the engine blocks; it drops nothing)."""
    reqs = _port_requests()[:3]
    eng = port_engine(states, lookahead=True)
    outs = run_session(eng, reqs, buffer=1, consumer_sleep=0.01)
    for i, (toks, _, qpeak) in enumerate(outs):
        assert toks == jax_batch[i]
        assert qpeak <= 1


def test_launcher_stream_lookahead_on_cpu():
    """README quickstart step 4 on the CPU: open-loop Poisson arrivals at
    20 requests/s, every third request cancelled after two tokens, the
    pipelined engine streaming each token."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
           "--device", "cpu", "--stream", "--lookahead", "--arrival-rate",
           "20", "--cancel-nth", "3", "--requests", "6", "--budgets",
           "0.4,1.0", "--max-new", "6", "--prefill-chunk", "8"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    for i in range(6):
        state = "cancelled" if i in (2, 5) else "done"
        assert any(ln.startswith(f"req {i}: {state},") for ln in lines), i
    assert sum("cancelling mid-stream" in ln for ln in lines) == 2
    assert any(ln.startswith("# lookahead:") for ln in lines)
    assert any(ln.startswith("# serving:") for ln in lines)
