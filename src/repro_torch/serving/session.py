"""Asyncio streaming front door for the elastic engine.

One ``StreamSession`` connects an asyncio event loop full of clients to an
engine running in a worker thread. Clients ``submit()`` requests open-loop
(no batching, no draining) and consume generated tokens one at a time from
the returned ``StreamHandle``'s async iterator; the engine pulls submissions
out of the session at commit boundaries (``ElasticEngine.serve_session``)
and pushes every committed token back as it lands.

Threading model — exactly two sides, one crossing each way:

  * **loop -> engine**: submissions and cancellations land in a mutex-guarded
    list / a monotone cancellation log on the engine (``ElasticEngine.cancel``
    is thread-safe) and a ``threading.Event`` wakes the engine's idle wait.
  * **engine -> loop**: tokens cross via a bounded per-request
    ``asyncio.Queue`` fed with ``asyncio.run_coroutine_threadsafe``. The put
    BLOCKS the engine thread while the client's buffer is full — that is the
    backpressure: a slow consumer stalls the commit loop instead of growing
    an unbounded buffer (pinned by tests/test_torch_session.py). The wait
    polls the handle's cancellation flag so a consumer that gives up never
    wedges the engine.

Preemption-recompute interplay: the engine discards a preemption victim's
generated tokens and replays them bit-identically on recompute. Tokens
already streamed must not be delivered twice, so every ``emit`` carries the
token's index in the sequence's generated list and the handle drops indices
it has already delivered — the client sees each position exactly once, in
order, regardless of how many recompute attempts produced it.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import threading
from typing import List, Optional, Tuple

__all__ = ["StreamHandle", "StreamSession", "stream_request"]


class _Done:
    """Queue sentinel carrying the request's final Result."""

    def __init__(self, result):
        self.result = result


class StreamHandle:
    """One submitted request's client-side end: an async token stream plus
    thread-safe cancellation. ``req_id`` is assigned when the engine drains
    the submission (None until then); ``result`` holds the final
    ``serving.Result`` once the stream ends."""

    def __init__(self, session: "StreamSession", request, maxsize: int):
        self.request = request
        self.req_id: Optional[int] = None
        self.queue: "asyncio.Queue" = asyncio.Queue(maxsize=maxsize)
        self.emitted = 0            # delivered tokens (dedups recompute replays)
        self.result = None
        self.cancelled = threading.Event()
        self._session = session

    async def tokens(self):
        """Async iterator over generated token ids, one at a time, in
        commit order. Terminates when the request finishes or its
        cancellation takes effect; ``self.result`` is set on termination."""
        while True:
            item = await self.queue.get()
            if isinstance(item, _Done):
                # a cancellation drain may sentinel with result=None before
                # the engine's cancelled Result lands on the handle — never
                # let that overwrite a real result
                if item.result is not None:
                    self.result = item.result
                return
            yield item

    def cancel(self) -> None:
        """Thread-safe, idempotent: stop streaming immediately and ask the
        engine to unwind the request (frees its slot and blocks, rolls back
        any in-flight lookahead that assumed it). Tokens already queued are
        discarded; the stream terminates with a cancelled Result."""
        self.cancelled.set()
        self._session._cancel_handle(self)

    async def wait_result(self, poll_s: float = 0.005):
        """Await the request's final Result. The cancel path terminates the
        token iterator on the loop thread immediately, racing the engine's
        unwind — this is the rendezvous with the real (cancelled) Result,
        which the engine produces at its next plan boundary. Returns None
        only if the session shut down without the engine ever seeing the
        request."""
        while self.result is None and not self._session._done.is_set():
            await asyncio.sleep(poll_s)
        return self.result


class StreamSession:
    """The loop<->engine rendezvous. Construct on (or pass) the event loop,
    hand it to ``ElasticEngine.serve_session`` on a worker thread, and
    ``submit``/``close`` from the loop side."""

    def __init__(self, loop=None, stream_buffer: int = 8):
        if stream_buffer < 1:
            raise ValueError(f"stream_buffer must be >= 1, got {stream_buffer}")
        self.loop = loop
        self.stream_buffer = stream_buffer
        self.closed = False
        self._engine = None
        self._lock = threading.Lock()
        self._new: List[StreamHandle] = []
        self._by_id: dict = {}
        self._work = threading.Event()
        self._done = threading.Event()

    # ------------------------------------------------ client (loop) side

    def submit(self, request) -> StreamHandle:
        if self.closed:
            raise RuntimeError("session closed")
        if self.loop is None:
            self.loop = asyncio.get_running_loop()
        h = StreamHandle(self, request, self.stream_buffer)
        with self._lock:
            self._new.append(h)
        self._work.set()
        return h

    def close(self) -> None:
        """No further submissions; the engine drains in-flight work and
        ``serve_session`` returns."""
        self.closed = True
        self._work.set()

    async def join(self, poll_s: float = 0.01) -> None:
        """Await the engine side finishing (after ``close()``)."""
        while not self._done.is_set():
            await asyncio.sleep(poll_s)

    def _cancel_handle(self, h: StreamHandle) -> None:
        if h.req_id is not None and self._engine is not None:
            self._engine.cancel(h.req_id)
        if self.loop is not None:
            # terminate the client's iterator NOW, on the loop thread:
            # discard buffered tokens and sentinel the queue — the engine
            # must never be needed to unblock a cancelled consumer
            self.loop.call_soon_threadsafe(self._drain_cancelled, h)
        self._work.set()        # wake the engine if it is idle

    @staticmethod
    def _drain_cancelled(h: StreamHandle) -> None:
        while True:
            try:
                h.queue.get_nowait()
            except asyncio.QueueEmpty:
                break
        try:
            h.queue.put_nowait(_Done(h.result))
        except asyncio.QueueFull:       # a concurrent put raced the drain
            pass

    # ---------------------------------------------- engine (worker) side

    def bind(self, engine) -> None:
        self._engine = engine

    def mark_done(self) -> None:
        self._done.set()

    def wait_for_work(self, timeout: float) -> None:
        self._work.wait(timeout)
        self._work.clear()

    def drain_new(self) -> List[Tuple[object, StreamHandle]]:
        """Pull pending submissions (engine thread, commit boundaries only).
        Already-cancelled submissions still flow through the scheduler —
        ``register`` forwards the cancel, so every drained handle gets a
        real Result from the engine (a zero-token cancelled one at worst)
        instead of a client-side synthetic."""
        with self._lock:
            new, self._new = self._new, []
        return [(h.request, h) for h in new]

    def register(self, handle: StreamHandle, req_id: int) -> None:
        """Bind a drained submission to its scheduler req_id. A cancel that
        raced the drain is forwarded to the engine now."""
        handle.req_id = req_id
        self._by_id[req_id] = handle
        if handle.cancelled.is_set():
            self._engine.cancel(req_id)

    def emit(self, req_id: int, index: int, token: int) -> None:
        """Deliver generated token ``index`` of request ``req_id``. Indices
        at or past the handle's delivered count stream out (blocking on a
        full buffer — the backpressure); earlier ones are recompute replays
        of already-delivered tokens and drop silently."""
        h = self._by_id.get(req_id)
        if h is None or h.cancelled.is_set():
            return
        if index < h.emitted:
            return
        assert index == h.emitted, (req_id, index, h.emitted)
        h.emitted += 1
        self._deliver(h, int(token))

    def finish(self, req_id: int, result) -> None:
        """Terminate the request's stream with its final Result."""
        h = self._by_id.pop(req_id, None)
        if h is None:
            return
        h.result = result
        self._deliver(h, _Done(result))

    def _deliver(self, h: StreamHandle, item) -> None:
        """Blocking put from the engine thread into the handle's bounded
        queue, polling the cancellation flag so an abandoned consumer never
        wedges the engine."""
        if self.loop is None:
            return
        fut = asyncio.run_coroutine_threadsafe(h.queue.put(item), self.loop)
        while True:
            try:
                fut.result(0.05)
                return
            except (TimeoutError, concurrent.futures.TimeoutError):
                if h.cancelled.is_set():
                    fut.cancel()
                    return
            except asyncio.CancelledError:
                return


async def stream_request(session: StreamSession, request,
                         cancel_after: Optional[int] = None):
    """Submit ``request`` and consume its stream to the end. Returns
    ``(tokens, result)``. With ``cancel_after`` set, cancels the handle
    after that many tokens arrive (the mid-stream-cancellation client used
    by the serve smoke test and the unit tests)."""
    h = session.submit(request)
    toks = []
    async for t in h.tokens():
        toks.append(t)
        if cancel_after is not None and len(toks) >= cancel_after:
            h.cancel()
    return toks, await h.wait_result()
