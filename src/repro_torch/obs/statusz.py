"""Live status server: stdlib ``http.server`` on a background thread.

Three read-only endpoints over the live telemetry plane:

  * ``GET /metrics``     — Prometheus text exposition of the engine's
    ``MetricsRegistry`` (scrape target).
  * ``GET /statusz``     — JSON snapshot of live engine state from the
    bound ``status_fn`` (per-request lifecycle states, queue depths, KV
    occupancy/fragmentation, prefix-cache hit rate, adaptive-k state,
    cost-model audit — see ``ElasticEngine.statusz``).
  * ``GET /debug/trace`` — flight-recorder dump from the bound
    ``trace_fn`` (``RingTracer.dump``) as Chrome trace JSON; add
    ``?last_s=N`` to window the dump.

Thread model: ``ThreadingHTTPServer`` handles each request on its own
daemon thread while the engine keeps running on the main thread. The
scraped structures are guarded where it matters (the tracer takes its
lock; registry children are plain float updates under the GIL) and the
``status_fn`` is built to tolerate racing the engine — handlers convert
any callback exception into a 500 with the traceback instead of killing
the serve. Port 0 binds an ephemeral port; read it back from ``.port``.
"""
from __future__ import annotations

import json
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

__all__ = ["StatusServer"]

_INDEX = """\
repro live telemetry plane
  GET /metrics      Prometheus text exposition
  GET /statusz      live engine state (JSON)
  GET /debug/trace  flight-recorder dump (Chrome trace JSON; ?last_s=N)
"""


class StatusServer:
    """Background-thread HTTP status server; see module docstring.

    All three data sources are optional — a missing one 404s its
    endpoint — so the server is usable from any mix of ``--statusz-port``
    with/without tracing or a registry.
    """

    def __init__(self, *,
                 registry=None,
                 status_fn: Optional[Callable[[], dict]] = None,
                 trace_fn: Optional[Callable[..., dict]] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.registry = registry
        self.status_fn = status_fn
        self.trace_fn = trace_fn
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            # one status scrape per second must not spam the serve log
            def log_message(self, *a):
                pass

            def do_GET(self):
                try:
                    outer._route(self)
                except BrokenPipeError:      # client went away mid-write
                    pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- routing

    def _route(self, h: BaseHTTPRequestHandler) -> None:
        url = urlparse(h.path)
        path = url.path.rstrip("/") or "/"
        if path == "/":
            _reply(h, 200, "text/plain; charset=utf-8", _INDEX)
        elif path == "/metrics":
            if self.registry is None:
                _reply(h, 404, "text/plain", "no metrics registry bound\n")
                return
            _guarded(h, lambda: (
                "text/plain; version=0.0.4; charset=utf-8",
                self.registry.prometheus_text()))
        elif path == "/statusz":
            if self.status_fn is None:
                _reply(h, 404, "text/plain", "no status source bound\n")
                return
            _guarded(h, lambda: (
                "application/json",
                json.dumps(self.status_fn(), indent=1, default=str) + "\n"))
        elif path == "/debug/trace":
            if self.trace_fn is None:
                _reply(h, 404, "text/plain", "no flight recorder bound\n")
                return
            qs = parse_qs(url.query)
            last_s = None
            if "last_s" in qs:
                try:
                    last_s = float(qs["last_s"][0])
                except ValueError:
                    _reply(h, 400, "text/plain",
                           f"bad last_s: {qs['last_s'][0]!r}\n")
                    return
            kw = {} if last_s is None else {"last_s": last_s}
            _guarded(h, lambda: (
                "application/json", json.dumps(self.trace_fn(**kw)) + "\n"))
        else:
            _reply(h, 404, "text/plain", f"unknown path {h.path!r}\n")

    # --------------------------------------------------------- lifecycle

    def start(self) -> int:
        """Start serving on a daemon thread; returns the bound port."""
        assert self._thread is None, "status server already started"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="repro-statusz", daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
            self._thread = None
        self._httpd.server_close()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def _reply(h: BaseHTTPRequestHandler, code: int, ctype: str,
           body: str) -> None:
    data = body.encode("utf-8")
    h.send_response(code)
    h.send_header("Content-Type", ctype)
    h.send_header("Content-Length", str(len(data)))
    h.end_headers()
    h.wfile.write(data)


def _guarded(h: BaseHTTPRequestHandler, produce) -> None:
    """Run a producer callback; any exception becomes a 500 instead of
    tearing down the handler thread (scrapes race the live engine)."""
    try:
        ctype, body = produce()
    except Exception:
        _reply(h, 500, "text/plain", traceback.format_exc())
        return
    _reply(h, 200, ctype, body)
