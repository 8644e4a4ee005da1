"""Stdlib HTTP endpoint for live observability.

``serve(port)`` binds a :class:`http.server.ThreadingHTTPServer` on a
daemon thread (named ``da4ml-obs-server``) and enables the metrics
registry so scrapes see data. Three routes:

- ``GET /metrics``  — OpenMetrics text (:mod:`.openmetrics`)
- ``GET /healthz``  — JSON health document; HTTP 200 when ``ok``,
  503 when ``degraded``
- ``GET /statusz``  — JSON status document (scheduler occupancy, active
  spans, devices, ...)

Off by default: no server object exists and no thread is spawned until
``serve()`` runs (``telemetry.serve(port)``, ``DA4ML_METRICS_PORT``, or
``da4ml-tpu-torch monitor``). Fork-safe: the serving thread never survives a
fork, and a forked child's ``serve()`` starts a fresh server rather than
touching the parent's socket. Providers are injectable so
``da4ml-tpu-torch monitor --follow`` can serve metrics mirrored from another
process's streaming trace instead of this process's registry.

Counterpart of ``da4ml_tpu/telemetry/obs/server.py``.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlsplit

from .openmetrics import CONTENT_TYPE, render_openmetrics

_lock = threading.Lock()
_server: 'ObsServer | None' = None
_atexit_registered = False


class ObsServer:
    def __init__(
        self,
        port: int,
        host: str = '127.0.0.1',
        metrics_provider=None,
        health_provider=None,
        status_provider=None,
    ):
        from .health import health_snapshot, status_snapshot

        self.metrics_provider = metrics_provider or (lambda: render_openmetrics())
        self.health_provider = health_provider or health_snapshot
        self.status_provider = status_provider or status_snapshot
        self._pid = os.getpid()
        obs = self

        class _Handler(BaseHTTPRequestHandler):
            server_version = 'da4ml-obs'
            protocol_version = 'HTTP/1.1'

            def log_message(self, fmt, *args):  # quiet: scrapes are periodic
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header('Content-Type', ctype)
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = urlsplit(self.path).path
                try:
                    if path == '/metrics':
                        body = obs.metrics_provider().encode()
                        self._send(200, body, CONTENT_TYPE)
                    elif path == '/healthz':
                        doc = obs.health_provider()
                        code = 200 if doc.get('status') == 'ok' else 503
                        self._send(code, json.dumps(doc, indent=1, default=str).encode(), 'application/json')
                    elif path == '/statusz':
                        doc = obs.status_provider()
                        self._send(200, json.dumps(doc, indent=1, default=str).encode(), 'application/json')
                    elif path in ('/', ''):
                        body = b'da4ml_tpu_torch observability: /metrics /healthz /statusz\n'
                        self._send(200, body, 'text/plain; charset=utf-8')
                    else:
                        self._send(404, b'not found\n', 'text/plain; charset=utf-8')
                except Exception as e:  # a broken provider must not kill the thread
                    try:
                        self._send(500, f'internal error: {type(e).__name__}: {e}\n'.encode(), 'text/plain; charset=utf-8')
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        # a live endpoint arms real spans (no sink needed) so /statusz can
        # show what the process is doing right now
        from ..core import add_span_watcher

        add_span_watcher()
        self._watching = True
        self._thread = threading.Thread(target=self._httpd.serve_forever, name='da4ml-obs-server', daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f'http://{self.host}:{self.port}'

    def close(self) -> None:
        if self._watching:
            self._watching = False
            from ..core import remove_span_watcher

            remove_span_watcher()
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass


def serve(
    port: int | None = None,
    host: str = '127.0.0.1',
    metrics_provider=None,
    health_provider=None,
    status_provider=None,
) -> ObsServer:
    """Start (or return the already-running) observability endpoint.

    ``port=None`` reads ``DA4ML_METRICS_PORT`` (0 = ephemeral, surfaced via
    ``server.port``). Enables the metrics registry — a live endpoint with
    an empty registry would be useless.
    """
    global _server, _atexit_registered
    from ..metrics import enable_metrics

    with _lock:
        if _server is not None and _server._pid == os.getpid():
            return _server
        if port is None:
            try:
                port = int(os.environ.get('DA4ML_METRICS_PORT', '') or 0)
            except ValueError:
                port = 0
        enable_metrics()
        _server = ObsServer(
            port,
            host,
            metrics_provider=metrics_provider,
            health_provider=health_provider,
            status_provider=status_provider,
        )
        if not _atexit_registered:
            # drain the serving socket at interpreter exit instead of
            # abandoning the daemon thread mid-write; _stop_at_exit checks
            # the owning pid, so a forked child never closes its parent's
            # socket
            atexit.register(_stop_at_exit)
            _atexit_registered = True
        return _server


def server_port() -> int | None:
    """The bound port of this process's endpoint, or None when not serving."""
    s = _server
    return s.port if s is not None and s._pid == os.getpid() else None


def stop_server() -> None:
    """Shut the endpoint down (test isolation; production servers live
    until interpreter exit, where the atexit hook drains them)."""
    global _server
    with _lock:
        s, _server = _server, None
    if s is not None:
        s.close()


def _stop_at_exit() -> None:
    """atexit hook: close this process's server only (fork-safe — a child
    inherits ``_server`` but must not shut down the parent's socket)."""
    s = _server
    if s is not None and s._pid == os.getpid():
        stop_server()
