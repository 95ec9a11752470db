"""Tiny stdlib HTTP endpoint serving a worker's telemetry.

One :class:`MetricsServer` per worker, on a daemon thread:

  - ``GET /metrics``       Prometheus text exposition (0.0.4)
  - ``GET /metrics.json``  full registry snapshot + recent spans/events
  - ``GET /healthz``       ``ok`` (liveness)

``port=0`` binds an ephemeral port (the bound port is on ``.port``),
which is what the tests use to avoid collisions.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .export import snapshot_dict, to_prometheus

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    def __init__(self, telemetry, host: str = "127.0.0.1", port: int = 0):
        self.telemetry = telemetry
        tel = telemetry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (stdlib API)
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = to_prometheus(tel.registry).encode()
                    ctype = PROM_CONTENT_TYPE
                elif path == "/metrics.json":
                    body = json.dumps(
                        snapshot_dict(tel, spans=128, events=128)
                    ).encode()
                    ctype = "application/json"
                elif path == "/healthz":
                    body, ctype = b"ok\n", "text/plain"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args) -> None:
                pass  # scrapes should not spam stdout

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "MetricsServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.1},
                daemon=True,
                name=f"metrics-server-{self.port}",
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
