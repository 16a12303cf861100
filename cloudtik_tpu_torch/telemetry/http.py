"""Telemetry HTTP exposition: /metrics, /trace, /trace/summary.

A tiny stdlib server any tik process can start (nodex exporter on every
node, head services on the head).  The `tik trace export|summary` and
`tik metrics dump` CLI subcommands fetch from it.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from cloudtik_tpu_torch.telemetry import export


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):  # quiet
        pass

    def _send(self, code: int, body: str,
              content_type: str = "text/plain; charset=utf-8") -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        path = self.path.split("?", 1)[0]
        if path in ("/-/healthy", "/-/ready", "/healthz"):
            self._send(200, "OK")
        elif path == "/metrics":
            self._send(200, export.render_prometheus())
        elif path == "/trace":
            self._send(200, json.dumps(export.chrome_trace()),
                       "application/json")
        elif path == "/trace/summary":
            self._send(200, json.dumps(export.trace_summary()),
                       "application/json")
        else:
            self._send(404, "not found")


class TelemetryServer:
    """ThreadingHTTPServer wrapper with a daemon serve thread."""

    def __init__(self, port: int, host: str = "0.0.0.0"):
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "TelemetryServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="tik-telemetry-http")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def start_server(port: int, host: str = "0.0.0.0") -> TelemetryServer:
    """Start serving telemetry on `port` (0 picks a free port)."""
    return TelemetryServer(port, host).start()
