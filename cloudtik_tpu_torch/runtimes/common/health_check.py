"""Health-check service: expose per-runtime checks over TCP/HTTP.

Reference parity: runtime/common/health_check.py + the xinetd runtime
(SURVEY.md §2.3 — per-runtime health scripts served as TCP services,
consumed by load balancers; Runtime.get_health_check core/runtime.py:237).
Instead of xinetd spawning shell scripts, one small HTTP server serves all
registered checks: GET /<name> -> 200 "passing" | 503 "critical".
"""

from __future__ import annotations

import http.server
import socketserver
import threading
from typing import Callable, Dict, Optional, Tuple

CheckFn = Callable[[], Tuple[bool, str]]


def tcp_port_check(host: str, port: int, timeout: float = 2.0) -> CheckFn:
    """Passing iff a TCP connect succeeds (the common LB check)."""
    def _check():
        import socket
        try:
            with socket.create_connection((host, port), timeout=timeout):
                return True, f"tcp {host}:{port} connect ok"
        except OSError as e:
            return False, f"tcp {host}:{port} failed: {e}"
    return _check


def process_check(keyword: str) -> CheckFn:
    """Passing iff a process whose cmdline contains `keyword` is running."""
    def _check():
        try:
            import psutil
        except ImportError:
            return False, "psutil unavailable"
        for proc in psutil.process_iter(["cmdline"]):
            try:
                if keyword in " ".join(proc.info["cmdline"] or []):
                    return True, f"process {keyword!r} running"
            except (psutil.NoSuchProcess, psutil.AccessDenied):
                continue
        return False, f"process {keyword!r} not found"
    return _check


class HealthCheckServer:
    """Serves all registered checks on one port."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self._checks: Dict[str, CheckFn] = {}
        self._lock = threading.Lock()
        checks = self._checks
        lock = self._lock

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                name = self.path.strip("/")
                with lock:
                    fn = checks.get(name)
                if fn is None:
                    self.send_response(404)
                    body = b"unknown check"
                else:
                    try:
                        ok, detail = fn()
                    except Exception as e:
                        ok, detail = False, f"check raised: {e}"
                    self.send_response(200 if ok else 503)
                    body = detail.encode()
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def register(self, name: str, check: CheckFn) -> None:
        with self._lock:
            self._checks[name] = check

    def deregister(self, name: str) -> None:
        with self._lock:
            self._checks.pop(name, None)

    def run_check(self, name: str) -> Tuple[bool, str]:
        with self._lock:
            fn = self._checks.get(name)
        if fn is None:
            return False, "unknown check"
        return fn()

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="tik-health",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
