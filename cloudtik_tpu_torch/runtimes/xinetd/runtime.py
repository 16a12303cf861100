"""Health-exposure runtime: serve every runtime's health check over HTTP.

Reference parity: runtime/xinetd (SURVEY.md §2.3 — 516 LoC; per-runtime
health-check scripts exposed as TCP services consumed by LBs;
Runtime.get_health_check core/runtime.py:237).  Instead of xinetd spawning
shell scripts per connection, one HealthCheckServer (runtimes/common/
health_check.py) serves all checks: GET /<runtime> -> 200/503.
"""

from __future__ import annotations

from typing import Any, Dict

from cloudtik_tpu_torch.runtimes.common.health_check import (
    HealthCheckServer, tcp_port_check)
from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    ALL_NODES, ServiceRuntimeBase)

HEALTH_PORT = 8099


def build_health_server(config: Dict[str, Any], host: str = "0.0.0.0",
                        port: int = HEALTH_PORT) -> HealthCheckServer:
    """Collect get_health_check() from every configured runtime into one
    server (tcp-connect checks against each runtime's declared port)."""
    from cloudtik_tpu_torch.runtimes.registry import iter_runtimes
    server = HealthCheckServer(host=host, port=port)
    for runtime in iter_runtimes(config):
        hc = runtime.get_health_check(config)
        if hc is None:
            continue
        server.register(hc.name, tcp_port_check("127.0.0.1", hc.port))
    return server


# Process-wide server registry: runtime instances are re-created per
# start/stop invocation (services.py builds runtimes afresh in stop()), so
# the live server must outlive any one instance; keyed by
# ServiceRuntimeBase.instance_key.
_servers: Dict[tuple, HealthCheckServer] = {}


class XinetdRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "health"
    DEFAULT_PORT = HEALTH_PORT
    PROTOCOL = "http"
    NODE_KIND = ALL_NODES
    PROCESS_KEYWORD = "tik-health"

    def node_services(self, node_context: Dict[str, Any],
                      command: str) -> None:
        key = self.instance_key(node_context)
        if command == "start" and key not in _servers:
            server = build_health_server(
                node_context.get("config") or {}, port=self.port)
            server.start()
            _servers[key] = server
        elif command == "stop":
            server = _servers.pop(key, None)
            if server is not None:
                server.stop()

    def get_health_check(self, cluster_config):
        return None  # the health server doesn't health-check itself
