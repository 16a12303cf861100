"""HAProxy runtime: L4 load balancer with discovery-fed backends.

Reference parity: runtime/haproxy (SURVEY.md §2.3 — 1,608 LoC; backends
auto-populated from service discovery via per-runtime discovery.py).
`render_haproxy_cfg` is pure; the runtime resolves backends from the
cluster registry each configure pass.
"""

from __future__ import annotations

from typing import Any, Dict, List

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    HEAD, ServiceRuntimeBase)

HAPROXY_PORT = 80
STATS_PORT = 8404


def render_haproxy_cfg(frontends: List[Dict[str, Any]],
                       stats_port: int = STATS_PORT) -> str:
    """frontends: [{name, bind_port, backends: [{name, ip, port}],
    mode?, balance?}]."""
    out = [
        "global",
        "  maxconn 4096",
        "  log stdout format raw local0",
        "defaults",
        "  mode tcp",
        "  timeout connect 5s",
        "  timeout client 30s",
        "  timeout server 30s",
        "listen stats",
        f"  bind *:{stats_port}",
        "  mode http",
        "  stats enable",
        "  stats uri /stats",
    ]
    for fe in frontends:
        name = fe["name"]
        mode = fe.get("mode", "tcp")
        out += [
            f"frontend {name}_fe",
            f"  bind *:{fe['bind_port']}",
            f"  mode {mode}",
            f"  default_backend {name}_be",
            f"backend {name}_be",
            f"  mode {mode}",
            f"  balance {fe.get('balance', 'roundrobin')}",
        ]
        for be in sorted(fe.get("backends", []),
                         key=lambda b: (b["name"], b["ip"])):
            out.append(f"  server {be['name']} {be['ip']}:{be['port']} "
                       "check")
    return "\n".join(out) + "\n"


BIND_PORT_OFFSET = 10000


def backends_from_registry(registry, service_names: List[str],
                           port_offset: int = BIND_PORT_OFFSET,
                           bind_ports: Dict[str, int] = None
                           ) -> List[Dict[str, Any]]:
    """Frontend specs for each discovered service.  Frontends bind at
    service_port + port_offset (haproxy runs on the head, where primaries
    of head-hosted services already listen on their own ports); an explicit
    bind_ports map overrides per service."""
    from cloudtik_tpu_torch.runtimes.common.discovery_client import (
        discover_service)
    frontends = []
    for name in service_names:
        addrs = discover_service(registry, name)
        if not addrs:
            continue
        bind = (bind_ports or {}).get(name, addrs[0].port + port_offset)
        frontends.append({
            "name": name.replace("-", "_"),
            "bind_port": bind,
            "backends": [{"name": a.node_id or f"{a.host}",
                          "ip": a.host, "port": a.port}
                         for a in addrs],
        })
    return frontends


class HAProxyRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "haproxy"
    BINARY = "haproxy"
    CONF_FILE = "haproxy.cfg"
    SERVICE_ARGS = ("{binary}", "-f", "{conf}", "-db")
    DEFAULT_PORT = HAPROXY_PORT
    NODE_KIND = HEAD
    PROCESS_KEYWORD = "haproxy"

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        if not self.runs_on(node_context):
            return
        import os
        state = node_context.get("state_client")
        config = node_context.get("config", {})
        frontends: List[Dict[str, Any]] = []
        if state is not None:
            from cloudtik_tpu_torch.runtimes.discovery.runtime import (
                ServiceRegistry)
            registry = ServiceRegistry(
                state, cluster=config.get("cluster_name", ""),
                workspace=config.get("workspace_name", ""))
            names = self.runtime_config.get("services") or sorted(
                {svc["name"] for svc in registry.query()})
            frontends = backends_from_registry(
                registry, names,
                port_offset=int(self.runtime_config.get(
                    "port_offset", BIND_PORT_OFFSET)),
                bind_ports=self.runtime_config.get("bind_ports"))
        with open(os.path.join(self.conf_dir(node_context),
                               "haproxy.cfg"), "w") as f:
            f.write(render_haproxy_cfg(frontends))
