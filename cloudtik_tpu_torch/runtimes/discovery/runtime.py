"""Discovery runtime: service registry + naming on the head state store.

Reference parity: the consul runtime + core/_private/service_discovery/
(SURVEY.md §2.1/§2.3 — the reference ran a Consul server cluster with agents
everywhere; FQDN naming naming.py:28-156).  This build keeps the same
contract (`Runtime.get_runtime_services` registrations, `{cluster}-{seq}.
{workspace}.tik` names) but serves it from the head's own state server —
zero extra daemons; DNS runtimes can render the table when present.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from cloudtik_tpu_torch.control.state import StateClient, TABLE_SERVICES
from cloudtik_tpu_torch.core.runtime import Runtime

DOMAIN_SUFFIX = "tik"


def node_fqdn(cluster: str, workspace: str, seq_id: int) -> str:
    """`{cluster}-{seq}.{workspace}.tik` (reference naming.py:39)."""
    return f"{cluster}-{seq_id}.{workspace}.{DOMAIN_SUFFIX}"


def service_fqdn(service: str, cluster: str, workspace: str) -> str:
    return f"{service}.{cluster}.{workspace}.{DOMAIN_SUFFIX}"


class ServiceRegistry:
    """Register/query services in the state store."""

    def __init__(self, state_client: StateClient, cluster: str,
                 workspace: str):
        self.state = state_client
        self.cluster = cluster
        self.workspace = workspace

    def register(self, name: str, node_id: str, ip: str, port: int,
                 protocol: str = "tcp",
                 tags: Optional[Dict[str, str]] = None) -> None:
        key = f"{name}:{node_id}"
        self.state.table_put(TABLE_SERVICES, key, {
            "name": name,
            "fqdn": service_fqdn(name, self.cluster, self.workspace),
            "cluster": self.cluster,
            "workspace": self.workspace,
            "node_id": node_id,
            "ip": ip,
            "port": port,
            "protocol": protocol,
            "tags": tags or {},
            "time": time.time(),
        })

    def deregister(self, name: str, node_id: str) -> None:
        self.state.table_delete(TABLE_SERVICES, f"{name}:{node_id}")

    def query(self, name: Optional[str] = None,
              max_age_s: Optional[float] = None) -> List[Dict[str, Any]]:
        prefix = f"{name}:" if name else ""
        now = time.time()
        out = []
        for _key, svc in self.state.table_list(TABLE_SERVICES,
                                               prefix).items():
            if max_age_s and now - svc.get("time", 0) > max_age_s:
                continue
            out.append(svc)
        return out

    def services_by_name(self) -> Dict[str, Dict[str, Any]]:
        grouped: Dict[str, Dict[str, Any]] = {}
        for svc in self.query():
            entry = grouped.setdefault(svc["name"], {
                "name": svc["name"],
                "port": svc["port"],
                "protocol": svc["protocol"],
                "cluster": svc["cluster"],
                "nodes": [],
            })
            entry["nodes"].append({"node_id": svc["node_id"],
                                   "ip": svc["ip"]})
        return grouped


class DiscoveryRuntime(Runtime):
    """Head runtime: the registry lives in the state server; this runtime's
    service process is the *sync daemon* (discovery/sync.py) that renders
    the live registry into prometheus file-SD targets + DNS host files —
    the downstream consumers the reference fed from Consul
    (runtime/prometheus/discovery.py:62)."""

    def get_runtime_services(self, cluster_config, cluster_head_ip):
        return {"discovery": {
            "protocol": "tcp",
            "port": self.runtime_config.get("port", 6879),
            "node_kind": "head",
        }}

    def get_logs(self) -> Dict[str, str]:
        return {"discovery": "~/.tik/logs/discovery"}

    def get_processes(self) -> Optional[List[Tuple[str, bool, str, str]]]:
        return [("tik-state-server", True, "StateServer", "head"),
                ("cloudtik_tpu_torch.runtimes.discovery.sync", False,
                 "DiscoverySync", "head")]

    def node_services(self, node_context: Dict[str, Any],
                      command: str) -> None:
        """Spawn/stop the discovery-sync daemon on the head."""
        import sys
        from cloudtik_tpu_torch.runtimes.common import process_runner
        from cloudtik_tpu_torch.utils.constants import TIK_STATE_PORT_DEFAULT

        if not node_context.get("is_head"):
            return
        name = "discovery-sync"
        if command == "stop":
            process_runner.stop_service(name)
            return
        if command != "start":
            raise ValueError(f"unknown services command {command!r}")
        config = node_context.get("config", {})
        cmd = [sys.executable, "-m",
               "cloudtik_tpu_torch.runtimes.discovery.sync",
               "--head-ip", node_context.get("head_ip", "127.0.0.1"),
               "--state-port",
               str(config.get("state_port", TIK_STATE_PORT_DEFAULT)),
               "--cluster", config.get("cluster_name", ""),
               "--workspace", config.get("workspace_name", ""),
               "--interval",
               str(self.runtime_config.get("sync_interval_s", 2.0))]
        process_runner.spawn_service(name, cmd)
