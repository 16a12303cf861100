"""Consul runtime: optional real-Consul service-discovery fabric.

Reference parity: runtime/consul (SURVEY.md §2.3 — 865 LoC; server cluster
on head(s), agents everywhere, services registered from
Runtime.get_runtime_services defs).  The TPU build's default discovery
backbone is the head state store (runtimes/discovery); this runtime exists
for users who want real Consul (multi-cluster workspaces, DNS interface).
It renders server/agent JSON configs and service registration documents
from the same get_runtime_services contract.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    ALL_NODES, ServiceRuntimeBase)

CONSUL_HTTP_PORT = 8500
CONSUL_DNS_PORT = 8600
CONSUL_SERF_PORT = 8301


def render_consul_config(node_name: str, node_ip: str, is_server: bool,
                         retry_join: List[str],
                         datacenter: str = "tik",
                         bootstrap_expect: int = 1) -> str:
    cfg: Dict[str, Any] = {
        "node_name": node_name,
        "datacenter": datacenter,
        "data_dir": "~/.tik/consul/data",
        "bind_addr": node_ip,
        "client_addr": "0.0.0.0",
        "retry_join": retry_join,
        "ports": {"http": CONSUL_HTTP_PORT, "dns": CONSUL_DNS_PORT},
    }
    if is_server:
        cfg["server"] = True
        cfg["bootstrap_expect"] = bootstrap_expect
        cfg["ui_config"] = {"enabled": True}
    return json.dumps(cfg, indent=1, sort_keys=True)


def render_service_registrations(
        services: Dict[str, Dict[str, Any]], node_ip: str) -> str:
    """Consul service definition file from get_runtime_services defs."""
    docs = []
    for name, svc in sorted(services.items()):
        docs.append({
            "name": name,
            "address": node_ip,
            "port": svc.get("port", 0),
            "tags": sorted(f"{k}={v}" for k, v in
                           svc.get("tags", {}).items()),
            "checks": [{"tcp": f"{node_ip}:{svc.get('port', 0)}",
                        "interval": "10s"}],
        })
    return json.dumps({"services": docs}, indent=1)


class ConsulRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "consul"
    BINARY = "consul"
    CONF_FILE = "consul.json"
    SERVICE_ARGS = ("{binary}", "agent", "-config-file", "{conf}")
    # Reference: runtime/consul install recipe (single static binary zip).
    INSTALL = {
        "type": "archive",
        "url": ("https://releases.hashicorp.com/consul/1.18.1/"
                "consul_1.18.1_linux_amd64.zip"),
        "strip_components": 0,
    }
    DEFAULT_PORT = CONSUL_HTTP_PORT
    PROTOCOL = "http"
    NODE_KIND = ALL_NODES
    PROCESS_KEYWORD = "consul agent"
    ENDPOINT_NAME = "Consul"

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        import os
        is_head = bool(node_context.get("is_head"))
        head_ip = node_context.get("head_ip", "")
        me = node_context.get("node_id", "node")
        cfg = render_consul_config(
            node_name=me,
            node_ip=head_ip if is_head
            else node_context.get("node_ip", ""),
            is_server=is_head,
            retry_join=[head_ip],
            datacenter=node_context.get("config", {}).get(
                "workspace_name", "tik") or "tik")
        with open(os.path.join(self.conf_dir(node_context),
                               "consul.json"), "w") as f:
            f.write(cfg)
