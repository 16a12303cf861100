"""BIND runtime: authoritative cluster DNS zone.

Reference parity: runtime/bind (SURVEY.md §2.3 — 390 LoC).  Renders
named.conf + a zone file for `{workspace}.tik` from the state-store
records.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    HEAD, ServiceRuntimeBase)
from cloudtik_tpu_torch.runtimes.dnsmasq.runtime import _records_from_context

DNS_PORT = 53


def render_named_conf(zone: str, zone_file: str,
                      port: int = DNS_PORT) -> str:
    return (
        "options {\n"
        f"  listen-on port {port} {{ any; }};\n"
        "  allow-query { any; };\n"
        "  recursion no;\n"
        "};\n"
        f"zone \"{zone}\" {{\n"
        "  type master;\n"
        f"  file \"{zone_file}\";\n"
        "};\n")


def render_zone_file(zone: str, records: List[Tuple[str, str]],
                     head_ip: str, serial: int = 1) -> str:
    lines = [
        "$TTL 60",
        f"@ IN SOA ns.{zone}. admin.{zone}. ("
        f" {serial} 3600 600 86400 60 )",
        f"@ IN NS ns.{zone}.",
        f"ns IN A {head_ip}",
    ]
    suffix = "." + zone
    for fqdn, ip in records:
        name = fqdn[:-len(suffix)] if fqdn.endswith(suffix) else fqdn + "."
        lines.append(f"{name} IN A {ip}")
    return "\n".join(lines) + "\n"


class BindRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "bind"
    BINARY = "named"
    CONF_FILE = "named.conf"
    SERVICE_ARGS = ("{binary}", "-g", "-c", "{conf}")
    DEFAULT_PORT = DNS_PORT
    PROTOCOL = "udp"
    NODE_KIND = HEAD
    PROCESS_KEYWORD = "named"

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        if not self.runs_on(node_context):
            return
        import os
        config = node_context.get("config", {})
        workspace = config.get("workspace_name", "") or "default"
        zone = f"{workspace}.tik"
        conf_dir = self.conf_dir(node_context)
        zone_file = os.path.join(conf_dir, f"{zone}.zone")
        records = _records_from_context(node_context)
        with open(zone_file, "w") as f:
            f.write(render_zone_file(
                zone, records, node_context.get("head_ip", "127.0.0.1")))
        with open(os.path.join(conf_dir, "named.conf"), "w") as f:
            f.write(render_named_conf(zone, zone_file, port=self.port))
