"""dnsmasq runtime: light cluster DNS.

Reference parity: runtime/dnsmasq (SURVEY.md §2.3 — 411 LoC; cluster node
naming backed by consul DNS).  Renders a dnsmasq conf + addn-hosts file
from the state-store records.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    HEAD, ServiceRuntimeBase)
from cloudtik_tpu_torch.runtimes.dns.records import cluster_dns_records

DNS_PORT = 53


def render_dnsmasq_conf(hosts_file: str, port: int = DNS_PORT,
                        upstream: str = "8.8.8.8",
                        domain: str = "tik") -> str:
    return "\n".join([
        f"port={port}",
        "no-resolv",
        f"server={upstream}",
        f"local=/{domain}/",
        f"addn-hosts={hosts_file}",
        "expand-hosts",
        "cache-size=1000",
    ]) + "\n"


def render_hosts_file(records: List[Tuple[str, str]]) -> str:
    return "".join(f"{ip} {fqdn}\n" for fqdn, ip in records)


class DnsmasqRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "dnsmasq"
    BINARY = "dnsmasq"
    CONF_FILE = "dnsmasq.conf"
    SERVICE_ARGS = ("{binary}", "-k", "-C", "{conf}")
    DEFAULT_PORT = DNS_PORT
    PROTOCOL = "udp"
    NODE_KIND = HEAD
    PROCESS_KEYWORD = "dnsmasq"

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        if not self.runs_on(node_context):
            return
        import os
        conf_dir = self.conf_dir(node_context)
        hosts_file = os.path.join(conf_dir, "tik-hosts")
        records = _records_from_context(node_context)
        with open(hosts_file, "w") as f:
            f.write(render_hosts_file(records))
        with open(os.path.join(conf_dir, "dnsmasq.conf"), "w") as f:
            f.write(render_dnsmasq_conf(
                hosts_file, port=self.port,
                upstream=self.runtime_config.get("upstream", "8.8.8.8")))


def _records_from_context(
        node_context: Dict[str, Any]) -> List[Tuple[str, str]]:
    state = node_context.get("state_client")
    config = node_context.get("config", {})
    if state is None:
        return []
    from cloudtik_tpu_torch.runtimes.discovery.runtime import ServiceRegistry
    cluster = config.get("cluster_name", "")
    workspace = config.get("workspace_name", "")
    registry = ServiceRegistry(state, cluster=cluster, workspace=workspace)
    return cluster_dns_records(cluster, workspace,
                               state.table_list("nodes"),
                               registry.query())
