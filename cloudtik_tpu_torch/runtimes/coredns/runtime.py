"""CoreDNS runtime: cluster DNS via the hosts plugin.

Reference parity: runtime/coredns (SURVEY.md §2.3 — 336 LoC).  Renders a
Corefile serving the tik domain from a hosts file (shared renderer with
dnsmasq) and forwarding the rest upstream.
"""

from __future__ import annotations

from typing import Any, Dict

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    HEAD, ServiceRuntimeBase)
from cloudtik_tpu_torch.runtimes.dnsmasq.runtime import (
    _records_from_context, render_hosts_file)

DNS_PORT = 53


def render_corefile(hosts_file: str, port: int = DNS_PORT,
                    domain: str = "tik",
                    upstream: str = "8.8.8.8") -> str:
    return (
        f"{domain}:{port} {{\n"
        f"  hosts {hosts_file} {domain} {{\n"
        "    fallthrough\n"
        "  }\n"
        "  cache 30\n"
        "  errors\n"
        "}\n"
        f".:{port} {{\n"
        f"  forward . {upstream}\n"
        "  cache 300\n"
        "}\n")


class CoreDNSRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "coredns"
    BINARY = "coredns"
    CONF_FILE = "Corefile"
    SERVICE_ARGS = ("{binary}", "-conf", "{conf}")
    # Reference: runtime/coredns install recipe (single static binary).
    INSTALL = {
        "type": "archive",
        "url": ("https://github.com/coredns/coredns/releases/download/"
                "v1.11.3/coredns_1.11.3_linux_amd64.tgz"),
        "strip_components": 0,
    }
    DEFAULT_PORT = DNS_PORT
    PROTOCOL = "udp"
    NODE_KIND = HEAD
    PROCESS_KEYWORD = "coredns"

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        if not self.runs_on(node_context):
            return
        import os
        conf_dir = self.conf_dir(node_context)
        hosts_file = os.path.join(conf_dir, "tik-hosts")
        with open(hosts_file, "w") as f:
            f.write(render_hosts_file(_records_from_context(node_context)))
        with open(os.path.join(conf_dir, "Corefile"), "w") as f:
            f.write(render_corefile(
                hosts_file, port=self.port,
                upstream=self.runtime_config.get("upstream", "8.8.8.8")))
