"""Grafana runtime: dashboards with prometheus datasource via discovery.

Reference parity: runtime/grafana (SURVEY.md §2.3 — install.sh release
tarball + provisioned prometheus datasource).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    HEAD, ServiceRuntimeBase)

DEFAULT_PORT = 3000


class GrafanaRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "grafana"
    DEFAULT_PORT = DEFAULT_PORT
    PROTOCOL = "http"
    NODE_KIND = HEAD
    PROCESS_KEYWORD = "grafana"
    ENDPOINT_NAME = "Grafana"
    BINARY = "grafana"
    CONF_FILE = "grafana.ini"
    SERVICE_ARGS = ("{binary}", "server", "--config", "{conf}",
                    "--homepath", "{conf_dir}")
    # Reference: runtime/grafana/scripts/install.sh download recipe.
    INSTALL = {
        "type": "archive",
        "url": ("https://dl.grafana.com/oss/release/"
                "grafana-10.4.2.linux-amd64.tar.gz"),
        "strip_components": 1,
    }

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        if not self.runs_on(node_context):
            return
        conf_dir = self.conf_dir(node_context)
        provisioning = os.path.join(conf_dir, "provisioning",
                                    "datasources")
        os.makedirs(provisioning, exist_ok=True)
        prometheus_url = node_context.get(
            "prometheus_url", "http://localhost:9090")
        import yaml
        with open(os.path.join(provisioning, "tik.yaml"), "w") as f:
            yaml.safe_dump({
                "apiVersion": 1,
                "datasources": [{
                    "name": "tik-prometheus",
                    "type": "prometheus",
                    "url": prometheus_url,
                    "isDefault": True,
                }],
            }, f)
        from cloudtik_tpu_torch.runtimes.grafana.dashboards import (
            write_dashboards)
        write_dashboards(os.path.join(conf_dir, "provisioning"))
        with open(os.path.join(conf_dir, "grafana.ini"), "w") as f:
            f.write("[server]\n"
                    f"http_port = {self.port}\n"
                    "[paths]\n"
                    f"provisioning = {os.path.join(conf_dir, 'provisioning')}\n")

    def get_processes(self) -> Optional[List[Tuple[str, bool, str, str]]]:
        return [("grafana", False, "Grafana", "head")]

    @staticmethod
    def get_dependencies() -> List[str]:
        return ["prometheus"]
