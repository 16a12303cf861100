"""Trino runtime: distributed SQL (coordinator head / workers).

Reference parity: runtime/trino (SURVEY.md §2.3 — 707 LoC).  Renders
config.properties + jvm sizing per role and a hive catalog pointed at the
discovered metastore.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    ALL_NODES, ServiceRuntimeBase)

TRINO_PORT = 8081


def render_trino_config(is_coordinator: bool, coordinator_ip: str,
                        port: int = TRINO_PORT,
                        heap_gb: int = 4) -> Dict[str, str]:
    """{filename: content} for the trino etc/ dir."""
    props = [
        f"coordinator={'true' if is_coordinator else 'false'}",
        f"http-server.http.port={port}",
        f"discovery.uri=http://{coordinator_ip}:{port}",
    ]
    if is_coordinator:
        props.insert(1, "node-scheduler.include-coordinator=false")
    jvm = [
        "-server",
        f"-Xmx{heap_gb}G",
        "-XX:+UseG1GC",
        "-XX:+ExplicitGCInvokesConcurrent",
        "-XX:+ExitOnOutOfMemoryError",
    ]
    return {
        "config.properties": "\n".join(props) + "\n",
        "jvm.config": "\n".join(jvm) + "\n",
    }


def render_hive_catalog(metastore_host: str,
                        metastore_port: int = 9083) -> str:
    return ("connector.name=hive\n"
            f"hive.metastore.uri=thrift://{metastore_host}:"
            f"{metastore_port}\n")


class TrinoRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "trino"
    BINARY = "launcher"
    SERVICE_ARGS = ("{binary}", "run", "--etc-dir", "{conf_dir}")
    # Reference: runtime/trino install recipe (server release tarball).
    INSTALL = {
        "type": "archive",
        "url": ("https://repo1.maven.org/maven2/io/trino/trino-server/"
                "443/trino-server-443.tar.gz"),
        "strip_components": 1,
    }
    DEFAULT_PORT = TRINO_PORT
    PROTOCOL = "http"
    NODE_KIND = ALL_NODES
    PROCESS_KEYWORD = "io.trino.server.TrinoServer"
    ENDPOINT_NAME = "Trino"
    DEPENDENCIES = ["metastore"]

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        import os
        conf_dir = self.conf_dir(node_context)
        files = render_trino_config(
            bool(node_context.get("is_head")),
            node_context.get("head_ip", ""), port=self.port,
            heap_gb=int(self.runtime_config.get("heap_gb", 4)))
        for fname, content in files.items():
            with open(os.path.join(conf_dir, fname), "w") as f:
                f.write(content)
        ms = self._metastore(node_context)
        if ms:
            catalog_dir = os.path.join(conf_dir, "catalog")
            os.makedirs(catalog_dir, exist_ok=True)
            with open(os.path.join(catalog_dir, "hive.properties"),
                      "w") as f:
                f.write(render_hive_catalog(ms["host"], ms["port"]))

    def _metastore(self, node_context) -> Optional[Dict[str, Any]]:
        from cloudtik_tpu_torch.runtimes.common.discovery_client import (
            discover_endpoint_for_config)
        config = node_context.get("config", {})
        state = node_context.get("state_client")

        def factory():
            if state is None:
                return None
            from cloudtik_tpu_torch.runtimes.discovery.runtime import (
                ServiceRegistry)
            return ServiceRegistry(
                state, cluster=config.get("cluster_name", ""),
                workspace=config.get("workspace_name", ""))

        return discover_endpoint_for_config(
            config, "trino", "metastore", factory, 9083)
