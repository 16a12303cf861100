"""Presto runtime: distributed SQL (coordinator head / workers).

Reference parity: runtime/presto (SURVEY.md §2.3 — 665 LoC).  Same config
shape as Trino (they share lineage); kept as a distinct runtime for
capability parity with the reference's separate presto plugin.
"""

from __future__ import annotations

from typing import Any, Dict

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    ALL_NODES, ServiceRuntimeBase)
from cloudtik_tpu_torch.runtimes.trino.runtime import render_hive_catalog

PRESTO_PORT = 8082


def render_presto_config(is_coordinator: bool, head_ip: str, *,
                         port: int = PRESTO_PORT, heap_gb: int = 4,
                         node_id: str = "node",
                         environment: str = "tik") -> Dict[str, str]:
    """etc/ files for a PrestoDB server.  Differs from trino's renderer
    where the engines diverge: presto keeps the built-in discovery
    server on the coordinator (discovery-server.enabled + discovery.uri)
    and the PrestoServer main class in jvm.config."""
    config = [
        f"coordinator={'true' if is_coordinator else 'false'}",
        f"http-server.http.port={port}",
        f"discovery.uri=http://{head_ip}:{port}",
        f"query.max-memory={max(heap_gb - 1, 1)}GB",
        f"query.max-memory-per-node={max(heap_gb // 2, 1)}GB",
    ]
    if is_coordinator:
        config.insert(1, "node-scheduler.include-coordinator=false")
        config.insert(1, "discovery-server.enabled=true")
    node = [
        f"node.environment={environment}",
        f"node.id={node_id}",
        "node.data-dir=/tmp/presto-data",
    ]
    jvm = [
        "-server",
        f"-Xmx{heap_gb}G",
        "-XX:+UseG1GC",
        "-XX:+ExplicitGCInvokesConcurrent",
        "-Djdk.attach.allowAttachSelf=true",
    ]
    return {
        "config.properties": "\n".join(config) + "\n",
        "node.properties": "\n".join(node) + "\n",
        "jvm.config": "\n".join(jvm) + "\n",
    }


class PrestoRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "presto"
    DEFAULT_PORT = PRESTO_PORT
    PROTOCOL = "http"
    NODE_KIND = ALL_NODES
    PROCESS_KEYWORD = "com.facebook.presto.server.PrestoServer"
    ENDPOINT_NAME = "Presto"
    BINARY = "launcher"
    SERVICE_ARGS = ("{binary}", "run", "--etc-dir", "{conf_dir}")
    # Reference: runtime/presto install recipe (server release tarball).
    INSTALL = {
        "type": "archive",
        "url": ("https://repo1.maven.org/maven2/com/facebook/presto/"
                "presto-server/0.287/presto-server-0.287.tar.gz"),
        "strip_components": 1,
    }

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        import os
        conf_dir = self.conf_dir(node_context)
        files = render_presto_config(
            bool(node_context.get("is_head")),
            node_context.get("head_ip", ""), port=self.port,
            heap_gb=int(self.runtime_config.get("heap_gb", 4)),
            node_id=node_context.get("node_id", "node"),
            environment=node_context.get("config", {}).get(
                "workspace_name", "tik") or "tik")
        ms = self._metastore(node_context)
        if ms:
            os.makedirs(os.path.join(conf_dir, "catalog"), exist_ok=True)
            files[os.path.join("catalog", "hive.properties")] = \
                render_hive_catalog(ms["host"], ms["port"])
        for fname, content in files.items():
            with open(os.path.join(conf_dir, fname), "w") as f:
                f.write(content)

    def _metastore(self, node_context) -> "Optional[Dict[str, Any]]":
        """Catalog target: explicit metastore_uri beats discovery of a
        metastore runtime in this or a connected cluster (same wiring
        as trino; reference: presto's hive catalog from the metastore
        head, runtime/presto/utils.py)."""
        metastore = self.runtime_config.get("metastore_uri")
        if metastore:
            # accept thrift://host:port, host:port, or bare host
            hostport = metastore.split("://", 1)[-1]
            host, _, port_s = hostport.partition(":")
            return {"host": host, "port": int(port_s or 9083)}
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
            config, "presto", "metastore", factory, 9083)
