"""Elasticsearch runtime: search cluster.

Reference parity: runtime/elasticsearch (SURVEY.md §2.3 — 1,107 LoC).
Renders elasticsearch.yml with discovery seed hosts + initial masters from
cluster membership.
"""

from __future__ import annotations

from typing import Any, Dict, List

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    ALL_NODES, ServiceRuntimeBase)
from cloudtik_tpu_torch.runtimes.etcd.runtime import quorum_members

ES_HTTP_PORT = 9200
ES_TRANSPORT_PORT = 9300


def render_elasticsearch_yml(node_name: str, node_ip: str,
                             peers: List[Dict[str, Any]],
                             cluster_name: str = "tik-es",
                             http_port: int = ES_HTTP_PORT) -> str:
    import yaml
    ordered = sorted(peers, key=lambda p: p["name"])
    seed_hosts = [f"{p['ip']}:{ES_TRANSPORT_PORT}" for p in ordered]
    initial_masters = [p["name"] for p in ordered[:3]] or [node_name]
    return yaml.safe_dump({
        "cluster.name": cluster_name,
        "node.name": node_name,
        "network.host": node_ip,
        "http.port": http_port,
        "transport.port": ES_TRANSPORT_PORT,
        "discovery.seed_hosts": seed_hosts,
        "cluster.initial_master_nodes": initial_masters,
        "path.data": "~/.tik/elasticsearch/data",
        "xpack.security.enabled": False,
    })


class ElasticsearchRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "elasticsearch"
    DEFAULT_PORT = ES_HTTP_PORT
    PROTOCOL = "http"
    NODE_KIND = ALL_NODES
    PROCESS_KEYWORD = "org.elasticsearch.bootstrap"
    ENDPOINT_NAME = "Elasticsearch"
    BINARY = "elasticsearch"
    # Reference: runtime/elasticsearch install recipe (release tarball).
    INSTALL = {
        "type": "archive",
        "url": ("https://artifacts.elastic.co/downloads/elasticsearch/"
                "elasticsearch-8.13.2-linux-x86_64.tar.gz"),
        "strip_components": 1,
    }

    def service_command(self, node_context: Dict[str, Any]):
        import os
        conf = os.path.join(self.conf_dir(node_context),
                            "elasticsearch.yml")
        binary = self.find_binary()
        if binary is None or not os.path.exists(conf):
            return None
        return [binary]

    def service_env(self, node_context: Dict[str, Any]):
        return {"ES_PATH_CONF": self.conf_dir(node_context)}

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        import os
        me = node_context.get("node_id", "")
        peers = quorum_members(node_context)
        if node_context.get("is_head"):
            peers = ([{"name": me,
                       "ip": node_context.get("head_ip", "")}]
                     + [p for p in peers if p["name"] != me])
        my = next((p for p in peers if p["name"] == me), None)
        if my is None:
            return
        cfg = render_elasticsearch_yml(
            me, my["ip"], peers,
            cluster_name=node_context.get("config", {}).get(
                "cluster_name", "tik-es"),
            http_port=self.port)
        with open(os.path.join(self.conf_dir(node_context),
                               "elasticsearch.yml"), "w") as f:
            f.write(cfg)
