"""Kafka runtime: message broker cluster.

Reference parity: runtime/kafka (SURVEY.md §2.3 — 512 LoC; brokers on
workers, zookeeper discovery).  This build renders KRaft-mode
server.properties (no zookeeper needed — controller quorum from the broker
set) but falls back to a discovered zookeeper connect string when the
cluster runs the zookeeper runtime.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    ServiceRuntimeBase, WORKER)
from cloudtik_tpu_torch.runtimes.etcd.runtime import quorum_members

BROKER_PORT = 9092
CONTROLLER_PORT = 9093


def render_server_properties(
        member_name: str, member_ip: str, peers: List[Dict[str, Any]],
        broker_port: int = BROKER_PORT,
        zookeeper_connect: Optional[str] = None,
        log_dir: str = "~/.tik/kafka/data") -> str:
    """server.properties for one broker.  Node ids are 1-based in
    sorted-name order (all brokers render identical quorum config)."""
    ordered = sorted(peers, key=lambda p: p["name"])
    ids = {p["name"]: i + 1 for i, p in enumerate(ordered)}
    node_id = ids[member_name]
    lines = [
        f"node.id={node_id}",
        f"log.dirs={log_dir}",
        f"listeners=PLAINTEXT://{member_ip}:{broker_port},"
        f"CONTROLLER://{member_ip}:{CONTROLLER_PORT}",
        f"advertised.listeners=PLAINTEXT://{member_ip}:{broker_port}",
        "inter.broker.listener.name=PLAINTEXT",
        f"num.partitions={max(len(peers), 1)}",
        f"default.replication.factor={min(len(peers), 3)}",
        f"offsets.topic.replication.factor={min(len(peers), 3)}",
    ]
    if zookeeper_connect:
        lines.insert(1, f"zookeeper.connect={zookeeper_connect}")
        lines.insert(1, f"broker.id={node_id}")
    else:
        voters = ",".join(f"{ids[p['name']]}@{p['ip']}:{CONTROLLER_PORT}"
                          for p in ordered)
        lines += [
            "process.roles=broker,controller",
            f"controller.quorum.voters={voters}",
            "controller.listener.names=CONTROLLER",
        ]
    return "\n".join(lines) + "\n"


class KafkaRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "kafka"
    DEFAULT_PORT = BROKER_PORT
    NODE_KIND = WORKER
    PROCESS_KEYWORD = "kafka.Kafka"
    MINIMAL_NODES = 3
    QUORUM = True
    BINARY = "kafka-server-start.sh"
    # Reference: runtime/kafka/scripts/install.sh download recipe as data.
    INSTALL = {
        "type": "archive",
        "url": ("https://archive.apache.org/dist/kafka/3.7.0/"
                "kafka_2.13-3.7.0.tgz"),
        "strip_components": 1,
    }

    def service_command(self, node_context: Dict[str, Any]):
        import os
        conf = os.path.join(self.conf_dir(node_context),
                            "server.properties")
        binary = self.find_binary()
        if binary is None or not os.path.exists(conf):
            return None  # not a quorum member on this node
        return [binary, conf]

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        if not self.runs_on(node_context):
            return
        import os
        peers = quorum_members(node_context)
        me = node_context.get("node_id", "")
        my = next((p for p in peers if p["name"] == me), None)
        if my is None:
            return
        zk = self._zookeeper_connect(node_context)
        props = render_server_properties(
            me, my["ip"], peers, broker_port=self.port,
            zookeeper_connect=zk)
        with open(os.path.join(self.conf_dir(node_context),
                               "server.properties"), "w") as f:
            f.write(props)

    def _zookeeper_connect(
            self, node_context: Dict[str, Any]) -> Optional[str]:
        config = node_context.get("config", {})
        if "zookeeper" not in config.get("runtime", {}).get("types", []):
            return None
        state = node_context.get("state_client")
        if state is None:
            return None
        from cloudtik_tpu_torch.runtimes.common.discovery_client import (
            discover_service)
        from cloudtik_tpu_torch.runtimes.discovery.runtime import ServiceRegistry
        registry = ServiceRegistry(
            state, cluster=config.get("cluster_name", ""),
            workspace=config.get("workspace_name", ""))
        addrs = discover_service(registry, "zookeeper")
        if not addrs:
            return None
        return ",".join(f"{a.host}:{a.port}" for a in addrs)

    @classmethod
    def get_dependencies(cls) -> List[str]:
        return []  # zookeeper optional (KRaft default)
