"""ZooKeeper runtime: quorum coordination service.

Reference parity: runtime/zookeeper (SURVEY.md §2.3 — 625 LoC; declares
quorum node constraints).  Renders zoo.cfg with the server.N ensemble list
and the per-node myid file.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    ServiceRuntimeBase, WORKER)
from cloudtik_tpu_torch.runtimes.etcd.runtime import quorum_members

CLIENT_PORT = 2181
QUORUM_PORT = 2888
ELECTION_PORT = 3888


def render_zoo_cfg(peers: List[Dict[str, Any]],
                   data_dir: str = "~/.tik/zookeeper/data",
                   client_port: int = CLIENT_PORT) -> Tuple[str, Dict[str, int]]:
    """(zoo.cfg text, {member_name: myid}).  Ensemble ids are 1-based in
    sorted-name order so every member renders the identical file."""
    ordered = sorted(peers, key=lambda p: p["name"])
    ids = {p["name"]: i + 1 for i, p in enumerate(ordered)}
    lines = [
        "tickTime=2000",
        "initLimit=10",
        "syncLimit=5",
        f"dataDir={data_dir}",
        f"clientPort={client_port}",
        "autopurge.snapRetainCount=3",
        "autopurge.purgeInterval=1",
    ]
    for p in ordered:
        lines.append(f"server.{ids[p['name']]}="
                     f"{p['ip']}:{QUORUM_PORT}:{ELECTION_PORT}")
    return "\n".join(lines) + "\n", ids


class ZooKeeperRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "zookeeper"
    DEFAULT_PORT = CLIENT_PORT
    NODE_KIND = WORKER
    PROCESS_KEYWORD = "QuorumPeerMain"
    MINIMAL_NODES = 3
    QUORUM = True
    BINARY = "zkServer.sh"
    # Reference: runtime/zookeeper/scripts/install.sh download recipe.
    INSTALL = {
        "type": "archive",
        "url": ("https://archive.apache.org/dist/zookeeper/"
                "zookeeper-3.9.2/apache-zookeeper-3.9.2-bin.tar.gz"),
        "strip_components": 1,
    }

    def service_command(self, node_context: Dict[str, Any]):
        import os
        conf = os.path.join(self.conf_dir(node_context), "zoo.cfg")
        binary = self.find_binary()
        if binary is None or not os.path.exists(conf):
            return None  # not a quorum member on this node
        return [binary, "start-foreground", conf]

    def service_env(self, node_context: Dict[str, Any]):
        return {"ZOOCFGDIR": self.conf_dir(node_context)}

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        if not self.runs_on(node_context):
            return
        import os
        peers = quorum_members(node_context)
        me = node_context.get("node_id", "")
        cfg, ids = render_zoo_cfg(peers, client_port=self.port)
        if me not in ids:
            return
        conf_dir = self.conf_dir(node_context)
        with open(os.path.join(conf_dir, "zoo.cfg"), "w") as f:
            f.write(cfg)
        data_dir = os.path.expanduser("~/.tik/zookeeper/data")
        os.makedirs(data_dir, exist_ok=True)
        with open(os.path.join(data_dir, "myid"), "w") as f:
            f.write(str(ids[me]))
