"""etcd runtime: quorum KV store cluster.

Reference parity: runtime/etcd (SURVEY.md §2.3 — 582 LoC; declares quorum
node constraints consumed by the quorum manager, core/runtime.py:193).
Members are the quorum node set; the initial-cluster string is rendered
from the quorum membership published by the head.
"""

from __future__ import annotations

from typing import Any, Dict, List

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    ServiceRuntimeBase, WORKER)

CLIENT_PORT = 2379
PEER_PORT = 2380


def render_etcd_config(member_name: str, member_ip: str,
                       peers: List[Dict[str, Any]],
                       data_dir: str = "~/.tik/etcd/data",
                       client_port: int = CLIENT_PORT,
                       peer_port: int = PEER_PORT) -> Dict[str, Any]:
    """etcd YAML config dict for one member.  `peers` = quorum members
    [{name, ip}], including this member."""
    initial_cluster = ",".join(
        f"{p['name']}=http://{p['ip']}:{peer_port}"
        for p in sorted(peers, key=lambda p: p["name"]))
    return {
        "name": member_name,
        "data-dir": data_dir,
        "listen-client-urls": f"http://{member_ip}:{client_port},"
                              f"http://127.0.0.1:{client_port}",
        "advertise-client-urls": f"http://{member_ip}:{client_port}",
        "listen-peer-urls": f"http://{member_ip}:{peer_port}",
        "initial-advertise-peer-urls": f"http://{member_ip}:{peer_port}",
        "initial-cluster": initial_cluster,
        "initial-cluster-state": "new",
        "initial-cluster-token": "tik-etcd",
    }


class EtcdRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "etcd"
    DEFAULT_PORT = CLIENT_PORT
    NODE_KIND = WORKER
    PROCESS_KEYWORD = "etcd"
    MINIMAL_NODES = 3
    QUORUM = True
    BINARY = "etcd"
    # Reference: runtime/etcd/scripts/install.sh download recipe as data.
    INSTALL = {
        "type": "archive",
        "url": ("https://github.com/etcd-io/etcd/releases/download/"
                "v3.5.12/etcd-v3.5.12-linux-amd64.tar.gz"),
        "strip_components": 1,
    }

    def service_command(self, node_context: Dict[str, Any]):
        import os
        conf = os.path.join(self.conf_dir(node_context), "etcd.yaml")
        if not os.path.exists(conf):
            return None  # not a quorum member on this node
        binary = self.find_binary()
        if binary is None:
            return None
        return [binary, "--config-file", conf]

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        if not self.runs_on(node_context):
            return
        import os

        import yaml
        peers = quorum_members(node_context)
        me = node_context.get("node_id", "")
        my = next((p for p in peers if p["name"] == me), None)
        if my is None:
            return
        conf = render_etcd_config(me, my["ip"], peers,
                                  client_port=self.port)
        with open(os.path.join(self.conf_dir(node_context),
                               "etcd.yaml"), "w") as f:
            yaml.safe_dump(conf, f)


def quorum_members(node_context: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Quorum membership from the head's nodes table: [{name, ip}]."""
    state = node_context.get("state_client")
    if state is None:
        return []
    members = []
    for node_id, info in state.table_list("nodes").items():
        if info.get("kind") == "worker" or info.get("is_head") is False:
            members.append({"name": node_id,
                            "ip": info.get("ip", "")})
        elif "kind" not in info and "is_head" not in info:
            members.append({"name": node_id, "ip": info.get("ip", "")})
    return sorted(members, key=lambda m: m["name"])
