"""MongoDB runtime: replica set across cluster nodes.

Reference parity: runtime/mongodb (SURVEY.md §2.3 — 3,341 LoC; replica-set
HA).  Renders mongod.conf plus the rs.initiate() document the services
script applies once on the head.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    ALL_NODES, ServiceRuntimeBase)
from cloudtik_tpu_torch.runtimes.etcd.runtime import quorum_members

MONGO_PORT = 27017
REPLICA_SET = "tik-rs"


def render_mongod_conf(port: int = MONGO_PORT,
                       replica_set: str = REPLICA_SET,
                       data_dir: str = "~/.tik/mongodb/data",
                       cache_gb: float = 0.5) -> str:
    import yaml
    return yaml.safe_dump({
        "net": {"port": port, "bindIp": "0.0.0.0"},
        "storage": {"dbPath": data_dir,
                    "wiredTiger": {"engineConfig":
                                   {"cacheSizeGB": cache_gb}}},
        "replication": {"replSetName": replica_set},
    })


def render_replset_initiate(members: List[Dict[str, Any]],
                            port: int = MONGO_PORT,
                            replica_set: str = REPLICA_SET) -> str:
    """rs.initiate() JSON: head is priority-2 so it wins initial election."""
    docs = []
    for i, m in enumerate(sorted(members, key=lambda m: m["name"])):
        docs.append({"_id": i, "host": f"{m['ip']}:{port}",
                     "priority": 2 if m.get("is_head") else 1})
    return json.dumps({"_id": replica_set, "members": docs}, indent=1)


class MongoDBRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "mongodb"
    DEFAULT_PORT = MONGO_PORT
    NODE_KIND = ALL_NODES
    PROCESS_KEYWORD = "mongod"
    BINARY = "mongod"
    # Reference: runtime/mongodb install recipe (community release tgz).
    INSTALL = {
        "type": "archive",
        "url": ("https://fastdl.mongodb.org/linux/"
                "mongodb-linux-x86_64-ubuntu2204-7.0.8.tgz"),
        "strip_components": 1,
    }

    def service_command(self, node_context: Dict[str, Any]):
        import os
        conf = os.path.join(self.conf_dir(node_context), "mongod.conf")
        binary = self.find_binary()
        if binary is None or not os.path.exists(conf):
            return None
        return [binary, "--config", conf]

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        import os
        conf_dir = self.conf_dir(node_context)
        with open(os.path.join(conf_dir, "mongod.conf"), "w") as f:
            f.write(render_mongod_conf(
                port=self.port,
                cache_gb=float(self.runtime_config.get("cache_gb", 0.5))))
        if node_context.get("is_head"):
            members = [{"name": node_context.get("node_id", "head"),
                        "ip": node_context.get("head_ip", ""),
                        "is_head": True}]
            members += [dict(m, is_head=False)
                        for m in quorum_members(node_context)
                        if m["name"] != node_context.get("node_id")]
            with open(os.path.join(conf_dir, "initiate.json"), "w") as f:
                f.write(render_replset_initiate(members, port=self.port))

    def _mongosh(self, script: str) -> str:
        """Eval a script via mongosh against the local member; "" when
        the shell is absent (renders stay testable without mongod)."""
        import os
        import shutil
        import subprocess
        binary = self.find_binary()
        shell = None
        if binary is not None:
            cand = os.path.join(os.path.dirname(binary), "mongosh")
            if os.access(cand, os.X_OK):
                shell = cand
        shell = shell or shutil.which("mongosh")
        if shell is None:
            return ""
        out = subprocess.run(
            [shell, "--quiet", "--port", str(self.port),
             "--eval", script], capture_output=True, text=True)
        return out.stdout

    def query_primary(self) -> "Any":
        """The replica set's elected primary as {"ip","port","member_id"}
        (None before the set has one) — mongo's `hello` command
        (reference: mongodb utils' primary discovery for service
        registration, runtime/mongodb/utils.py:33)."""
        out = self._mongosh(
            "const h = db.hello(); if (h.primary) print(h.primary)")
        host = out.strip().splitlines()[-1] if out.strip() else ""
        if ":" not in host:
            return None
        ip, _, port = host.rpartition(":")
        return {"ip": ip, "port": int(port), "member_id": host}

    def post_start(self, node_context: Dict[str, Any]) -> None:
        """Replica-set lifecycle: the head runs rs.initiate() exactly
        once (marker-file idempotent); every member then mirrors the
        set's NATIVE election into the discovery registry via a primary
        watch — mongod needs no lease-failover daemon because raft-style
        elections are built in."""
        import os

        from cloudtik_tpu_torch.runtimes.common.failover import PrimaryWatchDaemon

        conf_dir = self.conf_dir(node_context)
        if node_context.get("is_head"):
            marker = os.path.join(conf_dir, ".rs-initiated")
            initiate = os.path.join(conf_dir, "initiate.json")
            if not os.path.exists(marker) and os.path.exists(initiate):
                with open(initiate) as f:
                    doc = f.read()
                if self._mongosh(f"rs.initiate({doc})") or \
                        self.runtime_config.get("assume_initiated"):
                    with open(marker, "w") as f:
                        f.write("1")

        state = node_context.get("state_client")
        if state is None:
            return
        config = node_context.get("config", {})
        self._watch = PrimaryWatchDaemon(
            state, self.SERVICE_NAME, self.query_primary,
            cluster_name=config.get("cluster_name", ""),
            workspace_name=config.get("workspace_name", ""),
            poll_s=float(self.runtime_config.get("watch_poll_s", 2.0)))
        self._watch.start()
        self.register_daemon(node_context, self._watch)
