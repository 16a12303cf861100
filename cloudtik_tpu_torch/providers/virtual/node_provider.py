"""Virtual provider: local processes standing in for cluster nodes.

Reference parity: providers/_private/virtual (SURVEY.md §2.2 — the key
dev/test provider; there, Docker containers were nodes via
virtual_container_scheduler.py:137).  This build's virtual nodes are plain
local *processes*: each node is a directory under the provider root plus an
optional long-running "node process" (the node agent), reached through the
Local command executor.  TPU slices are simulated as atomic groups of
processes, which exercises the scaler's group-granular paths without
hardware.

State lives in a FileStateBackend so multiple CLI invocations (and the
head controller) see the same cluster.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.control.state import FileStateBackend
from cloudtik_tpu_torch.core.node_provider import NodeProvider
from cloudtik_tpu_torch.core.tags import (
    TAG_NODE_GROUP_ID, TAG_NODE_GROUP_SIZE, TAG_NODE_GROUP_WORKER_INDEX)

_NODES_NS = "virtual_nodes"


def default_root(cluster_name: str) -> str:
    return os.path.expanduser(f"~/.tik/virtual/{cluster_name}")


class VirtualNodeProvider(NodeProvider):
    """provider_config keys: root_dir (state dir), spawn_agents (bool)."""

    def __init__(self, provider_config: Dict[str, Any], cluster_name: str):
        super().__init__(provider_config, cluster_name)
        self.root = os.path.expanduser(
            provider_config.get("root_dir") or default_root(cluster_name))
        os.makedirs(self.root, exist_ok=True)
        self.state = FileStateBackend(os.path.join(self.root, "state"))
        self.spawn_agents = provider_config.get("spawn_agents", False)
        self._lock = threading.RLock()

    # -- storage helpers ---------------------------------------------------
    def _load(self, node_id: str) -> Optional[Dict[str, Any]]:
        raw = self.state.get(_NODES_NS, node_id)
        return json.loads(raw.decode()) if raw else None

    def _store(self, node_id: str, record: Dict[str, Any]) -> None:
        self.state.put(_NODES_NS, node_id, json.dumps(record).encode())

    def _all(self) -> Dict[str, Dict[str, Any]]:
        out = {}
        for node_id in self.state.keys(_NODES_NS):
            record = self._load(node_id)
            if record:
                out[node_id] = record
        return out

    # -- NodeProvider ------------------------------------------------------
    def non_terminated_nodes(self, tag_filters):
        with self._lock:
            out = []
            for node_id, record in self._all().items():
                if record["state"] == "terminated":
                    continue
                tags = record["tags"]
                if all(tags.get(k) == v for k, v in tag_filters.items()):
                    out.append(node_id)
            return sorted(out)

    def is_running(self, node_id):
        record = self._load(node_id)
        return bool(record) and record["state"] == "running"

    def is_terminated(self, node_id):
        record = self._load(node_id)
        return record is None or record["state"] == "terminated"

    def node_tags(self, node_id):
        record = self._load(node_id)
        if record is None:
            raise KeyError(node_id)
        return dict(record["tags"])

    def internal_ip(self, node_id):
        return "127.0.0.1" if self._load(node_id) else None

    def external_ip(self, node_id):
        return self.internal_ip(node_id)

    def set_node_tags(self, node_id, tags):
        with self._lock:
            record = self._load(node_id)
            if record is None:
                raise KeyError(node_id)
            record["tags"].update(tags)
            self._store(node_id, record)

    def create_node(self, node_config, tags, count):
        with self._lock:
            created = {}
            for _ in range(count):
                node_id = f"vnode-{uuid.uuid4().hex[:8]}"
                node_dir = os.path.join(self.root, node_id)
                os.makedirs(node_dir, exist_ok=True)
                record = {
                    "node_id": node_id,
                    "tags": dict(tags),
                    "state": "running",
                    "dir": node_dir,
                    "created_at": time.time(),
                    "pid": None,
                }
                if self.spawn_agents:
                    record["pid"] = self._spawn_agent(node_id, node_dir)
                self._store(node_id, record)
                created[node_id] = record
            return created

    def _spawn_agent(self, node_id: str, node_dir: str) -> int:
        """A real long-lived process per node (heartbeats into the head
        state server), so liveness/recovery paths are exercised for real."""
        script = (
            "import time\n"
            "from cloudtik_tpu_torch.control.state import TcpStateBackend, "
            "StateClient\n"
            "from cloudtik_tpu_torch.control.node_agent import NodeAgent\n"
            f"client = StateClient(TcpStateBackend('127.0.0.1'))\n"
            f"agent = NodeAgent(client, {node_id!r}, node_ip='127.0.0.1')\n"
            "agent.run_forever()\n")
        proc = subprocess.Popen(
            [sys.executable, "-c", script],
            stdout=open(os.path.join(node_dir, "agent.log"), "ab"),
            stderr=subprocess.STDOUT,
            start_new_session=True)
        return proc.pid

    def terminate_node(self, node_id):
        with self._lock:
            record = self._load(node_id)
            if record is None:
                return None
            if record.get("pid"):
                try:
                    os.killpg(os.getpgid(record["pid"]), signal.SIGTERM)
                except (ProcessLookupError, PermissionError):
                    pass
            record["state"] = "terminated"
            self._store(node_id, record)
        return None

    # -- node groups (simulated TPU slices) --------------------------------
    def supports_node_groups(self):
        return True

    def create_node_group(self, node_config, tags, group_size):
        with self._lock:
            group_id = f"vslice-{uuid.uuid4().hex[:8]}"
            for idx in range(group_size):
                member_tags = dict(tags)
                member_tags[TAG_NODE_GROUP_ID] = group_id
                member_tags[TAG_NODE_GROUP_WORKER_INDEX] = str(idx)
                member_tags[TAG_NODE_GROUP_SIZE] = str(group_size)
                self.create_node(node_config, member_tags, 1)
            return group_id

    def terminate_node_group(self, group_id):
        with self._lock:
            for node_id, record in self._all().items():
                if record["tags"].get(TAG_NODE_GROUP_ID) == group_id and \
                        record["state"] != "terminated":
                    self.terminate_node(node_id)

    def list_node_groups(self, tag_filters):
        groups: Dict[str, List[str]] = {}
        for node_id in self.non_terminated_nodes(tag_filters):
            tags = self.node_tags(node_id)
            gid = tags.get(TAG_NODE_GROUP_ID)
            if gid:
                groups.setdefault(gid, []).append(node_id)
        for gid, members in groups.items():
            members.sort(key=lambda n: int(
                self.node_tags(n).get(TAG_NODE_GROUP_WORKER_INDEX, 0)))
        return groups

    # -- config pipeline ---------------------------------------------------
    @staticmethod
    def bootstrap_config(cluster_config):
        # Virtual nodes are reached by local exec, not SSH, and run this
        # very interpreter (exported as $TIK_PYTHON for node commands).
        cluster_config.setdefault("auth", {})["executor"] = "local"
        cluster_config.setdefault("python_bin", sys.executable)
        return cluster_config

    def cleanup(self):
        pass
