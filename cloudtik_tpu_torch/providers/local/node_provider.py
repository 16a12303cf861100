"""Local provider: clusters on a fixed list of existing hosts.

Reference parity: providers/_private/local (SURVEY.md §2.2 — many clusters
on a fixed host list, local_scheduler.py + file state store).  The config
declares the host inventory; "creating" a node claims a free host,
"terminating" releases it.  Claims are persisted in a FileStateBackend so
concurrent CLI invocations and the head controller share one view; an
fcntl lock makes claim/release atomic.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.control.state import FileStateBackend
from cloudtik_tpu_torch.core.node_provider import (
    NodeLaunchException, NodeProvider)

_CLAIMS_NS = "local_claims"


def default_state_root() -> str:
    return os.path.expanduser("~/.tik/local")


class LocalNodeProvider(NodeProvider):
    """provider_config keys:
      hosts: ["10.0.0.1", ...]  (the shared machine inventory)
      state_root: claims directory (default ~/.tik/local)
    """

    def __init__(self, provider_config: Dict[str, Any], cluster_name: str):
        super().__init__(provider_config, cluster_name)
        self.hosts: List[str] = list(provider_config.get("hosts") or [])
        root = os.path.expanduser(
            provider_config.get("state_root") or default_state_root())
        os.makedirs(root, exist_ok=True)
        self.state = FileStateBackend(os.path.join(root, "state"))
        self._lock = threading.RLock()

    # -- claims ------------------------------------------------------------
    def _claims(self) -> Dict[str, Dict[str, Any]]:
        out = {}
        for host in self.state.keys(_CLAIMS_NS):
            raw = self.state.get(_CLAIMS_NS, host)
            if raw:
                out[host] = json.loads(raw.decode())
        return out

    def _mine(self) -> Dict[str, Dict[str, Any]]:
        return {h: c for h, c in self._claims().items()
                if c.get("cluster") == self.cluster_name}

    # -- queries -----------------------------------------------------------
    def non_terminated_nodes(self, tag_filters):
        with self._lock:
            out = []
            for host, claim in sorted(self._mine().items()):
                tags = claim.get("tags", {})
                if all(tags.get(k) == v for k, v in tag_filters.items()):
                    out.append(host)
            return out

    def is_running(self, node_id):
        return node_id in self._mine()

    def is_terminated(self, node_id):
        return not self.is_running(node_id)

    def node_tags(self, node_id):
        claim = self._mine().get(node_id)
        return dict(claim.get("tags", {})) if claim else {}

    def internal_ip(self, node_id):
        return node_id          # node id IS the host address

    def external_ip(self, node_id):
        return node_id

    # -- mutation ----------------------------------------------------------
    def create_node(self, node_config, tags, count):
        with self._lock:
            claims = self._claims()
            free = [h for h in self.hosts if h not in claims]
            if len(free) < count:
                raise NodeLaunchException(
                    "inventory",
                    f"need {count} hosts, {len(free)} free of "
                    f"{len(self.hosts)} in inventory")
            created = {}
            for host in free[:count]:
                # CAS-guard each claim against a concurrent cluster
                record = {"cluster": self.cluster_name, "tags": dict(tags),
                          "time": time.time()}
                if not self.state.cas(_CLAIMS_NS, host, None,
                                      json.dumps(record).encode()):
                    continue
                created[host] = record
            if len(created) < count:
                # lost a race for some hosts: release and fail
                for host in created:
                    self.state.delete(_CLAIMS_NS, host)
                raise NodeLaunchException(
                    "inventory", "lost claim race; retry")
            return created

    def set_node_tags(self, node_id, tags):
        with self._lock:
            raw = self.state.get(_CLAIMS_NS, node_id)
            if raw is None:
                return
            claim = json.loads(raw.decode())
            if claim.get("cluster") != self.cluster_name:
                return
            claim.setdefault("tags", {}).update(tags)
            self.state.put(_CLAIMS_NS, node_id,
                           json.dumps(claim).encode())

    def terminate_node(self, node_id):
        with self._lock:
            if node_id in self._mine():
                self.state.delete(_CLAIMS_NS, node_id)
                return {node_id: "released"}
            return None

    @staticmethod
    def validate_config(provider_config: Dict[str, Any]) -> None:
        if not provider_config.get("hosts"):
            raise ValueError(
                "local provider requires a non-empty `hosts` list")
