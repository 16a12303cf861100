"""On-premise provider: nodes allocated from the cloud-simulator service.

Reference parity: providers/_private/onpremise/cloud_simulator_scheduler.py
:23 (SURVEY.md §2.2).  All state lives in the simulator; this provider is a
thin HTTP client, so many clusters share one machine pool.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.core.node_provider import (
    NodeLaunchException, NodeProvider)
from cloudtik_tpu_torch.providers.onpremise.simulator import DEFAULT_PORT


class SimulatorClient:
    def __init__(self, endpoint: str):
        self.endpoint = endpoint

    def call(self, op: str, **kw) -> Dict[str, Any]:
        body = json.dumps({"op": op, **kw}).encode()
        req = urllib.request.Request(
            self.endpoint, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            out = json.loads(resp.read())
        if not out.get("ok"):
            raise RuntimeError(out.get("error", f"simulator op {op} failed"))
        return out


class OnPremiseNodeProvider(NodeProvider):
    """provider_config keys: cloud_simulator_address ("host:port")."""

    def __init__(self, provider_config: Dict[str, Any], cluster_name: str):
        super().__init__(provider_config, cluster_name)
        addr = provider_config.get(
            "cloud_simulator_address", f"127.0.0.1:{DEFAULT_PORT}")
        if "://" not in addr:
            addr = f"http://{addr}"
        self.client = SimulatorClient(addr)
        self._lock = threading.RLock()

    def _mine(self) -> Dict[str, Dict[str, Any]]:
        machines = self.client.call("list", cluster=self.cluster_name)
        return {m["id"]: m for m in machines["machines"]}

    # -- queries -----------------------------------------------------------
    def non_terminated_nodes(self, tag_filters):
        out = []
        for mid, m in sorted(self._mine().items()):
            tags = m.get("tags", {})
            if all(tags.get(k) == v for k, v in tag_filters.items()):
                out.append(mid)
        return out

    def is_running(self, node_id):
        return node_id in self._mine()

    def is_terminated(self, node_id):
        return not self.is_running(node_id)

    def node_tags(self, node_id):
        m = self._mine().get(node_id)
        return dict(m.get("tags", {})) if m else {}

    def internal_ip(self, node_id):
        m = self._mine().get(node_id)
        return m.get("ip") if m else None

    def external_ip(self, node_id):
        m = self._mine().get(node_id)
        return m.get("external_ip") if m else None

    # -- mutation ----------------------------------------------------------
    def create_node(self, node_config, tags, count):
        try:
            out = self.client.call(
                "allocate", cluster=self.cluster_name, count=count,
                instance_type=node_config.get("instance_type", "default"),
                tags=tags)
        except RuntimeError as e:
            raise NodeLaunchException("inventory", str(e))
        return {m["id"]: m for m in out["machines"]}

    def set_node_tags(self, node_id, tags):
        self.client.call("set_tags", cluster=self.cluster_name,
                         machine_id=node_id, tags=tags)

    def terminate_node(self, node_id):
        try:
            self.client.call("release", cluster=self.cluster_name,
                             machine_id=node_id)
        except RuntimeError:
            # already released / not ours: terminate is idempotent
            return None
        return {node_id: "released"}

    @staticmethod
    def validate_config(provider_config: Dict[str, Any]) -> None:
        # cloud_simulator_address defaults to the local simulator in
        # __init__, so absence is valid; only malformed values fail.
        addr = provider_config.get("cloud_simulator_address")
        if addr is not None and not str(addr).strip():
            raise ValueError("cloud_simulator_address must be non-empty")
