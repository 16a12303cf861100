"""Huawei Cloud ECS node provider.

Reference parity: providers/_private/huaweicloud (SURVEY.md §2.2 —
ECS/OBS, 2,879 LoC).  Request builders pure; client injectable, SDK lazy.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.core.node_provider import (
    NodeLaunchException, NodeProvider)


def build_create_servers_request(
        node_config: Dict[str, Any], tags: Dict[str, str],
        count: int, cluster_name: str) -> Dict[str, Any]:
    """node_config -> Huawei ECS CreateServers body."""
    all_tags = {**tags, "tik-cluster-name": cluster_name}
    server: Dict[str, Any] = {
        "name": f"tik-{cluster_name}-"
                f"{tags.get('tik-node-kind', 'node')}",
        "imageRef": node_config.get("image_id", ""),
        "flavorRef": node_config.get("flavor", "c7.xlarge.2"),
        "count": count,
        "vpcid": node_config.get("vpc_id", ""),
        "nics": [{"subnet_id": node_config.get("subnet_id", "")}],
        "root_volume": {
            "volumetype": node_config.get("volume_type", "SSD"),
            "size": node_config.get("volume_size", 100)},
        "server_tags": [{"key": k, "value": v}
                        for k, v in sorted(all_tags.items())],
    }
    if node_config.get("key_name"):
        server["key_name"] = node_config["key_name"]
    # placement: AZ pinning + anti-affinity server groups (reference
    # huaweicloud/config.py options)
    if node_config.get("availability_zone"):
        server["availability_zone"] = node_config["availability_zone"]
    scheduler_hints: Dict[str, Any] = {}
    if node_config.get("server_group_id"):
        scheduler_hints["group"] = node_config["server_group_id"]
    if scheduler_hints:
        server["os:scheduler_hints"] = scheduler_hints
    # preemptible capacity: spot billing via extendparam, optionally
    # price-capped; interruption policy immediate-delete matches how
    # the scaler treats reclaimed nodes (recycle the group)
    extendparam: Dict[str, Any] = {}
    if node_config.get("spot"):
        extendparam["marketType"] = "spot"
        if node_config.get("spot_price") is not None:
            extendparam["spotPrice"] = str(node_config["spot_price"])
        extendparam["interruption_policy"] = "immediate"
    if extendparam:
        server["extendparam"] = extendparam
    return {"server": server}


def workspace_resource_names(workspace: str) -> Dict[str, str]:
    return {
        "vpc": f"tik-{workspace}-vpc",
        "subnet": f"tik-{workspace}-subnet",
        "security_group": f"tik-{workspace}-sg",
        "nat": f"tik-{workspace}-nat",
        "eip": f"tik-{workspace}-eip",
        "agency": f"tik-{workspace}-agency",
        "bucket": f"tik-{workspace}-data",
    }


class HuaweiCloudNodeProvider(NodeProvider):
    """provider_config keys: region, ecs_client (injectable)."""

    def __init__(self, provider_config: Dict[str, Any], cluster_name: str):
        super().__init__(provider_config, cluster_name)
        self._client = provider_config.get("ecs_client")
        self._lock = threading.RLock()

    @staticmethod
    def bootstrap_config(cluster_config: Dict[str, Any]) -> Dict[str, Any]:
        """Resolve the workspace VPC / subnet IDs by name through the VPC
        client and default them into every node config (reference:
        huaweicloud/config.py bootstrap).  Skipped when no client."""
        provider = cluster_config.setdefault("provider", {})
        vpc_client = provider.get("vpc_client")
        if vpc_client is None:
            return cluster_config
        names = workspace_resource_names(
            cluster_config.get("workspace_name", "default"))
        vpcs = [v for v in vpc_client.list_vpcs().get("vpcs", [])
                if v.get("name") == names["vpc"]]
        if not vpcs:
            return cluster_config
        vpc_id = vpcs[0]["id"]
        subnets = [s for s in vpc_client.list_subnets().get("subnets", [])
                   if s.get("vpc_id") == vpc_id
                   and s.get("name") == names["subnet"]]
        for node_type in cluster_config.get(
                "available_node_types", {}).values():
            node_config = node_type.setdefault("node_config", {})
            node_config.setdefault("vpc_id", vpc_id)
            if subnets:
                node_config.setdefault("subnet_id", subnets[0]["id"])
        return cluster_config

    @property
    def ecs(self):
        if self._client is None:
            try:
                from huaweicloudsdkecs.v2 import EcsClient
            except ImportError as e:
                raise RuntimeError(
                    "huaweicloud provider requires huaweicloudsdkecs "
                    "(not installed in this environment)") from e
            self._client = EcsClient()
        return self._client

    def _servers(self) -> List[Dict[str, Any]]:
        resp = self.ecs.list_servers(cluster_tag=self.cluster_name)
        return resp.get("servers", [])

    def _server(self, node_id: str) -> Optional[Dict[str, Any]]:
        for s in self._servers():
            if s.get("id") == node_id:
                return s
        return None

    @staticmethod
    def _tags_of(server: Dict[str, Any]) -> Dict[str, str]:
        out = {}
        for t in server.get("tags", []):
            if "=" in t:
                k, _, v = t.partition("=")
                out[k] = v
            elif isinstance(t, dict):
                out[t.get("key", "")] = t.get("value", "")
        return out

    # -- queries -----------------------------------------------------------
    def non_terminated_nodes(self, tag_filters):
        out = []
        for s in self._servers():
            if s.get("status") not in ("BUILD", "ACTIVE"):
                continue
            tags = self._tags_of(s)
            if all(tags.get(k) == v for k, v in tag_filters.items()):
                out.append(s["id"])
        return sorted(out)

    def is_running(self, node_id):
        s = self._server(node_id)
        return bool(s) and s.get("status") == "ACTIVE"

    def is_terminated(self, node_id):
        s = self._server(node_id)
        return not s or s.get("status") in ("DELETED", "SHUTOFF")

    def node_tags(self, node_id):
        s = self._server(node_id)
        return self._tags_of(s) if s else {}

    def internal_ip(self, node_id):
        s = self._server(node_id)
        if not s:
            return None
        for addrs in (s.get("addresses") or {}).values():
            for a in addrs:
                if a.get("OS-EXT-IPS:type") == "fixed":
                    return a.get("addr")
        return None

    def external_ip(self, node_id):
        s = self._server(node_id)
        if not s:
            return None
        for addrs in (s.get("addresses") or {}).values():
            for a in addrs:
                if a.get("OS-EXT-IPS:type") == "floating":
                    return a.get("addr")
        return None

    # -- mutation ----------------------------------------------------------
    def create_node(self, node_config, tags, count):
        body = build_create_servers_request(node_config, tags, count,
                                            self.cluster_name)
        try:
            resp = self.ecs.create_servers(body)
        except Exception as e:
            raise NodeLaunchException("api", str(e))
        ids = resp.get("serverIds", [])
        return {i: {"requested": True} for i in ids}

    def set_node_tags(self, node_id, tags):
        self.ecs.batch_create_server_tags(
            node_id, [{"key": k, "value": v} for k, v in tags.items()])

    def terminate_node(self, node_id):
        self.ecs.delete_servers([node_id])
        return {node_id: "deleting"}

    @staticmethod
    def validate_config(provider_config: Dict[str, Any]) -> None:
        if not provider_config.get("ecs_client") and \
                not provider_config.get("region"):
            raise ValueError("huaweicloud provider requires region")
