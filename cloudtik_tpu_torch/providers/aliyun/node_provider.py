"""Alibaba Cloud (Aliyun) ECS node provider.

Reference parity: providers/_private/aliyun (SURVEY.md §2.2 — ECS/OSS,
4,598 LoC).  Request builders are pure; the ECS client is injectable and
the SDK import lazy.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.core.node_provider import (
    NodeLaunchException, NodeProvider)


def build_run_instances_request(
        node_config: Dict[str, Any], tags: Dict[str, str],
        count: int, cluster_name: str) -> Dict[str, Any]:
    """node_config -> ECS RunInstances request params."""
    ali_tags = [{"Key": k, "Value": v}
                for k, v in sorted({**tags,
                                    "tik-cluster-name":
                                    cluster_name}.items())]
    req = {
        "Amount": count,
        "InstanceType": node_config.get("instance_type",
                                        "ecs.g7.xlarge"),
        "ImageId": node_config.get("image_id",
                                   "ubuntu_22_04_x64_20G_alibase"),
        "InternetMaxBandwidthOut": node_config.get("bandwidth_out", 0),
        "Tag": ali_tags,
    }
    for src, dst in (("v_switch_id", "VSwitchId"),
                     ("security_group_id", "SecurityGroupId"),
                     ("key_pair_name", "KeyPairName"),
                     ("system_disk_size", "SystemDisk.Size"),
                     # placement (reference aliyun/config.py options):
                     # zone pinning + deployment sets (ECS's spread
                     # placement groups) + dedicated hosts
                     ("zone_id", "ZoneId"),
                     ("deployment_set_id", "DeploymentSetId"),
                     ("dedicated_host_id", "DedicatedHostId")):
        if src in node_config:
            req[dst] = node_config[src]
    if node_config.get("spot"):
        # preemptible capacity: price-capped when spot_price_limit is
        # given, market-price otherwise; SpotDuration=0 means no
        # protected hour (reclaim any time, cheapest)
        limit = node_config.get("spot_price_limit")
        if limit is not None:
            req["SpotStrategy"] = "SpotWithPriceLimit"
            req["SpotPriceLimit"] = float(limit)
        else:
            req["SpotStrategy"] = "SpotAsPriceGo"
        if "spot_duration" in node_config:
            req["SpotDuration"] = int(node_config["spot_duration"])
    return req


def workspace_resource_names(workspace: str) -> Dict[str, str]:
    return {
        "vpc": f"tik-{workspace}-vpc",
        "vswitch": f"tik-{workspace}-vswitch",
        "security_group": f"tik-{workspace}-sg",
        "nat": f"tik-{workspace}-nat",
        "eip": f"tik-{workspace}-eip",
        "ram_role": f"tik-{workspace}-role",
        "bucket": f"tik-{workspace}-data",
    }


class AliyunNodeProvider(NodeProvider):
    """provider_config keys: region_id, ecs_client (injectable)."""

    def __init__(self, provider_config: Dict[str, Any], cluster_name: str):
        super().__init__(provider_config, cluster_name)
        self._client = provider_config.get("ecs_client")
        self._lock = threading.RLock()

    @staticmethod
    def bootstrap_config(cluster_config: Dict[str, Any]) -> Dict[str, Any]:
        """Resolve workspace network IDs (vSwitch / security group) by
        name through the VPC client and default them into every node
        config — the reference's aliyun/config.py bootstrap.  Skipped
        gracefully when no client/SDK is available (IDs must then be set
        explicitly)."""
        provider = cluster_config.setdefault("provider", {})
        vpc_client = provider.get("vpc_client")
        if vpc_client is None:
            return cluster_config
        names = workspace_resource_names(
            cluster_config.get("workspace_name", "default"))
        vpcs = vpc_client.describe_vpcs(vpc_name=names["vpc"]).get(
            "Vpcs", {}).get("Vpc", [])
        if not vpcs:
            return cluster_config
        vpc_id = vpcs[0]["VpcId"]
        vswitches = [
            v for v in vpc_client.describe_vswitches(vpc_id=vpc_id)
            .get("VSwitches", {}).get("VSwitch", [])
            if v.get("VSwitchName") == names["vswitch"]]
        groups = [
            g for g in vpc_client.describe_security_groups(vpc_id=vpc_id)
            .get("SecurityGroups", {}).get("SecurityGroup", [])
            if g.get("SecurityGroupName") == names["security_group"]]
        for node_type in cluster_config.get(
                "available_node_types", {}).values():
            node_config = node_type.setdefault("node_config", {})
            if vswitches:
                node_config.setdefault(
                    "v_switch_id", vswitches[0]["VSwitchId"])
            if groups:
                node_config.setdefault(
                    "security_group_id", groups[0]["SecurityGroupId"])
        return cluster_config

    @property
    def ecs(self):
        if self._client is None:
            try:
                from aliyunsdkcore.client import AcsClient
            except ImportError as e:
                raise RuntimeError(
                    "aliyun provider requires aliyunsdkcore (not "
                    "installed in this environment)") from e
            self._client = AcsClient(
                region_id=self.provider_config.get("region_id"))
        return self._client

    def _describe(self) -> List[Dict[str, Any]]:
        resp = self.ecs.describe_instances(
            cluster_tag=self.cluster_name)
        return resp.get("Instances", [])

    def _instance(self, node_id: str) -> Optional[Dict[str, Any]]:
        for inst in self._describe():
            if inst.get("InstanceId") == node_id:
                return inst
        return None

    @staticmethod
    def _tags_of(inst: Dict[str, Any]) -> Dict[str, str]:
        return {t["Key"]: t["Value"]
                for t in inst.get("Tags", {}).get("Tag", [])}

    # -- queries -----------------------------------------------------------
    def non_terminated_nodes(self, tag_filters):
        out = []
        for inst in self._describe():
            if inst.get("Status") not in ("Pending", "Starting",
                                          "Running"):
                continue
            tags = self._tags_of(inst)
            if all(tags.get(k) == v for k, v in tag_filters.items()):
                out.append(inst["InstanceId"])
        return sorted(out)

    def is_running(self, node_id):
        inst = self._instance(node_id)
        return bool(inst) and inst.get("Status") == "Running"

    def is_terminated(self, node_id):
        inst = self._instance(node_id)
        return not inst or inst.get("Status") in ("Stopped", "Released")

    def node_tags(self, node_id):
        inst = self._instance(node_id)
        return self._tags_of(inst) if inst else {}

    def internal_ip(self, node_id):
        inst = self._instance(node_id)
        if not inst:
            return None
        ips = inst.get("VpcAttributes", {}).get(
            "PrivateIpAddress", {}).get("IpAddress", [])
        return ips[0] if ips else None

    def external_ip(self, node_id):
        inst = self._instance(node_id)
        if not inst:
            return None
        ips = inst.get("PublicIpAddress", {}).get("IpAddress", [])
        return ips[0] if ips else None

    # -- mutation ----------------------------------------------------------
    def create_node(self, node_config, tags, count):
        req = build_run_instances_request(node_config, tags, count,
                                          self.cluster_name)
        try:
            resp = self.ecs.run_instances(**req)
        except Exception as e:
            raise NodeLaunchException("api", str(e))
        ids = resp.get("InstanceIdSets", {}).get("InstanceIdSet", [])
        return {i: {"requested": True} for i in ids}

    def set_node_tags(self, node_id, tags):
        self.ecs.tag_resources(
            resource_ids=[node_id],
            tags=[{"Key": k, "Value": v} for k, v in tags.items()])

    def terminate_node(self, node_id):
        self.ecs.delete_instance(instance_id=node_id, force=True)
        return {node_id: "releasing"}

    @staticmethod
    def validate_config(provider_config: Dict[str, Any]) -> None:
        if not provider_config.get("ecs_client") and \
                not provider_config.get("region_id"):
            raise ValueError("aliyun provider requires region_id")
