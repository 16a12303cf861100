"""Huawei Cloud workspace provider: VPC / subnet / security group / NAT.

Reference parity: providers/_private/huaweicloud/config.py workspace
bootstrap (SURVEY.md §2.2 — ECS/OBS).  Resource names follow
workspace_resource_names() from the node provider; the vpc_client is
injectable with snake_case methods so tests drive the lifecycle against a
fake (the ecs_client convention of the node provider).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from cloudtik_tpu_torch.core.workspace_provider import Existence, WorkspaceProvider
from cloudtik_tpu_torch.providers.huaweicloud.node_provider import (
    workspace_resource_names)


class HuaweiCloudWorkspaceProvider(WorkspaceProvider):
    """provider_config keys: region, vpc_client (injectable)."""

    def __init__(self, provider_config: Dict[str, Any],
                 workspace_name: str):
        super().__init__(provider_config, workspace_name)
        self.region = provider_config.get("region", "cn-north-4")
        self.names = workspace_resource_names(workspace_name)
        self._client = provider_config.get("vpc_client")

    @property
    def vpc(self):
        if self._client is None:
            try:
                from huaweicloudsdkvpc.v2 import VpcClient  # noqa: F401
            except ImportError as e:
                raise RuntimeError(
                    "Huawei provider requires huaweicloudsdkvpc "
                    "(not installed in this environment)") from e
            raise RuntimeError(
                "pass provider.vpc_client (an SDK wrapper with "
                "snake_case VPC actions) — no default client is built "
                "in this environment")
        return self._client

    # -- lookups -------------------------------------------------------------
    def _find(self, items, key, name) -> Optional[Dict[str, Any]]:
        match = [i for i in items if i.get(key) == name]
        return match[0] if match else None

    def _find_vpc(self) -> Optional[Dict[str, Any]]:
        return self._find(self.vpc.list_vpcs().get("vpcs", []),
                          "name", self.names["vpc"])

    def _find_subnet(self, vpc_id: str) -> Optional[Dict[str, Any]]:
        subnets = [s for s in self.vpc.list_subnets().get("subnets", [])
                   if s.get("vpc_id") == vpc_id]
        return self._find(subnets, "name", self.names["subnet"])

    def _find_security_group(self) -> Optional[Dict[str, Any]]:
        return self._find(
            self.vpc.list_security_groups().get("security_groups", []),
            "name", self.names["security_group"])

    # -- lifecycle -------------------------------------------------------------
    def create_workspace(self, config: Dict[str, Any]) -> None:
        vpc_obj = self._find_vpc()
        if vpc_obj is None:
            vpc_obj = self.vpc.create_vpc(
                name=self.names["vpc"], cidr="10.40.0.0/16")["vpc"]
        vpc_id = vpc_obj["id"]
        if self._find_subnet(vpc_id) is None:
            self.vpc.create_subnet(
                vpc_id=vpc_id, name=self.names["subnet"],
                cidr="10.40.0.0/18",
                gateway_ip="10.40.0.1")
        group = self._find_security_group()
        if group is None:
            group = self.vpc.create_security_group(
                name=self.names["security_group"])["security_group"]
            self.vpc.create_security_group_rule(
                security_group_id=group["id"], direction="ingress",
                protocol="tcp", port_range_min=22, port_range_max=22,
                remote_ip_prefix="0.0.0.0/0")
            self.vpc.create_security_group_rule(
                security_group_id=group["id"], direction="ingress",
                protocol=None, remote_ip_prefix="10.40.0.0/16")
        nats = self.vpc.list_nat_gateways().get("nat_gateways", [])
        nat = self._find(nats, "name", self.names["nat"])
        if nat is None:
            nat = self.vpc.create_nat_gateway(
                name=self.names["nat"], router_id=vpc_id,
                internal_network_id=self._find_subnet(vpc_id)["id"])[
                    "nat_gateway"]
        self._ensure_snat(nat["id"])
        self._ensure_agency()

    def _ensure_snat(self, nat_id: str) -> None:
        """Egress needs a bound EIP plus an SNAT rule for the subnet
        CIDR — the gateway alone routes nothing (reference:
        huaweicloud/config.py EIP + SNAT provisioning)."""
        eips = self.vpc.list_eips().get("publicips", [])
        eip = self._find(eips, "alias", self.names["eip"])
        if eip is None:
            eip = self.vpc.create_eip(
                alias=self.names["eip"])["publicip"]
        rules = self.vpc.list_snat_rules(
            nat_gateway_id=nat_id).get("snat_rules", [])
        if not rules:
            self.vpc.create_snat_rule(
                nat_gateway_id=nat_id, cidr="10.40.0.0/16",
                floating_ip_id=eip["id"])

    def _ensure_agency(self) -> None:
        """Cloud agency granting nodes OBS access without static keys
        (reference: huaweicloud config.py's agency + role grant).
        Skipped when no iam_client is injected — the agency must then
        pre-exist."""
        iam = self.provider_config.get("iam_client")
        if iam is None:
            return
        agencies = iam.list_agencies().get("agencies", [])
        if self._find(agencies, "name", self.names["agency"]):
            return
        created = iam.create_agency(
            name=self.names["agency"], trust_domain_name="op_svc_ecs",
            description="tik workspace node agency")
        iam.grant_agency_role(
            agency_id=created["agency"]["id"], role_name="OBS Administrator")

    def delete_workspace(self, config: Dict[str, Any],
                         delete_managed_storage: bool = False,
                         delete_managed_database: bool = False) -> None:
        for nat in self.vpc.list_nat_gateways().get("nat_gateways", []):
            if nat.get("name") == self.names["nat"]:
                for rule in self.vpc.list_snat_rules(
                        nat_gateway_id=nat["id"]).get("snat_rules", []):
                    self.vpc.delete_snat_rule(snat_rule_id=rule["id"])
                self.vpc.delete_nat_gateway(nat_gateway_id=nat["id"])
        for eip in self.vpc.list_eips().get("publicips", []):
            if eip.get("alias") == self.names["eip"]:
                self.vpc.delete_eip(publicip_id=eip["id"])
        iam = self.provider_config.get("iam_client")
        if iam is not None:
            agency = self._find(
                iam.list_agencies().get("agencies", []),
                "name", self.names["agency"])
            if agency is not None:
                iam.delete_agency(agency_id=agency["id"])
        group = self._find_security_group()
        if group is not None:
            self.vpc.delete_security_group(security_group_id=group["id"])
        vpc_obj = self._find_vpc()
        if vpc_obj is None:
            return
        subnet = self._find_subnet(vpc_obj["id"])
        if subnet is not None:
            self.vpc.delete_subnet(vpc_id=vpc_obj["id"],
                                   subnet_id=subnet["id"])
        self.vpc.delete_vpc(vpc_id=vpc_obj["id"])

    def update_workspace(self, config: Dict[str, Any], **kwargs) -> None:
        self.create_workspace(config)

    def check_workspace_existence(self, config: Dict[str, Any]) -> Existence:
        vpc_obj = self._find_vpc()
        if vpc_obj is None:
            return Existence.NOT_EXIST
        pieces = [vpc_obj, self._find_subnet(vpc_obj["id"]),
                  self._find_security_group()]
        if all(p is not None for p in pieces):
            return Existence.COMPLETED
        return Existence.IN_COMPLETED
