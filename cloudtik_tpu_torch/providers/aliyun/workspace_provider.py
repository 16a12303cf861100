"""Aliyun workspace provider: VPC / vSwitch / security group / NAT.

Reference parity: providers/_private/aliyun/config.py workspace bootstrap
(SURVEY.md §2.2 — ECS/OSS).  Resource names follow
workspace_resource_names() from the node provider.  The vpc_client is
injectable with snake_case methods (the same convention the node
provider's ecs_client uses), so tests drive the full lifecycle against a
fake.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.core.workspace_provider import Existence, WorkspaceProvider
from cloudtik_tpu_torch.providers.aliyun.node_provider import (
    workspace_resource_names)


class AliyunWorkspaceProvider(WorkspaceProvider):
    """provider_config keys: region, zone_id, vpc_client (injectable)."""

    def __init__(self, provider_config: Dict[str, Any],
                 workspace_name: str):
        super().__init__(provider_config, workspace_name)
        self.region = provider_config.get("region", "cn-hangzhou")
        self.zone = provider_config.get("zone_id", f"{self.region}-a")
        self.names = workspace_resource_names(workspace_name)
        self._client = provider_config.get("vpc_client")

    @property
    def vpc(self):
        if self._client is None:
            try:
                from aliyunsdkcore.client import AcsClient  # noqa: F401
            except ImportError as e:
                raise RuntimeError(
                    "Aliyun provider requires aliyunsdkcore "
                    "(not installed in this environment)") from e
            raise RuntimeError(
                "pass provider.vpc_client (an SDK wrapper with "
                "snake_case VPC actions) — no default client is built "
                "in this environment")
        return self._client

    # -- lookups ------------------------------------------------------------
    def _find_vpc(self) -> Optional[Dict[str, Any]]:
        resp = self.vpc.describe_vpcs(vpc_name=self.names["vpc"])
        vpcs = resp.get("Vpcs", {}).get("Vpc", [])
        return vpcs[0] if vpcs else None

    def _find_vswitch(self, vpc_id: str) -> Optional[Dict[str, Any]]:
        resp = self.vpc.describe_vswitches(vpc_id=vpc_id)
        vsw = [v for v in resp.get("VSwitches", {}).get("VSwitch", [])
               if v.get("VSwitchName") == self.names["vswitch"]]
        return vsw[0] if vsw else None

    def _find_security_group(self, vpc_id: str) -> Optional[Dict[str, Any]]:
        resp = self.vpc.describe_security_groups(vpc_id=vpc_id)
        groups = [g for g in resp.get("SecurityGroups", {})
                  .get("SecurityGroup", [])
                  if g.get("SecurityGroupName")
                  == self.names["security_group"]]
        return groups[0] if groups else None

    # -- lifecycle ----------------------------------------------------------
    def create_workspace(self, config: Dict[str, Any]) -> None:
        vpc_obj = self._find_vpc()
        if vpc_obj is None:
            created = self.vpc.create_vpc(
                vpc_name=self.names["vpc"], cidr_block="10.30.0.0/16")
            vpc_id = created["VpcId"]
        else:
            vpc_id = vpc_obj["VpcId"]
        if self._find_vswitch(vpc_id) is None:
            self.vpc.create_vswitch(
                vpc_id=vpc_id, zone_id=self.zone,
                v_switch_name=self.names["vswitch"],
                cidr_block="10.30.0.0/18")
        group = self._find_security_group(vpc_id)
        if group is None:
            created = self.vpc.create_security_group(
                vpc_id=vpc_id,
                security_group_name=self.names["security_group"])
            group_id = created["SecurityGroupId"]
            # SSH from anywhere; everything inside the VPC CIDR
            self.vpc.authorize_security_group(
                security_group_id=group_id, ip_protocol="tcp",
                port_range="22/22", source_cidr_ip="0.0.0.0/0")
            self.vpc.authorize_security_group(
                security_group_id=group_id, ip_protocol="all",
                port_range="-1/-1", source_cidr_ip="10.30.0.0/16")
        nats = self.vpc.describe_nat_gateways(vpc_id=vpc_id).get(
            "NatGateways", {}).get("NatGateway", [])
        if not nats:
            created = self.vpc.create_nat_gateway(
                vpc_id=vpc_id, name=self.names["nat"])
            nat_id = created["NatGatewayId"]
        else:
            nat_id = nats[0]["NatGatewayId"]
        self._ensure_nat_egress(nat_id)
        self._ensure_ram_role()

    def _ensure_nat_egress(self, nat_id: str) -> None:
        """A NAT gateway alone routes nothing: egress needs an EIP bound
        to it plus an SNAT entry for the workspace CIDR (reference:
        aliyun/config.py's EIP + SNAT provisioning)."""
        eips = self.vpc.describe_eip_addresses(
            name=self.names["eip"]).get(
                "EipAddresses", {}).get("EipAddress", [])
        if not eips:
            eip = self.vpc.allocate_eip_address(name=self.names["eip"])
        else:
            eip = eips[0]
        # idempotent re-run after a partial failure: an allocated but
        # never-associated EIP must still get bound, or the SNAT entry
        # points at an address that routes nothing
        if not eip.get("InstanceId"):
            self.vpc.associate_eip_address(
                allocation_id=eip["AllocationId"], instance_id=nat_id,
                instance_type="Nat")
        eip_ip = eip.get("IpAddress", "")
        snats = self.vpc.describe_snat_table_entries(
            nat_gateway_id=nat_id).get(
                "SnatTableEntries", {}).get("SnatTableEntry", [])
        if not snats:
            self.vpc.create_snat_entry(
                nat_gateway_id=nat_id, source_cidr="10.30.0.0/16",
                snat_ip=eip_ip)

    def _ensure_ram_role(self) -> None:
        """Instance RAM role with OSS access, so cluster nodes reach the
        workspace bucket without static keys (reference: aliyun
        config.py's RAM role + policy attachment).  Skipped when no
        ram_client is injected — the role must then pre-exist."""
        ram = self.provider_config.get("ram_client")
        if ram is None:
            return
        roles = ram.list_roles().get("Roles", {}).get("Role", [])
        if any(r.get("RoleName") == self.names["ram_role"]
               for r in roles):
            return
        ram.create_role(
            role_name=self.names["ram_role"],
            assume_role_policy_document=(
                '{"Statement": [{"Action": "sts:AssumeRole", '
                '"Effect": "Allow", "Principal": {"Service": '
                '["ecs.aliyuncs.com"]}}], "Version": "1"}'))
        ram.attach_policy_to_role(
            policy_type="System", policy_name="AliyunOSSFullAccess",
            role_name=self.names["ram_role"])

    def delete_workspace(self, config: Dict[str, Any],
                         delete_managed_storage: bool = False,
                         delete_managed_database: bool = False) -> None:
        vpc_obj = self._find_vpc()
        if vpc_obj is None:
            return
        vpc_id = vpc_obj["VpcId"]
        for nat in self.vpc.describe_nat_gateways(vpc_id=vpc_id).get(
                "NatGateways", {}).get("NatGateway", []):
            for entry in self.vpc.describe_snat_table_entries(
                    nat_gateway_id=nat["NatGatewayId"]).get(
                        "SnatTableEntries", {}).get("SnatTableEntry", []):
                self.vpc.delete_snat_entry(
                    snat_entry_id=entry["SnatEntryId"])
            self.vpc.delete_nat_gateway(
                nat_gateway_id=nat["NatGatewayId"])
        for eip in self.vpc.describe_eip_addresses(
                name=self.names["eip"]).get(
                    "EipAddresses", {}).get("EipAddress", []):
            self.vpc.release_eip_address(
                allocation_id=eip["AllocationId"])
        ram = self.provider_config.get("ram_client")
        if ram is not None:
            roles = ram.list_roles().get("Roles", {}).get("Role", [])
            if any(r.get("RoleName") == self.names["ram_role"]
                   for r in roles):
                ram.detach_policy_from_role(
                    policy_type="System",
                    policy_name="AliyunOSSFullAccess",
                    role_name=self.names["ram_role"])
                ram.delete_role(role_name=self.names["ram_role"])
        group = self._find_security_group(vpc_id)
        if group is not None:
            self.vpc.delete_security_group(
                security_group_id=group["SecurityGroupId"])
        vswitch = self._find_vswitch(vpc_id)
        if vswitch is not None:
            self.vpc.delete_vswitch(v_switch_id=vswitch["VSwitchId"])
        self.vpc.delete_vpc(vpc_id=vpc_id)

    def update_workspace(self, config: Dict[str, Any], **kwargs) -> None:
        self.create_workspace(config)

    def check_workspace_existence(self, config: Dict[str, Any]) -> Existence:
        vpc_obj = self._find_vpc()
        if vpc_obj is None:
            return Existence.NOT_EXIST
        vpc_id = vpc_obj["VpcId"]
        pieces: List[Optional[Dict[str, Any]]] = [
            vpc_obj,
            self._find_vswitch(vpc_id),
            self._find_security_group(vpc_id),
        ]
        if all(p is not None for p in pieces):
            return Existence.COMPLETED
        return Existence.IN_COMPLETED
