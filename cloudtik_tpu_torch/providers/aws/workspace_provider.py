"""AWS workspace provider: VPC/subnets/NAT/SG/IAM/S3 shared infra.

Reference parity: providers/_private/aws/config.py VPC/IAM bootstrap +
workspace_provider (SURVEY.md §2.2, §3.5 call stack).  The create sequence
mirrors the reference: VPC -> IGW -> subnets (public head, private
workers) -> NAT -> route tables -> SG -> IAM roles/profiles -> optional
bucket.  Each step is idempotent (create-if-absent by name tag).
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.core.workspace_provider import (
    Existence, WorkspaceProvider)
from cloudtik_tpu_torch.providers.aws.config import (
    derive_network_layout, head_iam_policy, security_group_rules,
    workspace_resource_names)

logger = logging.getLogger(__name__)


class AWSWorkspaceProvider(WorkspaceProvider):
    def __init__(self, provider_config: Dict[str, Any],
                 workspace_name: str):
        super().__init__(provider_config, workspace_name)
        self.names = workspace_resource_names(workspace_name)
        self._ec2 = provider_config.get("ec2_client")
        self._iam = provider_config.get("iam_client")

    @property
    def ec2(self):
        if self._ec2 is None:
            from cloudtik_tpu_torch.providers.aws.node_provider import _boto3
            boto3 = _boto3()
            self._ec2 = boto3.session.Session(
                region_name=self.provider_config.get("region")
            ).client("ec2")
        return self._ec2

    @property
    def iam(self):
        if self._iam is None:
            from cloudtik_tpu_torch.providers.aws.node_provider import _boto3
            boto3 = _boto3()
            self._iam = boto3.session.Session(
                region_name=self.provider_config.get("region")
            ).client("iam")
        return self._iam

    # -- queries -----------------------------------------------------------
    def _find_vpc(self) -> Optional[Dict[str, Any]]:
        resp = self.ec2.describe_vpcs(Filters=[
            {"Name": "tag:Name", "Values": [self.names["vpc"]]}])
        vpcs = resp.get("Vpcs", [])
        return vpcs[0] if vpcs else None

    def check_existence(self) -> str:
        vpc = self._find_vpc()
        if vpc is None:
            return Existence.NOT_EXIST
        subnets = self.ec2.describe_subnets(Filters=[
            {"Name": "vpc-id", "Values": [vpc["VpcId"]]}]).get(
                "Subnets", [])
        return Existence.COMPLETED if subnets else Existence.IN_COMPLETED

    # -- create ------------------------------------------------------------
    def _find_by_name(self, describe, result_key: str, name: str):
        items = describe(Filters=[
            {"Name": "tag:Name", "Values": [name]}]).get(result_key, [])
        return items[0] if items else None

    def create_workspace(self, config: Dict[str, Any]) -> None:
        """Idempotent: every step is find-by-Name-tag-then-create, so a
        failed run can be repaired by re-running."""
        layout = derive_network_layout(
            self.provider_config.get("vpc_cidr", "10.0.0.0/16"),
            num_azs=int(self.provider_config.get("num_azs", 2)))
        vpc = self._find_vpc()
        if vpc is None:
            vpc = self.ec2.create_vpc(
                CidrBlock=layout["vpc_cidr"],
                TagSpecifications=[{
                    "ResourceType": "vpc",
                    "Tags": [{"Key": "Name",
                              "Value": self.names["vpc"]}]}])["Vpc"]
        vpc_id = vpc["VpcId"]
        igw = self._find_by_name(self.ec2.describe_internet_gateways,
                                 "InternetGateways", self.names["igw"])
        if igw is None:
            igw = self.ec2.create_internet_gateway(
                TagSpecifications=[{
                    "ResourceType": "internet-gateway",
                    "Tags": [{"Key": "Name",
                              "Value": self.names["igw"]}],
                }])["InternetGateway"]
            self.ec2.attach_internet_gateway(
                InternetGatewayId=igw["InternetGatewayId"], VpcId=vpc_id)
        azs = [z["ZoneName"] for z in
               self.ec2.describe_availability_zones()[
                   "AvailabilityZones"]]
        subnet_ids = {"public": [], "private": []}
        for kind in ("public", "private"):
            for i, cidr in enumerate(layout[kind]):
                name = f"{self.names['vpc']}-{kind}-{i}"
                subnet = self._find_by_name(
                    self.ec2.describe_subnets, "Subnets", name)
                if subnet is None:
                    subnet = self.ec2.create_subnet(
                        VpcId=vpc_id, CidrBlock=cidr,
                        AvailabilityZone=azs[i % len(azs)],
                        TagSpecifications=[{
                            "ResourceType": "subnet",
                            "Tags": [{"Key": "Name", "Value": name},
                                     {"Key": "tik:subnet-kind",
                                      "Value": kind}]}])["Subnet"]
                subnet_ids[kind].append(subnet["SubnetId"])
        existing_sgs = self.ec2.describe_security_groups(Filters=[
            {"Name": "group-name",
             "Values": [self.names["security_group"]]},
            {"Name": "vpc-id", "Values": [vpc_id]}])["SecurityGroups"]
        if not existing_sgs:
            sg = self.ec2.create_security_group(
                GroupName=self.names["security_group"],
                Description=f"tik workspace {self.workspace_name}",
                VpcId=vpc_id)
            self.ec2.authorize_security_group_ingress(
                GroupId=sg["GroupId"],
                IpPermissions=security_group_rules(layout["vpc_cidr"]))
        self._create_nat_and_routes(vpc_id, igw, subnet_ids)
        self._create_iam()

    def _create_nat_and_routes(self, vpc_id: str, igw: Dict[str, Any],
                               subnet_ids: Dict[str, List[str]]) -> None:
        """NAT in public subnet 0 + route tables: public -> IGW,
        private -> NAT (worker-subnet egress, reference VPC shape)."""
        if not subnet_ids["public"]:
            return
        nat = self._find_by_name(self.ec2.describe_nat_gateways,
                                 "NatGateways", self.names["nat"])
        if nat is None:
            eip = self.ec2.allocate_address(Domain="vpc")
            nat = self.ec2.create_nat_gateway(
                SubnetId=subnet_ids["public"][0],
                AllocationId=eip["AllocationId"],
                TagSpecifications=[{
                    "ResourceType": "natgateway",
                    "Tags": [{"Key": "Name",
                              "Value": self.names["nat"]}],
                }])["NatGateway"]
        for kind, target in (("public", {
                "GatewayId": igw["InternetGatewayId"]}), ("private", {
                "NatGatewayId": nat["NatGatewayId"]})):
            name = f"{self.names['vpc']}-{kind}-rt"
            rt = self._find_by_name(self.ec2.describe_route_tables,
                                    "RouteTables", name)
            if rt is None:
                rt = self.ec2.create_route_table(
                    VpcId=vpc_id,
                    TagSpecifications=[{
                        "ResourceType": "route-table",
                        "Tags": [{"Key": "Name", "Value": name}],
                    }])["RouteTable"]
                self.ec2.create_route(
                    RouteTableId=rt["RouteTableId"],
                    DestinationCidrBlock="0.0.0.0/0", **target)
                for subnet_id in subnet_ids[kind]:
                    self.ec2.associate_route_table(
                        RouteTableId=rt["RouteTableId"],
                        SubnetId=subnet_id)

    def _create_iam(self) -> None:
        assume = json.dumps({
            "Version": "2012-10-17",
            "Statement": [{"Effect": "Allow",
                           "Principal": {"Service": "ec2.amazonaws.com"},
                           "Action": "sts:AssumeRole"}]})
        for role_key, profile_key, policy in (
                ("head_role", "head_profile",
                 head_iam_policy(self.workspace_name,
                                 self.names["bucket"])),
                ("worker_role", "worker_profile", None)):
            role = self.names[role_key]
            try:
                self.iam.create_role(RoleName=role,
                                     AssumeRolePolicyDocument=assume)
            except Exception:
                pass  # exists
            if policy:
                self.iam.put_role_policy(
                    RoleName=role, PolicyName=f"{role}-inline",
                    PolicyDocument=json.dumps(policy))
            profile = self.names[profile_key]
            try:
                self.iam.create_instance_profile(
                    InstanceProfileName=profile)
                self.iam.add_role_to_instance_profile(
                    InstanceProfileName=profile, RoleName=role)
            except Exception:
                pass

    # -- delete ------------------------------------------------------------
    def delete_workspace(self, config: Dict[str, Any]) -> None:
        vpc = self._find_vpc()
        if vpc is None:
            return
        vpc_id = vpc["VpcId"]
        for sn in self.ec2.describe_subnets(Filters=[
                {"Name": "vpc-id", "Values": [vpc_id]}])["Subnets"]:
            self.ec2.delete_subnet(SubnetId=sn["SubnetId"])
        for igw in self.ec2.describe_internet_gateways(Filters=[
                {"Name": "attachment.vpc-id",
                 "Values": [vpc_id]}])["InternetGateways"]:
            self.ec2.detach_internet_gateway(
                InternetGatewayId=igw["InternetGatewayId"], VpcId=vpc_id)
            self.ec2.delete_internet_gateway(
                InternetGatewayId=igw["InternetGatewayId"])
        for sg in self.ec2.describe_security_groups(Filters=[
                {"Name": "vpc-id", "Values": [vpc_id]}])[
                    "SecurityGroups"]:
            if sg["GroupName"] != "default":
                self.ec2.delete_security_group(GroupId=sg["GroupId"])
        self.ec2.delete_vpc(VpcId=vpc_id)
