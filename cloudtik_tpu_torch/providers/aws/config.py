"""AWS request/config builders — pure functions, SDK-free.

Reference parity: providers/_private/aws/config.py (SURVEY.md §2.2 — VPC/
IAM bootstrap, 7,146 LoC).  The bootstrap derivations (instance requests,
tag specs, network layout) are pure and unit-tested; only the thin
boto3 calls in node_provider.py need credentials.
"""

from __future__ import annotations

import ipaddress
from typing import Any, Dict, List, Optional

TAG_PREFIX = "tik:"


def to_aws_tags(tags: Dict[str, str]) -> List[Dict[str, str]]:
    """tik tag dict -> EC2 TagSpecification entries (Name derived)."""
    out = [{"Key": k, "Value": v} for k, v in sorted(tags.items())]
    name = tags.get("tik-node-name") or (
        f"{tags.get('tik-cluster-name', 'tik')}-"
        f"{tags.get('tik-node-kind', 'node')}")
    out.append({"Key": "Name", "Value": name})
    return out


def from_aws_tags(aws_tags: List[Dict[str, str]]) -> Dict[str, str]:
    return {t["Key"]: t["Value"] for t in aws_tags or []
            if t["Key"] != "Name"}


def tag_filters_to_aws(tag_filters: Dict[str, str],
                       cluster_name: str) -> List[Dict[str, Any]]:
    """EC2 describe-instances Filters for live nodes of this cluster."""
    filters = [
        {"Name": "instance-state-name",
         "Values": ["pending", "running"]},
        {"Name": "tag:tik-cluster-name", "Values": [cluster_name]},
    ]
    for k, v in sorted(tag_filters.items()):
        filters.append({"Name": f"tag:{k}", "Values": [v]})
    return filters


def build_run_instances_request(
        node_config: Dict[str, Any], tags: Dict[str, str],
        count: int) -> Dict[str, Any]:
    """node_config (cluster-YAML shape) -> EC2 RunInstances kwargs."""
    req: Dict[str, Any] = {
        "MinCount": count,
        "MaxCount": count,
        "InstanceType": node_config.get("InstanceType",
                                        node_config.get("instance_type",
                                                        "m5.large")),
        "TagSpecifications": [{
            "ResourceType": "instance",
            "Tags": to_aws_tags(tags),
        }],
    }
    for key in ("ImageId", "KeyName", "SubnetId", "SecurityGroupIds",
                "IamInstanceProfile", "UserData", "BlockDeviceMappings",
                "Placement"):
        if key in node_config:
            req[key] = node_config[key]
    market = node_config.get("InstanceMarketOptions") or (
        {"MarketType": "spot"} if node_config.get("spot") else None)
    if market:
        req["InstanceMarketOptions"] = market
    return req


def derive_network_layout(vpc_cidr: str = "10.0.0.0/16",
                          num_azs: int = 2) -> Dict[str, Any]:
    """Workspace network plan: public subnet (head/NAT) + private subnets
    (workers) per AZ — the reference's VPC shape (aws/config.py)."""
    net = ipaddress.ip_network(vpc_cidr)
    subnets = list(net.subnets(new_prefix=net.prefixlen + 4))
    layout = {"vpc_cidr": vpc_cidr, "public": [], "private": []}
    for i in range(num_azs):
        layout["public"].append(str(subnets[i]))
        layout["private"].append(str(subnets[num_azs + i]))
    return layout


def workspace_resource_names(workspace: str) -> Dict[str, str]:
    return {
        "vpc": f"tik-{workspace}-vpc",
        "igw": f"tik-{workspace}-igw",
        "nat": f"tik-{workspace}-nat",
        "security_group": f"tik-{workspace}-sg",
        "head_role": f"tik-{workspace}-head-role",
        "worker_role": f"tik-{workspace}-worker-role",
        "head_profile": f"tik-{workspace}-head-profile",
        "worker_profile": f"tik-{workspace}-worker-profile",
        "bucket": f"tik-{workspace}-data",
    }


def head_iam_policy(workspace: str, bucket: Optional[str] = None
                    ) -> Dict[str, Any]:
    """Head node instance policy: EC2 node mgmt + workspace bucket."""
    statements: List[Dict[str, Any]] = [{
        "Effect": "Allow",
        "Action": ["ec2:RunInstances", "ec2:TerminateInstances",
                   "ec2:DescribeInstances", "ec2:CreateTags",
                   "ec2:DeleteTags"],
        "Resource": "*",
    }]
    if bucket:
        statements.append({
            "Effect": "Allow",
            "Action": ["s3:GetObject", "s3:PutObject", "s3:ListBucket"],
            "Resource": [f"arn:aws:s3:::{bucket}",
                         f"arn:aws:s3:::{bucket}/*"],
        })
    return {"Version": "2012-10-17", "Statement": statements}


def security_group_rules(vpc_cidr: str,
                         ssh_cidr: str = "0.0.0.0/0") -> List[Dict[str, Any]]:
    """Intra-VPC all + SSH ingress (reference SG shape)."""
    return [
        {"IpProtocol": "-1",
         "IpRanges": [{"CidrIp": vpc_cidr,
                       "Description": "intra-workspace"}]},
        {"IpProtocol": "tcp", "FromPort": 22, "ToPort": 22,
         "IpRanges": [{"CidrIp": ssh_cidr, "Description": "ssh"}]},
    ]
