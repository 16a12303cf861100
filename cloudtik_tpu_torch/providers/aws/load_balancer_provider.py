"""AWS load-balancer provider: NLB (ELBv2) reconciliation.

Reference parity: providers/_private/aws ELB management driven by the
loadbalancer runtime (SURVEY.md §2.2/§2.3).  One LB reconciles as:

    network LB -> target group (TargetType=ip, the discovered ip:port
    targets) -> listener on the service port

Managed-state identification rides ELB tags (tik-managed/tik-workspace),
the AWS-native equivalent of the GCP provider's description JSON.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.core.load_balancer_provider import (
    LoadBalancerProvider, LoadBalancerScheme)
from cloudtik_tpu_torch.providers.aws.node_provider import _boto3


def _code(e: Exception) -> str:
    return getattr(e, "response", {}).get("Error", {}).get("Code", "")


class AWSLoadBalancerProvider(LoadBalancerProvider):
    """provider_config keys: region, profile, subnet_ids, vpc_id,
    elbv2_client (tests)."""

    def __init__(self, provider_config: Dict[str, Any],
                 workspace_name: str):
        super().__init__(provider_config, workspace_name)
        self.region = provider_config.get("region", "us-west-2")
        self._client = provider_config.get("elbv2_client")

    @property
    def elbv2(self):
        if self._client is None:
            boto3 = _boto3()
            session = boto3.session.Session(
                profile_name=self.provider_config.get("profile"),
                region_name=self.region)
            self._client = session.client("elbv2")
        return self._client

    def support_multi_service_group(self) -> bool:
        return False

    # -- listing -----------------------------------------------------------
    def list(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        paginator = self.elbv2.get_paginator("describe_load_balancers")
        lbs: List[Dict[str, Any]] = []
        for page in paginator.paginate():
            lbs.extend(page.get("LoadBalancers", []))
        if not lbs:
            return out
        arns = [lb["LoadBalancerArn"] for lb in lbs]
        tags_by_arn: Dict[str, Dict[str, str]] = {}
        for i in range(0, len(arns), 20):  # DescribeTags caps at 20 ARNs
            resp = self.elbv2.describe_tags(ResourceArns=arns[i:i + 20])
            for desc in resp.get("TagDescriptions", []):
                tags_by_arn[desc["ResourceArn"]] = {
                    t["Key"]: t["Value"] for t in desc.get("Tags", [])}
        for lb in lbs:
            tags = tags_by_arn.get(lb["LoadBalancerArn"], {})
            if tags.get("tik-managed") != "true":
                continue
            if tags.get("tik-workspace") != self.workspace_name:
                continue
            info = {
                "name": lb["LoadBalancerName"],
                "arn": lb["LoadBalancerArn"],
                "dns": lb.get("DNSName"),
                "scheme": (LoadBalancerScheme.INTERNAL
                           if lb.get("Scheme") == "internal"
                           else LoadBalancerScheme.INTERNET_FACING),
                "managed": True,
                "port": None,
                "targets": [],
            }
            info.update(self._targets_of(lb["LoadBalancerArn"]))
            out[info["name"]] = info
        return out

    def _targets_of(self, lb_arn: str) -> Dict[str, Any]:
        tgs = self.elbv2.describe_target_groups(
            LoadBalancerArn=lb_arn).get("TargetGroups", [])
        if not tgs:
            return {"port": None, "targets": [], "target_group_arn": None}
        tg = tgs[0]
        health = self.elbv2.describe_target_health(
            TargetGroupArn=tg["TargetGroupArn"])
        targets = sorted(
            ({"ip": d["Target"]["Id"], "port": d["Target"]["Port"]}
             for d in health.get("TargetHealthDescriptions", [])),
            key=lambda t: (t["ip"], t["port"]))
        return {"port": tg.get("Port"), "targets": targets,
                "target_group_arn": tg["TargetGroupArn"]}

    # -- create/update/delete ---------------------------------------------
    def create(self, load_balancer_config: Dict[str, Any]) -> None:
        name = load_balancer_config["name"]
        port = int(load_balancer_config["port"])
        scheme = load_balancer_config.get(
            "scheme", LoadBalancerScheme.INTERNAL)
        lb = self.elbv2.create_load_balancer(
            Name=name,
            Type="network",
            Scheme=("internal" if scheme != LoadBalancerScheme
                    .INTERNET_FACING else "internet-facing"),
            Subnets=list(self.provider_config.get("subnet_ids", [])),
            Tags=[{"Key": "tik-managed", "Value": "true"},
                  {"Key": "tik-workspace",
                   "Value": self.workspace_name}],
        )["LoadBalancers"][0]
        tg = self.elbv2.create_target_group(
            Name=f"{name}-tg"[:32],
            Protocol="TCP",
            Port=port,
            TargetType="ip",
            VpcId=self.provider_config.get("vpc_id", ""),
        )["TargetGroups"][0]
        targets = [{"Id": t["ip"], "Port": int(t["port"])}
                   for t in load_balancer_config.get("targets", [])]
        if targets:
            self.elbv2.register_targets(
                TargetGroupArn=tg["TargetGroupArn"], Targets=targets)
        self.elbv2.create_listener(
            LoadBalancerArn=lb["LoadBalancerArn"],
            Protocol="TCP", Port=port,
            DefaultActions=[{"Type": "forward",
                             "TargetGroupArn": tg["TargetGroupArn"]}])

    def update(self, load_balancer: Dict[str, Any],
               load_balancer_config: Dict[str, Any]) -> None:
        tg_arn = load_balancer.get("target_group_arn")
        if not tg_arn:
            return
        want = [{"Id": t["ip"], "Port": int(t["port"])}
                for t in load_balancer_config.get("targets", [])]
        have = [{"Id": t["ip"], "Port": int(t["port"])}
                for t in load_balancer.get("targets", [])]
        register = [t for t in want if t not in have]
        deregister = [t for t in have if t not in want]
        if register:
            self.elbv2.register_targets(TargetGroupArn=tg_arn,
                                        Targets=register)
        if deregister:
            self.elbv2.deregister_targets(TargetGroupArn=tg_arn,
                                          Targets=deregister)

    def delete(self, load_balancer: Dict[str, Any]) -> None:
        arn = load_balancer.get("arn")
        if not arn:
            return
        for listener in self.elbv2.describe_listeners(
                LoadBalancerArn=arn).get("Listeners", []):
            self.elbv2.delete_listener(
                ListenerArn=listener["ListenerArn"])
        tg_arn = load_balancer.get("target_group_arn")
        self.elbv2.delete_load_balancer(LoadBalancerArn=arn)
        if tg_arn:
            try:
                self.elbv2.delete_target_group(TargetGroupArn=tg_arn)
            except Exception as e:
                if _code(e) != "ResourceInUse":
                    raise

    @staticmethod
    def validate_config(provider_config: Dict[str, Any]) -> None:
        return None
