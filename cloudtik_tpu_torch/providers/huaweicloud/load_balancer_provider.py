"""Huawei Cloud ELB (dedicated load balancer) provider.

Reference parity: providers/_private/huaweicloud load-balancer
management (SURVEY.md §2.2).  elb_client is injectable with snake_case
actions (create_load_balancer / list_load_balancers / create_listener /
create_pool / create_member / delete_member / delete_load_balancer).
"""

from __future__ import annotations

from typing import Any, Dict, List

from cloudtik_tpu_torch.core.load_balancer_provider import (
    LoadBalancerProvider, LoadBalancerScheme)


class HuaweiCloudLoadBalancerProvider(LoadBalancerProvider):
    """provider_config keys: region, subnet_id, elb_client (tests)."""

    def __init__(self, provider_config: Dict[str, Any],
                 workspace_name: str):
        super().__init__(provider_config, workspace_name)
        self.region = provider_config.get("region", "cn-north-4")
        self._client = provider_config.get("elb_client")

    @property
    def elb(self):
        if self._client is None:
            raise RuntimeError(
                "pass provider.elb_client (a huaweicloudsdkelb wrapper "
                "with snake_case actions) — no default client is built "
                "in this environment")
        return self._client

    def support_multi_service_group(self) -> bool:
        return False

    def _name(self, base: str) -> str:
        return f"tik-{self.workspace_name}-{base}"

    def list(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        prefix = f"tik-{self.workspace_name}-"
        for lb in self.elb.list_load_balancers(
                region=self.region).get("loadbalancers", []):
            name = lb.get("name", "")
            if not name.startswith(prefix):
                continue
            pools = lb.get("pools", [])
            port = None
            targets: List[Dict[str, Any]] = []
            for pool in pools:
                for m in self.elb.list_members(
                        pool_id=pool["id"]).get("members", []):
                    targets.append({"ip": m["address"],
                                    "port": m["protocol_port"]})
            listeners = lb.get("listeners", [])
            if listeners:
                port = listeners[0].get("protocol_port")
            out[name[len(prefix):]] = {
                "name": name[len(prefix):],
                "id": lb["id"],
                "pool_id": pools[0]["id"] if pools else None,
                "dns": lb.get("vip_address"),
                "scheme": LoadBalancerScheme.INTERNAL,
                "managed": True,
                "port": port,
                "targets": sorted(targets,
                                  key=lambda t: (t["ip"], t["port"])),
            }
        return out

    def create(self, load_balancer_config: Dict[str, Any]) -> None:
        name = load_balancer_config["name"]
        port = int(load_balancer_config["port"])
        lb = self.elb.create_load_balancer(
            region=self.region,
            name=self._name(name),
            vip_subnet_cidr_id=self.provider_config.get("subnet_id", ""))
        listener = self.elb.create_listener(
            loadbalancer_id=lb["id"], protocol="TCP",
            protocol_port=port)
        pool = self.elb.create_pool(
            listener_id=listener["id"], protocol="TCP",
            lb_algorithm="ROUND_ROBIN")
        for t in load_balancer_config.get("targets", []):
            self.elb.create_member(
                pool_id=pool["id"], address=t["ip"],
                protocol_port=int(t["port"]))

    def update(self, load_balancer: Dict[str, Any],
               load_balancer_config: Dict[str, Any]) -> None:
        pool_id = load_balancer.get("pool_id")
        if not pool_id:
            return
        want = {(t["ip"], int(t["port"]))
                for t in load_balancer_config.get("targets", [])}
        members = self.elb.list_members(pool_id=pool_id).get(
            "members", [])
        have = {(m["address"], m["protocol_port"]): m["id"]
                for m in members}
        for key in sorted(want - set(have)):
            self.elb.create_member(pool_id=pool_id, address=key[0],
                                   protocol_port=key[1])
        for key, member_id in sorted(have.items()):
            if key not in want:
                self.elb.delete_member(pool_id=pool_id,
                                       member_id=member_id)

    def delete(self, load_balancer: Dict[str, Any]) -> None:
        self.elb.delete_load_balancer(
            load_balancer_id=load_balancer["id"], cascade=True)

    @staticmethod
    def validate_config(provider_config: Dict[str, Any]) -> None:
        return None
