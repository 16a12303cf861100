"""Aliyun SLB (Classic Load Balancer) provider.

Reference parity: providers/_private/aliyun load-balancer management
(SURVEY.md §2.2).  slb_client is injectable with snake_case actions
(create_load_balancer / describe_load_balancers /
create_load_balancer_tcp_listener / add_backend_servers /
remove_backend_servers / delete_load_balancer), matching the
ecs_client convention.
"""

from __future__ import annotations

from typing import Any, Dict, List

from cloudtik_tpu_torch.core.load_balancer_provider import (
    LoadBalancerProvider, LoadBalancerScheme)


class AliyunLoadBalancerProvider(LoadBalancerProvider):
    """provider_config keys: region_id, vswitch_id, slb_client (tests)."""

    def __init__(self, provider_config: Dict[str, Any],
                 workspace_name: str):
        super().__init__(provider_config, workspace_name)
        self.region = provider_config.get("region_id", "cn-hangzhou")
        self._client = provider_config.get("slb_client")

    @property
    def slb(self):
        if self._client is None:
            raise RuntimeError(
                "pass provider.slb_client (an aliyun SLB wrapper with "
                "snake_case actions) — no default client is built in "
                "this environment")
        return self._client

    def support_multi_service_group(self) -> bool:
        return False

    def _name(self, base: str) -> str:
        return f"tik-{self.workspace_name}-{base}"

    def list(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        prefix = f"tik-{self.workspace_name}-"
        for lb in self.slb.describe_load_balancers(
                region_id=self.region).get("LoadBalancers", []):
            name = lb.get("LoadBalancerName", "")
            if not name.startswith(prefix):
                continue
            detail = self.slb.describe_load_balancer_attribute(
                load_balancer_id=lb["LoadBalancerId"])
            listeners = detail.get("ListenerPorts", [])
            targets = sorted(
                ({"ip": b.get("ServerIp") or b["ServerId"],
                  "port": b.get("Port", listeners[0] if listeners
                                else 0)}
                 for b in detail.get("BackendServers", [])),
                key=lambda t: (t["ip"], t["port"]))
            out[name[len(prefix):]] = {
                "name": name[len(prefix):],
                "id": lb["LoadBalancerId"],
                "dns": lb.get("Address"),
                "scheme": (LoadBalancerScheme.INTERNET_FACING
                           if lb.get("AddressType") == "internet"
                           else LoadBalancerScheme.INTERNAL),
                "managed": True,
                "port": listeners[0] if listeners else None,
                "targets": targets,
            }
        return out

    def create(self, load_balancer_config: Dict[str, Any]) -> None:
        name = load_balancer_config["name"]
        port = int(load_balancer_config["port"])
        scheme = load_balancer_config.get(
            "scheme", LoadBalancerScheme.INTERNAL)
        resp = self.slb.create_load_balancer(
            region_id=self.region,
            load_balancer_name=self._name(name),
            address_type=("internet"
                          if scheme == LoadBalancerScheme.INTERNET_FACING
                          else "intranet"),
            vswitch_id=self.provider_config.get("vswitch_id", ""))
        lb_id = resp["LoadBalancerId"]
        self.slb.create_load_balancer_tcp_listener(
            load_balancer_id=lb_id, listener_port=port,
            backend_server_port=port, bandwidth=-1)
        servers = [{"ServerIp": t["ip"], "Port": int(t["port"]),
                    "Type": "eni"}
                   for t in load_balancer_config.get("targets", [])]
        if servers:
            self.slb.add_backend_servers(
                load_balancer_id=lb_id, backend_servers=servers)

    def update(self, load_balancer: Dict[str, Any],
               load_balancer_config: Dict[str, Any]) -> None:
        lb_id = load_balancer["id"]
        want = {(t["ip"], int(t["port"]))
                for t in load_balancer_config.get("targets", [])}
        have = {(t["ip"], int(t["port"]))
                for t in load_balancer.get("targets", [])}
        add = [{"ServerIp": ip, "Port": p, "Type": "eni"}
               for ip, p in sorted(want - have)]
        remove = [{"ServerIp": ip, "Port": p}
                  for ip, p in sorted(have - want)]
        if add:
            self.slb.add_backend_servers(
                load_balancer_id=lb_id, backend_servers=add)
        if remove:
            self.slb.remove_backend_servers(
                load_balancer_id=lb_id, backend_servers=remove)

    def delete(self, load_balancer: Dict[str, Any]) -> None:
        self.slb.delete_load_balancer(
            load_balancer_id=load_balancer["id"])

    @staticmethod
    def validate_config(provider_config: Dict[str, Any]) -> None:
        return None
