"""Azure Load Balancer provider (standard SKU, IP-based backend pool).

Reference parity: providers/_private/_azure load-balancer management
(SURVEY.md §2.2).  Same injectable-client shape as the other Azure
providers: `network_client` (azure-mgmt-network NetworkManagementClient
compatible) is injectable for tests; payloads are plain dicts (the SDK
accepts them) and reads go through `as_dict()` when the SDK hands back
model objects, so fakes can stay dict-shaped.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.core.load_balancer_provider import (
    LoadBalancerProvider, LoadBalancerScheme)


def _as_dict(obj) -> Dict[str, Any]:
    if isinstance(obj, dict):
        return obj
    return obj.as_dict()


class AzureLoadBalancerProvider(LoadBalancerProvider):
    """provider_config keys: subscription_id, resource_group, location,
    subnet_id (frontend for internal LBs), virtual_network_id,
    network_client (tests)."""

    def __init__(self, provider_config: Dict[str, Any],
                 workspace_name: str):
        super().__init__(provider_config, workspace_name)
        self.resource_group = provider_config.get(
            "resource_group", f"tik-{workspace_name}")
        self.location = provider_config.get("location", "westus2")
        self._client = provider_config.get("network_client")

    @property
    def network(self):
        if self._client is None:
            from azure.identity import DefaultAzureCredential
            from azure.mgmt.network import NetworkManagementClient
            self._client = NetworkManagementClient(
                DefaultAzureCredential(),
                self.provider_config["subscription_id"])
        return self._client

    def support_multi_service_group(self) -> bool:
        return False

    # -- listing -----------------------------------------------------------
    def list(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for lb in self.network.load_balancers.list(self.resource_group):
            d = _as_dict(lb)
            tags = d.get("tags") or {}
            if tags.get("tik-managed") != "true" \
                    or tags.get("tik-workspace") != self.workspace_name:
                continue
            rules = d.get("load_balancing_rules") or []
            pools = d.get("backend_address_pools") or []
            targets: List[Dict[str, Any]] = []
            port = rules[0].get("frontend_port") if rules else None
            backend_port = rules[0].get("backend_port") if rules else None
            for pool in pools:
                for addr in pool.get("load_balancer_backend_addresses",
                                     []):
                    ip = addr.get("ip_address") or (
                        addr.get("properties", {}).get("ip_address"))
                    if ip:
                        targets.append({"ip": ip, "port": backend_port})
            frontends = d.get("frontend_ip_configurations") or []
            private_ip = (frontends[0].get("private_ip_address")
                          if frontends else None)
            out[d["name"]] = {
                "name": d["name"],
                "id": d.get("id"),
                "dns": private_ip,
                "scheme": LoadBalancerScheme.INTERNAL,
                "managed": True,
                "port": port,
                "targets": sorted(targets,
                                  key=lambda t: (t["ip"],
                                                 t["port"] or 0)),
            }
        return out

    # -- create/update/delete ----------------------------------------------
    def _pool_addresses(self, targets) -> List[Dict[str, Any]]:
        vnet = self.provider_config.get("virtual_network_id", "")
        return [{
            "name": f"addr-{i}",
            "ip_address": t["ip"],
            "virtual_network": {"id": vnet} if vnet else None,
        } for i, t in enumerate(
            sorted(targets, key=lambda t: (t["ip"], t["port"])))]

    def create(self, load_balancer_config: Dict[str, Any]) -> None:
        name = load_balancer_config["name"]
        port = int(load_balancer_config["port"])
        lb_id = (f"/subscriptions/"
                 f"{self.provider_config.get('subscription_id', '')}"
                 f"/resourceGroups/{self.resource_group}/providers"
                 f"/Microsoft.Network/loadBalancers/{name}")
        frontend = {
            "name": "frontend",
            "subnet": {"id": self.provider_config.get("subnet_id", "")},
            "private_ip_allocation_method": "Dynamic",
        }
        params = {
            "location": self.location,
            "sku": {"name": "Standard"},
            "tags": {"tik-managed": "true",
                     "tik-workspace": self.workspace_name},
            "frontend_ip_configurations": [frontend],
            "backend_address_pools": [{
                "name": "backend",
                "load_balancer_backend_addresses": self._pool_addresses(
                    load_balancer_config.get("targets", [])),
            }],
            "probes": [{
                "name": "probe",
                "protocol": "Tcp",
                "port": port,
                "interval_in_seconds": 5,
                "number_of_probes": 2,
            }],
            "load_balancing_rules": [{
                "name": "rule",
                "protocol": "Tcp",
                "frontend_port": port,
                "backend_port": port,
                "frontend_ip_configuration": {
                    "id": f"{lb_id}/frontendIPConfigurations/frontend"},
                "backend_address_pool": {
                    "id": f"{lb_id}/backendAddressPools/backend"},
                "probe": {"id": f"{lb_id}/probes/probe"},
            }],
        }
        self.network.load_balancers.begin_create_or_update(
            self.resource_group, name, params).result()

    def update(self, load_balancer: Dict[str, Any],
               load_balancer_config: Dict[str, Any]) -> None:
        name = load_balancer["name"]
        current = None
        for lb in self.network.load_balancers.list(self.resource_group):
            d = _as_dict(lb)
            if d["name"] == name:
                current = d
                break
        if current is None:
            return
        pools = current.get("backend_address_pools") or [{"name":
                                                          "backend"}]
        pools[0]["load_balancer_backend_addresses"] = \
            self._pool_addresses(load_balancer_config.get("targets", []))
        current["backend_address_pools"] = pools
        self.network.load_balancers.begin_create_or_update(
            self.resource_group, name, current).result()

    def delete(self, load_balancer: Dict[str, Any]) -> None:
        self.network.load_balancers.begin_delete(
            self.resource_group, load_balancer["name"]).result()

    @staticmethod
    def validate_config(provider_config: Dict[str, Any]) -> None:
        if not provider_config.get("subscription_id") \
                and not provider_config.get("network_client"):
            raise ValueError(
                "azure load balancer provider requires subscription_id")
