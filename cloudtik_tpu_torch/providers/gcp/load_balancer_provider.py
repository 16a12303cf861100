"""GCP load-balancer provider: regional passthrough NLB reconciliation.

Reference parity: providers/_private/gcp/load_balancer_config.py (2,006 LoC
driving forwarding rules / backend services / NEGs from discovered
services).  This build reconciles one LB as:

    hybrid NEG (NON_GCP_PRIVATE_IP_PORT endpoints = the discovered
    ip:port targets) -> regional backend service -> forwarding rule

The forwarding rule's description carries the managed-config JSON so
`list()` can reconstruct desired-state comparisons without tag lookups —
the same trick the reference plays with its CloudTik-managed labels.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.core.load_balancer_provider import (
    LoadBalancerProvider, LoadBalancerScheme)
from cloudtik_tpu_torch.providers.gcp.compute import COMPUTE_API
from cloudtik_tpu_torch.providers.gcp.rest import GCPApiError, RestClient

MANAGED_KEY = "tik-managed-lb"


class GCPLoadBalancerProvider(LoadBalancerProvider):
    """provider_config keys: project_id, region, availability_zone,
    _rest_client (tests)."""

    def __init__(self, provider_config: Dict[str, Any],
                 workspace_name: str):
        super().__init__(provider_config, workspace_name)
        self.project = provider_config["project_id"]
        self.region = (provider_config.get("region")
                       or provider_config.get("availability_zone", "")
                       .rsplit("-", 1)[0] or "us-central1")
        self.zone = provider_config.get(
            "availability_zone", f"{self.region}-a")
        self.rest: RestClient = (provider_config.get("_rest_client")
                                 or RestClient())
        # LB pieces attach to the workspace VPC (required by the API for
        # hybrid NEGs and INTERNAL scheme rules); overridable for shared-VPC
        # setups via provider.network / provider.subnetwork.
        from cloudtik_tpu_torch.providers.gcp.config import (
            _network_name, _subnet_name)
        self.network = provider_config.get("network") or (
            f"projects/{self.project}/global/networks/"
            f"{_network_name(workspace_name)}")
        self.subnetwork = provider_config.get("subnetwork") or (
            f"projects/{self.project}/regions/{self.region}/subnetworks/"
            f"{_subnet_name(workspace_name, True)}")

    def support_multi_service_group(self) -> bool:
        return False

    # -- urls --------------------------------------------------------------
    def _region_url(self, suffix: str) -> str:
        return (f"{COMPUTE_API}/projects/{self.project}/regions/"
                f"{self.region}{suffix}")

    def _zone_url(self, suffix: str) -> str:
        return (f"{COMPUTE_API}/projects/{self.project}/zones/"
                f"{self.zone}{suffix}")

    def _get(self, url: str) -> Optional[Dict[str, Any]]:
        try:
            return self.rest.get(url)
        except GCPApiError as e:
            if e.not_found:
                return None
            raise

    def _delete_quiet(self, url: str) -> None:
        try:
            self.rest.delete(url)
        except GCPApiError as e:
            if not e.not_found:
                raise

    # -- listing -----------------------------------------------------------
    def list(self) -> Dict[str, Dict[str, Any]]:
        resp = self._get(self._region_url("/forwardingRules")) or {}
        out: Dict[str, Dict[str, Any]] = {}
        for rule in resp.get("items", []):
            try:
                desc = json.loads(rule.get("description") or "{}")
            except ValueError:
                continue
            if MANAGED_KEY not in desc:
                continue
            info = dict(desc[MANAGED_KEY])
            info.setdefault("name", rule["name"])
            info["managed"] = True
            info["ip"] = rule.get("IPAddress")
            out[rule["name"]] = info
        return out

    # -- create/update/delete ---------------------------------------------
    def create(self, load_balancer_config: Dict[str, Any]) -> None:
        name = load_balancer_config["name"]
        port = int(load_balancer_config["port"])
        targets = list(load_balancer_config.get("targets", []))
        scheme = load_balancer_config.get(
            "scheme", LoadBalancerScheme.INTERNAL)
        internal = scheme != LoadBalancerScheme.INTERNET_FACING

        neg_url = self._zone_url(f"/networkEndpointGroups/{name}-neg")
        if self._get(neg_url) is None:
            self.rest.post(
                self._zone_url("/networkEndpointGroups"),
                {"name": f"{name}-neg",
                 "networkEndpointType": "NON_GCP_PRIVATE_IP_PORT",
                 "network": self.network,
                 "defaultPort": port})
        self._sync_endpoints(name, targets, [])

        hc_url = self._region_url(f"/healthChecks/{name}-hc")
        if self._get(hc_url) is None:
            self.rest.post(
                self._region_url("/healthChecks"),
                {"name": f"{name}-hc", "type": "TCP",
                 "tcpHealthCheck": {"port": port}})

        bs_url = self._region_url(f"/backendServices/{name}-bs")
        if self._get(bs_url) is None:
            self.rest.post(
                self._region_url("/backendServices"),
                {"name": f"{name}-bs",
                 "protocol": "TCP",
                 "loadBalancingScheme":
                     "INTERNAL" if internal else "EXTERNAL",
                 "network": self.network,
                 "healthChecks": [hc_url],
                 "backends": [{"group": neg_url}]})

        fr_url = self._region_url(f"/forwardingRules/{name}")
        if self._get(fr_url) is None:
            body: Dict[str, Any] = {
                 "name": name,
                 "IPProtocol": "TCP",
                 "ports": [str(port)],
                 "loadBalancingScheme":
                     "INTERNAL" if internal else "EXTERNAL",
                 "backendService": bs_url}
            if internal:  # INTERNAL rules must name network + subnetwork
                body["network"] = self.network
                body["subnetwork"] = self.subnetwork
            body["description"] = json.dumps({MANAGED_KEY: {
                "name": name, "port": port, "scheme": scheme,
                "protocol": load_balancer_config.get("protocol", "TCP"),
                "targets": targets}})
            self.rest.post(self._region_url("/forwardingRules"), body)

    def update(self, load_balancer: Dict[str, Any],
               load_balancer_config: Dict[str, Any]) -> None:
        name = load_balancer_config["name"]
        self._sync_endpoints(
            name, list(load_balancer_config.get("targets", [])),
            list(load_balancer.get("targets", [])))
        # refresh the managed-state record on the forwarding rule
        fr_url = self._region_url(f"/forwardingRules/{name}")
        rule = self._get(fr_url)
        if rule is not None:
            self.rest.patch(
                fr_url,
                {"description": json.dumps({MANAGED_KEY: {
                    "name": name,
                    "port": int(load_balancer_config["port"]),
                    "scheme": load_balancer_config.get(
                        "scheme", LoadBalancerScheme.INTERNAL),
                    "protocol": load_balancer_config.get(
                        "protocol", "TCP"),
                    "targets": list(
                        load_balancer_config.get("targets", []))}})})

    def delete(self, load_balancer: Dict[str, Any]) -> None:
        name = load_balancer["name"]
        # teardown order reverses the dependency chain
        self._delete_quiet(self._region_url(f"/forwardingRules/{name}"))
        self._delete_quiet(self._region_url(f"/backendServices/{name}-bs"))
        self._delete_quiet(self._region_url(f"/healthChecks/{name}-hc"))
        self._delete_quiet(
            self._zone_url(f"/networkEndpointGroups/{name}-neg"))

    # -- endpoint sync ------------------------------------------------------
    def _sync_endpoints(self, name: str,
                        desired: List[Dict[str, Any]],
                        current: List[Dict[str, Any]]) -> None:
        neg = self._zone_url(f"/networkEndpointGroups/{name}-neg")
        to_endpoint = lambda t: {"ipAddress": t["ip"],
                                 "port": int(t["port"])}
        want = [to_endpoint(t) for t in desired]
        have = [to_endpoint(t) for t in current]
        attach = [e for e in want if e not in have]
        detach = [e for e in have if e not in want]
        if attach:
            self.rest.post(f"{neg}/attachNetworkEndpoints",
                           {"networkEndpoints": attach})
        if detach:
            self.rest.post(f"{neg}/detachNetworkEndpoints",
                           {"networkEndpoints": detach})

    @staticmethod
    def validate_config(provider_config: Dict[str, Any]) -> None:
        if not provider_config.get("project_id"):
            raise ValueError(
                "gcp load balancer requires provider.project_id")
