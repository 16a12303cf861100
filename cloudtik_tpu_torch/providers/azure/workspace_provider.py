"""Azure workspace provider: resource group / VNet / subnets / NSG / identity.

Reference parity: providers/_private/_azure/workspace_provider.py (+ the
network/identity bootstrap in its config.py; SURVEY.md §2.2).  Resources
follow workspace_resource_names() from the node provider so node bootstrap
finds them by name.  Clients are injectable (resource_client /
network_client / msi_client) and the SDK import lazy — the pattern every
provider family here shares.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from cloudtik_tpu_torch.core.workspace_provider import Existence, WorkspaceProvider
from cloudtik_tpu_torch.providers.azure.node_provider import (
    workspace_resource_names)


def _azure_clients(provider_config: Dict[str, Any]):
    try:
        from azure.identity import DefaultAzureCredential
        from azure.mgmt.msi import ManagedServiceIdentityClient
        from azure.mgmt.network import NetworkManagementClient
        from azure.mgmt.resource import ResourceManagementClient
    except ImportError as e:
        raise RuntimeError(
            "Azure provider requires the azure SDK "
            "(not installed in this environment)") from e
    cred = DefaultAzureCredential()
    sub = provider_config["subscription_id"]
    return (ResourceManagementClient(cred, sub),
            NetworkManagementClient(cred, sub),
            ManagedServiceIdentityClient(cred, sub))


def _result(poller):
    """Azure mutations return LRO pollers; fakes may return plain dicts."""
    return poller.result() if hasattr(poller, "result") else poller


class AzureWorkspaceProvider(WorkspaceProvider):
    """provider_config keys: subscription_id, location, resource_client /
    network_client / msi_client (injectable)."""

    def __init__(self, provider_config: Dict[str, Any],
                 workspace_name: str):
        super().__init__(provider_config, workspace_name)
        self.location = provider_config.get("location", "eastus")
        self.names = workspace_resource_names(workspace_name)
        self._resource = provider_config.get("resource_client")
        self._network = provider_config.get("network_client")
        self._msi = provider_config.get("msi_client")

    def _clients(self):
        if self._resource is None or self._network is None:
            self._resource, self._network, self._msi = _azure_clients(
                self.provider_config)
        return self._resource, self._network, self._msi

    @staticmethod
    def _get(fn, *args) -> Optional[Any]:
        try:
            return fn(*args)
        except Exception:
            return None

    # -- lifecycle ---------------------------------------------------------
    def create_workspace(self, config: Dict[str, Any]) -> None:
        resource, network, msi = self._clients()
        rg = self.names["resource_group"]
        resource.resource_groups.create_or_update(
            rg, {"location": self.location,
                 "tags": {"tik-workspace": self.workspace_name}})
        _result(network.network_security_groups.begin_create_or_update(
            rg, self.names["nsg"], {
                "location": self.location,
                "security_rules": [
                    {"name": "tik-allow-ssh", "priority": 1000,
                     "access": "Allow", "direction": "Inbound",
                     "protocol": "Tcp",
                     "source_address_prefix": "*",
                     "source_port_range": "*",
                     "destination_address_prefix": "*",
                     "destination_port_range": "22"},
                    {"name": "tik-allow-internal", "priority": 1100,
                     "access": "Allow", "direction": "Inbound",
                     "protocol": "*",
                     "source_address_prefix": "10.20.0.0/16",
                     "source_port_range": "*",
                     "destination_address_prefix": "*",
                     "destination_port_range": "*"},
                ]}))
        _result(network.virtual_networks.begin_create_or_update(
            rg, self.names["vnet"], {
                "location": self.location,
                "address_space": {
                    "address_prefixes": ["10.20.0.0/16"]}}))
        for subnet, prefix in ((self.names["public_subnet"],
                                "10.20.0.0/22"),
                               (self.names["private_subnet"],
                                "10.20.8.0/21")):
            _result(network.subnets.begin_create_or_update(
                rg, self.names["vnet"], subnet,
                {"address_prefix": prefix}))
        if msi is not None:
            msi.user_assigned_identities.create_or_update(
                rg, self.names.get(
                    "identity", f"tik-{self.workspace_name}-identity"),
                {"location": self.location})

    def delete_workspace(self, config: Dict[str, Any],
                         delete_managed_storage: bool = False,
                         delete_managed_database: bool = False) -> None:
        resource, _network, _msi = self._clients()
        # one LRO deletes the whole resource group (and everything in it)
        poller = self._get(resource.resource_groups.begin_delete,
                           self.names["resource_group"])
        if poller is not None:
            _result(poller)

    def update_workspace(self, config: Dict[str, Any], **kwargs) -> None:
        self.create_workspace(config)

    def check_workspace_existence(self, config: Dict[str, Any]) -> Existence:
        resource, network, _msi = self._clients()
        rg = self.names["resource_group"]
        pieces = [
            self._get(resource.resource_groups.get, rg),
            self._get(network.virtual_networks.get, rg,
                      self.names["vnet"]),
            self._get(network.subnets.get, rg, self.names["vnet"],
                      self.names["private_subnet"]),
        ]
        present = sum(1 for p in pieces if p is not None)
        if present == 0:
            return Existence.NOT_EXIST
        if present == len(pieces):
            return Existence.COMPLETED
        return Existence.IN_COMPLETED
