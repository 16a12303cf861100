"""Azure node provider: VMs via the Azure SDK (ARM deployment shape).

Reference parity: providers/_private/_azure (SURVEY.md §2.2 — 7,217 LoC,
ARM template azure-vm-template.json, managed identity adapter).  Payload
builders are pure; the compute/network clients are injectable and the SDK
import is lazy.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.core.node_provider import (
    NodeLaunchException, NodeProvider)

TAG_PREFIX = "tik-"


def build_vm_parameters(node_config: Dict[str, Any], tags: Dict[str, str],
                        vm_name: str, location: str,
                        nic_id: str) -> Dict[str, Any]:
    """node_config -> azure VirtualMachine create parameters dict."""
    image = node_config.get("image", {
        "publisher": "Canonical", "offer": "0001-com-ubuntu-server-jammy",
        "sku": "22_04-lts-gen2", "version": "latest"})
    params: Dict[str, Any] = {
        "location": location,
        "tags": dict(tags),
        "hardware_profile": {
            "vm_size": node_config.get("vm_size", "Standard_D4s_v5")},
        "storage_profile": {
            "image_reference": image,
            "os_disk": {
                "create_option": "FromImage",
                "disk_size_gb": node_config.get("disk_size_gb", 100),
                "managed_disk": {"storage_account_type":
                                 node_config.get("disk_type",
                                                 "Premium_LRS")}}},
        "os_profile": {
            "computer_name": vm_name,
            "admin_username": node_config.get("admin_username", "tik"),
            "linux_configuration": {
                "disable_password_authentication": True,
                "ssh": {"public_keys": [{
                    "path": f"/home/"
                            f"{node_config.get('admin_username', 'tik')}"
                            f"/.ssh/authorized_keys",
                    "key_data": node_config.get("ssh_public_key", "")}]},
            }},
        "network_profile": {"network_interfaces": [{"id": nic_id}]},
    }
    if node_config.get("spot"):
        params["priority"] = "Spot"
        params["eviction_policy"] = "Deallocate"
    if node_config.get("managed_identity_id"):
        params["identity"] = {
            "type": "UserAssigned",
            "user_assigned_identities": {
                node_config["managed_identity_id"]: {}}}
    return params


def workspace_resource_names(workspace: str) -> Dict[str, str]:
    return {
        "resource_group": f"tik-{workspace}-rg",
        "vnet": f"tik-{workspace}-vnet",
        "public_subnet": f"tik-{workspace}-public",
        "private_subnet": f"tik-{workspace}-private",
        "nsg": f"tik-{workspace}-nsg",
        "nat": f"tik-{workspace}-nat",
        "identity": f"tik-{workspace}-identity",
        "storage_account": f"tik{workspace}data".replace("-", "")[:24],
    }


class AzureNodeProvider(NodeProvider):
    """provider_config keys: subscription_id, resource_group, location,
    compute_client / network_client (injectable)."""

    def __init__(self, provider_config: Dict[str, Any], cluster_name: str):
        super().__init__(provider_config, cluster_name)
        self.resource_group = provider_config.get("resource_group", "")
        self.location = provider_config.get("location", "eastus")
        self._compute = provider_config.get("compute_client")
        self._network = provider_config.get("network_client")
        self._lock = threading.RLock()

    @property
    def compute(self):
        if self._compute is None:
            try:
                from azure.identity import DefaultAzureCredential
                from azure.mgmt.compute import ComputeManagementClient
            except ImportError as e:
                raise RuntimeError(
                    "azure provider requires the azure SDK (not "
                    "installed in this environment)") from e
            self._compute = ComputeManagementClient(
                DefaultAzureCredential(),
                self.provider_config["subscription_id"])
        return self._compute

    def _vms(self) -> List[Any]:
        return [vm for vm in
                self.compute.virtual_machines.list(self.resource_group)
                if (getattr(vm, "tags", None) or {}).get(
                    "tik-cluster-name") == self.cluster_name]

    def _vm(self, node_id: str):
        try:
            return self.compute.virtual_machines.get(
                self.resource_group, node_id, expand="instanceView")
        except Exception as e:
            # Only a definitive 404 means the VM is gone; transient ARM
            # errors (throttle, auth) must NOT read as "terminated".
            status = getattr(e, "status_code", None)
            if status == 404 or "NotFound" in type(e).__name__ \
                    or "ResourceNotFound" in str(e):
                return None
            raise

    # -- queries -----------------------------------------------------------
    def non_terminated_nodes(self, tag_filters):
        out = []
        for vm in self._vms():
            tags = getattr(vm, "tags", None) or {}
            if all(tags.get(k) == v for k, v in tag_filters.items()):
                out.append(vm.name)
        return sorted(out)

    def is_running(self, node_id):
        vm = self._vm(node_id)
        if vm is None:
            return False
        statuses = getattr(getattr(vm, "instance_view", None),
                           "statuses", []) or []
        return any(getattr(s, "code", "") == "PowerState/running"
                   for s in statuses)

    def is_terminated(self, node_id):
        return self._vm(node_id) is None

    def node_tags(self, node_id):
        vm = self._vm(node_id)
        return dict(getattr(vm, "tags", None) or {}) if vm else {}

    @property
    def network(self):
        if self._network is None:
            try:
                from azure.identity import DefaultAzureCredential
                from azure.mgmt.network import NetworkManagementClient
            except ImportError as e:
                raise RuntimeError(
                    "azure provider requires the azure SDK (not "
                    "installed in this environment)") from e
            self._network = NetworkManagementClient(
                DefaultAzureCredential(),
                self.provider_config["subscription_id"])
        return self._network

    def _nic_of(self, vm):
        profile = getattr(vm, "network_profile", None)
        nics = getattr(profile, "network_interfaces", None) or []
        if not nics:
            return None
        nic_id = getattr(nics[0], "id", "") or ""
        nic_name = nic_id.rsplit("/", 1)[-1]
        if not nic_name:
            return None
        return self.network.network_interfaces.get(
            self.resource_group, nic_name)

    def internal_ip(self, node_id):
        vm = self._vm(node_id)
        if vm is None:
            return None
        nic = self._nic_of(vm)
        for ip_cfg in (getattr(nic, "ip_configurations", None) or []):
            addr = getattr(ip_cfg, "private_ip_address", None)
            if addr:
                return addr
        return (getattr(vm, "tags", None) or {}).get("tik-internal-ip")

    def external_ip(self, node_id):
        vm = self._vm(node_id)
        if vm is None:
            return None
        nic = self._nic_of(vm)
        for ip_cfg in (getattr(nic, "ip_configurations", None) or []):
            pub = getattr(ip_cfg, "public_ip_address", None)
            addr = getattr(pub, "ip_address", None)
            if addr:
                return addr
        return None

    # -- mutation ----------------------------------------------------------
    def _subnet_id(self, node_config) -> str:
        """Deterministic ARM resource path for the node's subnet (the
        workspace-provider naming scheme; overridable per node)."""
        names = workspace_resource_names(
            self.provider_config.get("workspace_name", "default"))
        sub = self.provider_config.get("subscription_id", "")
        vnet = node_config.get("vnet", names["vnet"])
        subnet = node_config.get("subnet", names["private_subnet"])
        return (f"/subscriptions/{sub}/resourceGroups/"
                f"{self.resource_group}/providers/Microsoft.Network/"
                f"virtualNetworks/{vnet}/subnets/{subnet}")

    def _ensure_nic(self, vm_name: str, node_config) -> str:
        """Create the VM's NIC in the workspace subnet; returns its id."""
        poller = self.network.network_interfaces.begin_create_or_update(
            self.resource_group, f"{vm_name}-nic",
            {"location": self.location,
             "ip_configurations": [{
                 "name": "primary",
                 "subnet": {"id": self._subnet_id(node_config)}}]})
        nic = poller.result() if hasattr(poller, "result") else poller
        nic_id = getattr(nic, "id", None)
        if nic_id is None and isinstance(nic, dict):
            nic_id = nic.get("id")
        return nic_id or (f"{self._subnet_id(node_config)}"
                          f"/../networkInterfaces/{vm_name}-nic")

    def create_node(self, node_config, tags, count):
        created = {}
        for _ in range(count):
            # uuid suffix: unique across processes/restarts (ARM
            # create_or_update has upsert semantics, so name reuse would
            # silently redeploy an existing VM instead of adding one)
            vm_name = (f"tik-{self.cluster_name}-"
                       f"{tags.get('tik-node-kind', 'node')}-"
                       f"{uuid.uuid4().hex[:8]}")
            nic_id = node_config.get("nic_id") or \
                self._ensure_nic(vm_name, node_config)
            params = build_vm_parameters(
                node_config, dict(tags,
                                  **{"tik-cluster-name":
                                     self.cluster_name}),
                vm_name, self.location, nic_id)
            try:
                self.compute.virtual_machines.begin_create_or_update(
                    self.resource_group, vm_name, params)
            except Exception as e:
                raise NodeLaunchException("api", str(e))
            created[vm_name] = params
        return created

    def set_node_tags(self, node_id, tags):
        vm = self._vm(node_id)
        if vm is None:
            return
        merged = dict(getattr(vm, "tags", None) or {})
        merged.update(tags)
        self.compute.virtual_machines.begin_update(
            self.resource_group, node_id, {"tags": merged})

    def terminate_node(self, node_id):
        try:
            self.compute.virtual_machines.begin_delete(
                self.resource_group, node_id)
        except Exception:
            return None
        return {node_id: "deleting"}

    @staticmethod
    def validate_config(provider_config: Dict[str, Any]) -> None:
        if not provider_config.get("compute_client") and \
                not provider_config.get("subscription_id"):
            raise ValueError("azure provider requires subscription_id")

    @staticmethod
    def bootstrap_config(cluster_config: Dict[str, Any]) -> Dict[str, Any]:
        """Fill workspace-derived network defaults: resource group, and
        per-node-type vnet/subnet (head on the public subnet, workers on
        the private one) — reference parity with the _azure config.py
        bootstrap."""
        provider = cluster_config.setdefault("provider", {})
        workspace = cluster_config.get("workspace_name", "default")
        names = workspace_resource_names(workspace)
        provider.setdefault("workspace_name", workspace)
        provider.setdefault("resource_group", names["resource_group"])
        head_type = cluster_config.get("head_node_type")
        for type_name, node_type in cluster_config.get(
                "available_node_types", {}).items():
            node_config = node_type.setdefault("node_config", {})
            node_config.setdefault("vnet", names["vnet"])
            node_config.setdefault(
                "subnet",
                names["public_subnet"] if type_name == head_type
                else names["private_subnet"])
        return cluster_config
