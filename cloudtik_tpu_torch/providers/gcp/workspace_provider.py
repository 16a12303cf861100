"""GCP workspace provider: VPC / subnets / NAT / firewall / IAM fabric.

Reference parity: providers/_private/gcp/workspace_provider.py:18 +
config.py network/IAM creation (§3.5 call stack: VPC → public head subnet +
private worker subnet → Cloud Router/NAT → firewall → service accounts with
TPU roles).  TPU-first notes: the private subnet carries the TPU pod slices
(TPU v2 API attaches slices by network/subnet name), so it is sized large
and NAT-routed for package installs without external IPs.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from cloudtik_tpu_torch.core.workspace_provider import Existence, WorkspaceProvider
from cloudtik_tpu_torch.providers.gcp.compute import COMPUTE_API
from cloudtik_tpu_torch.providers.gcp.rest import GCPApiError, RestClient
from cloudtik_tpu_torch.providers.gcp.config import (
    HEAD_SERVICE_ACCOUNT_ROLES, _network_name, _subnet_name)


class GCPWorkspaceProvider(WorkspaceProvider):
    def __init__(self, provider_config: Dict[str, Any], workspace_name: str):
        super().__init__(provider_config, workspace_name)
        self.project = provider_config["project_id"]
        self.region = provider_config.get("region") or \
            (provider_config.get("availability_zone", "")
             .rsplit("-", 1)[0]) or "us-central1"
        self.rest: RestClient = (provider_config.get("_rest_client")
                                 or RestClient())

    # -- urls ----------------------------------------------------------------
    def _global_url(self, suffix: str) -> str:
        return f"{COMPUTE_API}/projects/{self.project}/global{suffix}"

    def _region_url(self, suffix: str) -> str:
        return (f"{COMPUTE_API}/projects/{self.project}/regions/"
                f"{self.region}{suffix}")

    # -- pieces --------------------------------------------------------------
    @property
    def _vpc(self) -> str:
        return _network_name(self.workspace_name)

    def _get(self, url: str) -> Optional[Dict[str, Any]]:
        try:
            return self.rest.get(url)
        except GCPApiError as e:
            if e.not_found:
                return None
            raise

    def _wait_op(self, op: Any, timeout: float = 300.0) -> None:
        """Poll a compute Operation until DONE (mutations are async)."""
        if not isinstance(op, dict) or op.get("status") == "DONE" \
                or "selfLink" not in op:
            return
        deadline = time.time() + timeout
        url = op["selfLink"]
        while time.time() < deadline:
            current = self._get(url)
            if current is None or current.get("status") == "DONE":
                err = (current or {}).get("error")
                if err:
                    raise RuntimeError(f"GCP operation failed: {err}")
                return
            time.sleep(2.0)
        raise TimeoutError(f"GCP operation not DONE after {timeout}s: {url}")

    def _mutate(self, fn, *args, retries: int = 5) -> None:
        """Run a mutation, waiting out dependency ordering: a freshly
        created network isn't usable by subnet inserts for a few seconds
        (400 resourceNotReady), and deletes race in-flight dependents
        (400 resourceInUse)."""
        for attempt in range(retries + 1):
            try:
                self._wait_op(fn(*args))
                return
            except GCPApiError as e:
                if e.conflict:
                    return
                retriable = e.status == 400 and any(
                    s in str(e.body) for s in
                    ("resourceNotReady", "resourceInUse",
                     "is not ready", "in use"))
                if not retriable or attempt == retries:
                    raise
                time.sleep(3.0 * (attempt + 1))

    def _ensure(self, get_url: str, create_url: str,
                body: Dict[str, Any]) -> None:
        if self._get(get_url) is None:
            self._mutate(self.rest.post, create_url, body)

    # -- lifecycle -----------------------------------------------------------
    def create_workspace(self, config: Dict[str, Any]) -> None:
        vpc = self._vpc
        self._ensure(
            self._global_url(f"/networks/{vpc}"),
            self._global_url("/networks"),
            {"name": vpc, "autoCreateSubnetworks": False})
        net_link = f"projects/{self.project}/global/networks/{vpc}"
        self._ensure(
            self._region_url(
                f"/subnetworks/{_subnet_name(self.workspace_name, False)}"),
            self._region_url("/subnetworks"),
            {"name": _subnet_name(self.workspace_name, False),
             "network": net_link, "ipCidrRange": "10.10.0.0/22"})
        self._ensure(
            self._region_url(
                f"/subnetworks/{_subnet_name(self.workspace_name, True)}"),
            self._region_url("/subnetworks"),
            {"name": _subnet_name(self.workspace_name, True),
             "network": net_link, "ipCidrRange": "10.10.8.0/21",
             "privateIpGoogleAccess": True})
        router = f"tik-{self.workspace_name}-router"
        self._ensure(
            self._region_url(f"/routers/{router}"),
            self._region_url("/routers"),
            {"name": router, "network": net_link,
             "nats": [{
                 "name": f"tik-{self.workspace_name}-nat",
                 "natIpAllocateOption": "AUTO_ONLY",
                 "sourceSubnetworkIpRangesToNat":
                     "ALL_SUBNETWORKS_ALL_IP_RANGES",
             }]})
        # Firewall: SSH from anywhere to head subnet; all-internal traffic
        # (ICI bootstrap + control plane + service fabric) inside the VPC.
        self._ensure(
            self._global_url(
                f"/firewalls/tik-{self.workspace_name}-allow-ssh"),
            self._global_url("/firewalls"),
            {"name": f"tik-{self.workspace_name}-allow-ssh",
             "network": net_link,
             "allowed": [{"IPProtocol": "tcp", "ports": ["22"]}],
             "sourceRanges": ["0.0.0.0/0"]})
        self._ensure(
            self._global_url(
                f"/firewalls/tik-{self.workspace_name}-allow-internal"),
            self._global_url("/firewalls"),
            {"name": f"tik-{self.workspace_name}-allow-internal",
             "network": net_link,
             "allowed": [{"IPProtocol": "tcp"}, {"IPProtocol": "udp"},
                         {"IPProtocol": "icmp"}],
             "sourceRanges": ["10.10.0.0/16"]})

    def delete_workspace(self, config: Dict[str, Any],
                         delete_managed_storage: bool = False,
                         delete_managed_database: bool = False) -> None:
        def _delete(url: str) -> None:
            try:
                self._mutate(self.rest.delete, url)
            except GCPApiError as e:
                if not e.not_found:
                    raise

        for fw in ("allow-ssh", "allow-internal"):
            _delete(self._global_url(
                f"/firewalls/tik-{self.workspace_name}-{fw}"))
        _delete(self._region_url(
            f"/routers/tik-{self.workspace_name}-router"))
        for private in (True, False):
            _delete(self._region_url(
                f"/subnetworks/{_subnet_name(self.workspace_name, private)}"))
        _delete(self._global_url(f"/networks/{self._vpc}"))

    def update_workspace(self, config: Dict[str, Any], **kwargs) -> None:
        self.create_workspace(config)

    def check_workspace_existence(self, config: Dict[str, Any]) -> Existence:
        pieces = [
            self._get(self._global_url(f"/networks/{self._vpc}")),
            self._get(self._region_url(
                f"/subnetworks/{_subnet_name(self.workspace_name, False)}")),
            self._get(self._region_url(
                f"/subnetworks/{_subnet_name(self.workspace_name, True)}")),
        ]
        present = sum(1 for p in pieces if p is not None)
        if present == 0:
            return Existence.NOT_EXIST
        if present == len(pieces):
            return Existence.COMPLETED
        return Existence.IN_COMPLETED
