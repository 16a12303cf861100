"""Azure Database provider: PostgreSQL Flexible Server lifecycle.

Reference parity: providers/_private/_azure database management
(SURVEY.md §2.2).  Same injectable-client shape as the Azure node
provider: the `postgres_client` (azure-mgmt-rdbms
PostgreSQLManagementClient-compatible) is injectable for tests and
lazily imported in production.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from cloudtik_tpu_torch.core.database_provider import DatabaseProvider


def server_name(workspace_name: str, database_name: str) -> str:
    # flexible-server names: lowercase alphanumerics + hyphens
    return f"tik-{workspace_name}-{database_name}".lower()


class AzureDatabaseProvider(DatabaseProvider):
    """provider_config keys: subscription_id, resource_group, location,
    database (sku/version/storage overrides), postgres_client (tests)."""

    def __init__(self, provider_config: Dict[str, Any],
                 workspace_name: str, database_name: str):
        super().__init__(provider_config, workspace_name, database_name)
        self.resource_group = provider_config.get(
            "resource_group", f"tik-{workspace_name}")
        self.location = provider_config.get("location", "westus2")
        self._client = provider_config.get("postgres_client")

    @property
    def client(self):
        if self._client is None:
            from azure.identity import DefaultAzureCredential
            from azure.mgmt.rdbms.postgresql_flexibleservers import (
                PostgreSQLManagementClient)
            self._client = PostgreSQLManagementClient(
                DefaultAzureCredential(),
                self.provider_config["subscription_id"])
        return self._client

    @property
    def server(self) -> str:
        return server_name(self.workspace_name, self.database_name)

    def create(self, config: Dict[str, Any]) -> None:
        db = (config.get("database")
              or self.provider_config.get("database") or {})
        if self._describe() is not None:
            return
        poller = self.client.servers.begin_create(
            self.resource_group, self.server, {
                "location": self.location,
                "sku": {"name": db.get("sku", "Standard_D4s_v3"),
                        "tier": db.get("tier", "GeneralPurpose")},
                "properties": {
                    "version": str(db.get("version", "14")),
                    "administrator_login": db.get("username", "tik"),
                    "administrator_login_password": db.get(
                        "password", "change-me-on-first-login"),
                    "storage": {"storage_size_gb":
                                int(db.get("storage_gb", 64))},
                    "network": {"public_network_access":
                                "Enabled" if db.get("public_ip")
                                else "Disabled"},
                },
                "tags": {"tik-workspace": self.workspace_name,
                         "tik-managed": "true"},
            })
        poller.result(timeout=float(db.get("create_timeout_s", 1800)))
        self._wait_ready(float(db.get("create_timeout_s", 1800)))

    def _describe(self) -> Optional[Any]:
        try:
            return self.client.servers.get(self.resource_group,
                                           self.server)
        except Exception as e:
            if getattr(e, "status_code", None) == 404 \
                    or "ResourceNotFound" in str(e):
                return None
            raise

    def _wait_ready(self, timeout_s: float) -> None:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            info = self._describe()
            state = getattr(info, "state", None) if info else None
            if state == "Ready":
                return
            if state in ("Disabled", "Dropping"):
                raise RuntimeError(
                    f"flexible server {self.server} entered {state}")
            time.sleep(15.0)
        raise TimeoutError(
            f"flexible server {self.server} not Ready in {timeout_s}s")

    def delete(self, config: Dict[str, Any]) -> None:
        if self._describe() is None:
            return
        self.client.servers.begin_delete(
            self.resource_group, self.server).result()

    def get_info(self, config: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        info = self._describe()
        if info is None:
            return None
        return {"name": self.server,
                "engine": "postgres",
                "state": getattr(info, "state", None),
                "host": getattr(info, "fully_qualified_domain_name",
                                None),
                "port": 5432,
                "managed": True}

    def validate_config(self, provider_config: Dict[str, Any]) -> None:
        if not provider_config.get("subscription_id") \
                and not provider_config.get("postgres_client"):
            raise ValueError(
                "azure database provider requires subscription_id")
