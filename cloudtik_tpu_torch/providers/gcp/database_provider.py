"""Cloud SQL database provider: managed database lifecycle.

Reference parity: providers/_private/gcp/database_provider.py (Cloud SQL
create/delete/describe wired into workspace managed-database options,
SURVEY.md §2.2/§3.5).  The metastore/mlflow runtimes discover these
instances through the cluster config's database endpoints.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from cloudtik_tpu_torch.core.database_provider import DatabaseProvider
from cloudtik_tpu_torch.providers.gcp.rest import GCPApiError, RestClient

SQLADMIN_API = "https://sqladmin.googleapis.com/v1"


def instance_name(workspace_name: str, database_name: str) -> str:
    return f"tik-{workspace_name}-{database_name}"


class CloudSQLDatabaseProvider(DatabaseProvider):
    """provider_config keys: project_id, region, database (engine/tier
    overrides), _rest_client (tests)."""

    def __init__(self, provider_config: Dict[str, Any],
                 workspace_name: str, database_name: str):
        super().__init__(provider_config, workspace_name, database_name)
        self.project = provider_config["project_id"]
        self.region = provider_config.get("region") or "us-central1"
        self.rest: RestClient = (provider_config.get("_rest_client")
                                 or RestClient())

    @property
    def instance(self) -> str:
        return instance_name(self.workspace_name, self.database_name)

    def _instances_url(self) -> str:
        return f"{SQLADMIN_API}/projects/{self.project}/instances"

    def _instance_url(self) -> str:
        return f"{self._instances_url()}/{self.instance}"

    def create(self, config: Dict[str, Any]) -> None:
        db = (config.get("database") or
              self.provider_config.get("database") or {})
        public_ip = bool(db.get("public_ip", False))
        ip_config: Dict[str, Any] = {"ipv4Enabled": public_ip}
        if not public_ip:
            # Private-IP only: attach to the workspace VPC so TPU hosts and
            # head reach it over internal addresses (the API requires a
            # privateNetwork when ipv4 is disabled).
            from cloudtik_tpu_torch.providers.gcp.config import _network_name
            network = db.get("network") or (
                f"projects/{self.project}/global/networks/"
                f"{_network_name(self.workspace_name)}")
            ip_config["privateNetwork"] = network
        body = {
            "name": self.instance,
            "region": self.region,
            "databaseVersion": db.get("engine", "POSTGRES_15"),
            "settings": {
                "tier": db.get("tier", "db-custom-2-8192"),
                "userLabels": {"tik-workspace": self.workspace_name,
                               "tik-managed": "true"},
                "ipConfiguration": ip_config,
            },
        }
        try:
            self.rest.post(self._instances_url(), body)
        except GCPApiError as e:
            if not e.conflict:
                raise
        self._wait_runnable(float(db.get("create_timeout_s", 1200)))

    def _wait_runnable(self, timeout_s: float) -> None:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            info = self._get()
            if info and info.get("state") == "RUNNABLE":
                return
            if info and info.get("state") == "FAILED":
                raise RuntimeError(
                    f"Cloud SQL instance {self.instance} FAILED")
            time.sleep(10.0)
        raise TimeoutError(
            f"Cloud SQL instance {self.instance} not RUNNABLE "
            f"after {timeout_s}s")

    def _get(self) -> Optional[Dict[str, Any]]:
        try:
            return self.rest.get(self._instance_url())
        except GCPApiError as e:
            if e.not_found:
                return None
            raise

    def delete(self, config: Dict[str, Any]) -> None:
        try:
            self.rest.delete(self._instance_url())
        except GCPApiError as e:
            if not e.not_found:
                raise

    def get_info(self, config: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        info = self._get()
        if info is None:
            return None
        addresses = {a.get("type"): a.get("ipAddress")
                     for a in info.get("ipAddresses", [])}
        return {
            "name": self.instance,
            "engine": info.get("databaseVersion"),
            "state": info.get("state"),
            "host": addresses.get("PRIVATE") or addresses.get("PRIMARY"),
            "port": 5432 if "POSTGRES" in str(
                info.get("databaseVersion")) else 3306,
            "managed": info.get("settings", {}).get(
                "userLabels", {}).get("tik-managed") == "true",
        }

    def validate_config(self, provider_config: Dict[str, Any]) -> None:
        if not provider_config.get("project_id"):
            raise ValueError("gcp database requires provider.project_id")
