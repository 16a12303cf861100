"""RDS database provider: managed database lifecycle.

Reference parity: providers/_private/aws RDS management (SURVEY.md §2.2).
Injectable rds_client for tests, matching the node provider's pattern.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from cloudtik_tpu_torch.core.database_provider import DatabaseProvider
from cloudtik_tpu_torch.providers.aws.node_provider import _boto3


def instance_id(workspace_name: str, database_name: str) -> str:
    return f"tik-{workspace_name}-{database_name}"


def _code(e: Exception) -> str:
    return getattr(e, "response", {}).get("Error", {}).get("Code", "")


class RDSDatabaseProvider(DatabaseProvider):
    """provider_config keys: region, profile, database (engine/class
    overrides), rds_client (tests)."""

    def __init__(self, provider_config: Dict[str, Any],
                 workspace_name: str, database_name: str):
        super().__init__(provider_config, workspace_name, database_name)
        self.region = provider_config.get("region", "us-west-2")
        self._client = provider_config.get("rds_client")

    @property
    def rds(self):
        if self._client is None:
            boto3 = _boto3()
            session = boto3.session.Session(
                profile_name=self.provider_config.get("profile"),
                region_name=self.region)
            self._client = session.client("rds")
        return self._client

    @property
    def db_id(self) -> str:
        return instance_id(self.workspace_name, self.database_name)

    def create(self, config: Dict[str, Any]) -> None:
        db = (config.get("database")
              or self.provider_config.get("database") or {})
        try:
            self.rds.create_db_instance(
                DBInstanceIdentifier=self.db_id,
                Engine=db.get("engine", "postgres"),
                DBInstanceClass=db.get("instance_class", "db.m6g.large"),
                MasterUsername=db.get("username", "tik"),
                MasterUserPassword=db.get(
                    "password", "change-me-on-first-login"),
                AllocatedStorage=int(db.get("storage_gb", 50)),
                PubliclyAccessible=bool(db.get("public_ip", False)),
                Tags=[{"Key": "tik-workspace",
                       "Value": self.workspace_name},
                      {"Key": "tik-managed", "Value": "true"}])
        except Exception as e:
            if _code(e) != "DBInstanceAlreadyExists":
                raise
        self._wait_available(float(db.get("create_timeout_s", 1800)))

    def _describe(self) -> Optional[Dict[str, Any]]:
        try:
            resp = self.rds.describe_db_instances(
                DBInstanceIdentifier=self.db_id)
        except Exception as e:
            if _code(e) == "DBInstanceNotFound":
                return None
            raise
        instances = resp.get("DBInstances", [])
        return instances[0] if instances else None

    def _wait_available(self, timeout_s: float) -> None:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            info = self._describe()
            if info and info.get("DBInstanceStatus") == "available":
                return
            if info and info.get("DBInstanceStatus") == "failed":
                raise RuntimeError(f"RDS instance {self.db_id} failed")
            time.sleep(15.0)
        raise TimeoutError(
            f"RDS instance {self.db_id} not available after {timeout_s}s")

    def delete(self, config: Dict[str, Any]) -> None:
        try:
            self.rds.delete_db_instance(
                DBInstanceIdentifier=self.db_id,
                SkipFinalSnapshot=True,
                DeleteAutomatedBackups=True)
        except Exception as e:
            if _code(e) != "DBInstanceNotFound":
                raise

    def get_info(self, config: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        info = self._describe()
        if info is None:
            return None
        endpoint = info.get("Endpoint", {})
        return {"name": self.db_id,
                "engine": info.get("Engine"),
                "state": info.get("DBInstanceStatus"),
                "host": endpoint.get("Address"),
                "port": endpoint.get("Port"),
                "managed": True}

    def validate_config(self, provider_config: Dict[str, Any]) -> None:
        return None
