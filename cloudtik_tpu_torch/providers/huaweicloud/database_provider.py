"""Huawei Cloud RDS database provider.

Reference parity: providers/_private/huaweicloud database management
(SURVEY.md §2.2).  rds_client is injectable with snake_case actions
(create_instance / list_instances / delete_instance).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from cloudtik_tpu_torch.core.database_provider import DatabaseProvider


def instance_name(workspace_name: str, database_name: str) -> str:
    return f"tik-{workspace_name}-{database_name}"


class HuaweiCloudDatabaseProvider(DatabaseProvider):
    """provider_config keys: region, vpc_id, subnet_id,
    security_group_id, rds_client (tests)."""

    def __init__(self, provider_config: Dict[str, Any],
                 workspace_name: str, database_name: str):
        super().__init__(provider_config, workspace_name, database_name)
        self.region = provider_config.get("region", "cn-north-4")
        self._client = provider_config.get("rds_client")

    @property
    def rds(self):
        if self._client is None:
            raise RuntimeError(
                "pass provider.rds_client (a huaweicloudsdkrds wrapper "
                "with snake_case actions) — no default client is built "
                "in this environment")
        return self._client

    @property
    def name(self) -> str:
        return instance_name(self.workspace_name, self.database_name)

    def _describe(self) -> Optional[Dict[str, Any]]:
        for inst in self.rds.list_instances(
                region=self.region).get("instances", []):
            if inst.get("name") == self.name:
                return inst
        return None

    def create(self, config: Dict[str, Any]) -> None:
        db = (config.get("database")
              or self.provider_config.get("database") or {})
        if self._describe() is not None:
            return
        self.rds.create_instance(
            name=self.name,
            region=self.region,
            datastore={"type": db.get("engine", "PostgreSQL"),
                       "version": str(db.get("version", "14"))},
            flavor_ref=db.get("flavor", "rds.pg.x1.xlarge.2"),
            volume={"type": "CLOUDSSD",
                    "size": int(db.get("storage_gb", 50))},
            vpc_id=self.provider_config.get("vpc_id", ""),
            subnet_id=self.provider_config.get("subnet_id", ""),
            security_group_id=self.provider_config.get(
                "security_group_id", ""),
            password=db.get("password", "Change-me-on-first-login1!"))
        self._wait_active(float(db.get("create_timeout_s", 1800)))

    def _wait_active(self, timeout_s: float) -> None:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            info = self._describe()
            if info and info.get("status") == "ACTIVE":
                return
            time.sleep(15.0)
        raise TimeoutError(
            f"RDS instance {self.name} not ACTIVE in {timeout_s}s")

    def delete(self, config: Dict[str, Any]) -> None:
        info = self._describe()
        if info is None:
            return
        self.rds.delete_instance(instance_id=info["id"])

    def get_info(self, config: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        info = self._describe()
        if info is None:
            return None
        endpoint = (info.get("private_ips") or [None])[0]
        return {"name": self.name,
                "engine": (info.get("datastore") or {}).get("type"),
                "state": info.get("status"),
                "host": endpoint,
                "port": int(info.get("port", 0)) or None,
                "managed": True}

    def validate_config(self, provider_config: Dict[str, Any]) -> None:
        return None
