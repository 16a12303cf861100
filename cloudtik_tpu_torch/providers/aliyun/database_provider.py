"""Aliyun ApsaraDB RDS database provider.

Reference parity: providers/_private/aliyun database management
(SURVEY.md §2.2).  rds_client is injectable with snake_case actions
(the ecs_client convention): create_db_instance / describe_db_instances
/ delete_db_instance.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from cloudtik_tpu_torch.core.database_provider import DatabaseProvider


def instance_description(workspace_name: str, database_name: str) -> str:
    return f"tik-{workspace_name}-{database_name}"


class AliyunDatabaseProvider(DatabaseProvider):
    """provider_config keys: region_id, vswitch_id, rds_client (tests)."""

    def __init__(self, provider_config: Dict[str, Any],
                 workspace_name: str, database_name: str):
        super().__init__(provider_config, workspace_name, database_name)
        self.region = provider_config.get("region_id", "cn-hangzhou")
        self._client = provider_config.get("rds_client")

    @property
    def rds(self):
        if self._client is None:
            raise RuntimeError(
                "pass provider.rds_client (an aliyun RDS wrapper with "
                "snake_case actions) — no default client is built in "
                "this environment")
        return self._client

    @property
    def description(self) -> str:
        return instance_description(self.workspace_name,
                                    self.database_name)

    def _describe(self) -> Optional[Dict[str, Any]]:
        instances = self.rds.describe_db_instances(
            region_id=self.region).get("Items", [])
        for inst in instances:
            if inst.get("DBInstanceDescription") == self.description:
                return inst
        return None

    def create(self, config: Dict[str, Any]) -> None:
        db = (config.get("database")
              or self.provider_config.get("database") or {})
        if self._describe() is not None:
            return
        self.rds.create_db_instance(
            region_id=self.region,
            engine=db.get("engine", "PostgreSQL"),
            engine_version=str(db.get("version", "14.0")),
            db_instance_class=db.get("instance_class",
                                     "pg.n4.4c.2m"),
            db_instance_storage=int(db.get("storage_gb", 50)),
            vswitch_id=self.provider_config.get("vswitch_id", ""),
            db_instance_description=self.description,
            pay_type="Postpaid")
        self._wait_running(float(db.get("create_timeout_s", 1800)))

    def _wait_running(self, timeout_s: float) -> None:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            info = self._describe()
            if info and info.get("DBInstanceStatus") == "Running":
                return
            time.sleep(15.0)
        raise TimeoutError(
            f"RDS instance {self.description} not Running "
            f"in {timeout_s}s")

    def delete(self, config: Dict[str, Any]) -> None:
        info = self._describe()
        if info is None:
            return
        self.rds.delete_db_instance(
            db_instance_id=info["DBInstanceId"])

    def get_info(self, config: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        info = self._describe()
        if info is None:
            return None
        return {"name": self.description,
                "engine": info.get("Engine"),
                "state": info.get("DBInstanceStatus"),
                "host": info.get("ConnectionString"),
                "port": int(info.get("Port", 0)) or None,
                "managed": True}

    def validate_config(self, provider_config: Dict[str, Any]) -> None:
        return None
