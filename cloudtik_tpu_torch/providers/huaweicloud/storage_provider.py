"""Huawei OBS storage provider: managed bucket lifecycle.

Reference parity: providers/_private/huaweicloud OBS management
(SURVEY.md §2.2 "ECS/OBS").  obs_client is injectable with snake_case
methods (the node provider's ecs_client convention).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from cloudtik_tpu_torch.core.storage_provider import StorageProvider


def bucket_name(workspace_name: str, storage_name: str) -> str:
    return f"tik-{workspace_name}-{storage_name}"


class OBSStorageProvider(StorageProvider):
    """provider_config keys: region, obs_client (injectable with
    create_bucket / head_bucket / delete_bucket / list_objects /
    delete_objects)."""

    def __init__(self, provider_config: Dict[str, Any],
                 workspace_name: str, storage_name: str):
        super().__init__(provider_config, workspace_name, storage_name)
        self.region = provider_config.get("region", "cn-north-4")
        self._client = provider_config.get("obs_client")

    @property
    def obs(self):
        if self._client is None:
            raise RuntimeError(
                "pass provider.obs_client (an esdk-obs wrapper with "
                "snake_case bucket actions) — no default client is "
                "built in this environment")
        return self._client

    @property
    def bucket(self) -> str:
        return bucket_name(self.workspace_name, self.storage_name)

    def create(self, config: Dict[str, Any]) -> None:
        if not self.obs.head_bucket(bucket_name=self.bucket):
            self.obs.create_bucket(bucket_name=self.bucket,
                                   location=self.region)

    def delete(self, config: Dict[str, Any]) -> None:
        if not self.obs.head_bucket(bucket_name=self.bucket):
            return
        objects = self.obs.list_objects(bucket_name=self.bucket)
        if objects:
            self.obs.delete_objects(bucket_name=self.bucket,
                                    keys=objects)
        self.obs.delete_bucket(bucket_name=self.bucket)

    def get_info(self, config: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        if not self.obs.head_bucket(bucket_name=self.bucket):
            return None
        return {"name": self.bucket,
                "uri": f"obs://{self.bucket}",
                "location": self.region,
                "managed": True}
