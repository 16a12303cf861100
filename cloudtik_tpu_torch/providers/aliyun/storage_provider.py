"""Aliyun OSS storage provider: managed bucket lifecycle.

Reference parity: providers/_private/aliyun OSS management (SURVEY.md
§2.2 "ECS/OSS").  oss_client is injectable with snake_case methods
(the node provider's ecs_client convention).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from cloudtik_tpu_torch.core.storage_provider import StorageProvider


def bucket_name(workspace_name: str, storage_name: str) -> str:
    return f"tik-{workspace_name}-{storage_name}"


class OSSStorageProvider(StorageProvider):
    """provider_config keys: region, oss_client (injectable with
    put_bucket / get_bucket_info / delete_bucket / list_objects /
    delete_objects)."""

    def __init__(self, provider_config: Dict[str, Any],
                 workspace_name: str, storage_name: str):
        super().__init__(provider_config, workspace_name, storage_name)
        self.region = provider_config.get("region", "cn-hangzhou")
        self._client = provider_config.get("oss_client")

    @property
    def oss(self):
        if self._client is None:
            raise RuntimeError(
                "pass provider.oss_client (an oss2 wrapper with "
                "snake_case bucket actions) — no default client is "
                "built in this environment")
        return self._client

    @property
    def bucket(self) -> str:
        return bucket_name(self.workspace_name, self.storage_name)

    def create(self, config: Dict[str, Any]) -> None:
        if self.oss.get_bucket_info(bucket_name=self.bucket) is None:
            self.oss.put_bucket(bucket_name=self.bucket,
                                region=self.region)

    def delete(self, config: Dict[str, Any]) -> None:
        if self.oss.get_bucket_info(bucket_name=self.bucket) is None:
            return
        objects = self.oss.list_objects(bucket_name=self.bucket)
        if objects:
            self.oss.delete_objects(bucket_name=self.bucket,
                                    keys=objects)
        self.oss.delete_bucket(bucket_name=self.bucket)

    def get_info(self, config: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        info = self.oss.get_bucket_info(bucket_name=self.bucket)
        if info is None:
            return None
        return {"name": self.bucket,
                "uri": f"oss://{self.bucket}",
                "location": info.get("region", self.region),
                "managed": True}
