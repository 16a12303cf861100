"""Azure Blob storage provider: managed container lifecycle.

Reference parity: the _azure provider's managed Blob/Datalake storage
(SURVEY.md §2.2).  blob_service_client is injectable (an
azure.storage.blob BlobServiceClient-compatible surface).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from cloudtik_tpu_torch.core.storage_provider import StorageProvider
from cloudtik_tpu_torch.providers.azure.node_provider import (
    workspace_resource_names)


def container_name(workspace_name: str, storage_name: str) -> str:
    return f"tik-{workspace_name}-{storage_name}"


class AzureBlobStorageProvider(StorageProvider):
    """provider_config keys: subscription_id, location,
    blob_service_client (injectable)."""

    def __init__(self, provider_config: Dict[str, Any],
                 workspace_name: str, storage_name: str):
        super().__init__(provider_config, workspace_name, storage_name)
        self.account = workspace_resource_names(
            workspace_name)["storage_account"]
        self._client = provider_config.get("blob_service_client")

    @property
    def blob(self):
        if self._client is None:
            try:
                from azure.identity import DefaultAzureCredential
                from azure.storage.blob import BlobServiceClient
            except ImportError as e:
                raise RuntimeError(
                    "Azure storage requires the azure SDK "
                    "(not installed in this environment)") from e
            self._client = BlobServiceClient(
                f"https://{self.account}.blob.core.windows.net",
                credential=DefaultAzureCredential())
        return self._client

    @property
    def container(self) -> str:
        return container_name(self.workspace_name, self.storage_name)

    def create(self, config: Dict[str, Any]) -> None:
        try:
            self.blob.create_container(
                self.container,
                metadata={"tik_workspace": self.workspace_name,
                          "tik_managed": "true"})
        except Exception as e:
            if "ContainerAlreadyExists" not in str(
                    getattr(e, "error_code", "") or str(e)):
                raise

    def delete(self, config: Dict[str, Any]) -> None:
        try:
            self.blob.delete_container(self.container)
        except Exception as e:
            if "ContainerNotFound" not in str(
                    getattr(e, "error_code", "") or str(e)):
                raise

    def get_info(self, config: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        container = self.blob.get_container_client(self.container)
        try:
            props = container.get_container_properties()
        except Exception:
            return None
        metadata = getattr(props, "metadata", None) or \
            props.get("metadata", {})
        return {"name": self.container,
                "uri": f"abfs://{self.container}@{self.account}"
                       f".dfs.core.windows.net",
                "managed": metadata.get("tik_managed") == "true"}
