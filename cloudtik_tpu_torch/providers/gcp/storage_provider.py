"""GCS storage provider: managed bucket lifecycle for workspaces.

Reference parity: providers/_private/gcp/storage_provider.py + the managed
GCS bucket creation inside gcp/config.py (SURVEY.md §3.5 "optional managed
GCS bucket").  Buckets hold datasets/checkpoints the mount runtime
(gcsfuse) and orbax checkpointing consume on TPU hosts.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.core.storage_provider import StorageProvider
from cloudtik_tpu_torch.providers.gcp.rest import GCPApiError, RestClient

STORAGE_API = "https://storage.googleapis.com/storage/v1"


def bucket_name(workspace_name: str, storage_name: str) -> str:
    return f"tik-{workspace_name}-{storage_name}"


class GCSStorageProvider(StorageProvider):
    """provider_config keys: project_id, region, _rest_client (tests)."""

    def __init__(self, provider_config: Dict[str, Any],
                 workspace_name: str, storage_name: str):
        super().__init__(provider_config, workspace_name, storage_name)
        self.project = provider_config["project_id"]
        self.location = (provider_config.get("storage_location")
                         or provider_config.get("region") or "US")
        self.rest: RestClient = (provider_config.get("_rest_client")
                                 or RestClient())

    @property
    def bucket(self) -> str:
        return bucket_name(self.workspace_name, self.storage_name)

    def _bucket_url(self) -> str:
        return f"{STORAGE_API}/b/{self.bucket}"

    def create(self, config: Dict[str, Any]) -> None:
        try:
            self.rest.post(
                f"{STORAGE_API}/b?project={self.project}",
                {"name": self.bucket,
                 "location": self.location,
                 "iamConfiguration": {
                     "uniformBucketLevelAccess": {"enabled": True}},
                 "labels": {"tik-workspace": self.workspace_name,
                            "tik-managed": "true"}})
        except GCPApiError as e:
            if not e.conflict:  # already exists: idempotent create
                raise

    def _list_objects(self) -> List[str]:
        names: List[str] = []
        page: Optional[str] = None
        while True:
            url = f"{self._bucket_url()}/o?maxResults=500"
            if page:
                url += f"&pageToken={page}"
            resp = self.rest.get(url)
            names.extend(i["name"] for i in resp.get("items", []))
            page = resp.get("nextPageToken")
            if not page:
                return names

    def delete(self, config: Dict[str, Any]) -> None:
        try:
            # GCS refuses to delete non-empty buckets; drain first.
            for obj in self._list_objects():
                from urllib.parse import quote
                self.rest.delete(
                    f"{self._bucket_url()}/o/{quote(obj, safe='')}")
            self.rest.delete(self._bucket_url())
        except GCPApiError as e:
            if not e.not_found:
                raise

    def get_info(self, config: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        try:
            info = self.rest.get(self._bucket_url())
        except GCPApiError as e:
            if e.not_found:
                return None
            raise
        return {"name": self.bucket,
                "uri": f"gs://{self.bucket}",
                "location": info.get("location"),
                "managed": info.get("labels", {}).get(
                    "tik-managed") == "true"}

    def validate_config(self, provider_config: Dict[str, Any]) -> None:
        if not provider_config.get("project_id"):
            raise ValueError("gcp storage requires provider.project_id")
