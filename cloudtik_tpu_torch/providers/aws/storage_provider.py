"""S3 storage provider: managed bucket lifecycle.

Reference parity: providers/_private/aws S3 storage management wired into
workspace managed-storage options (SURVEY.md §2.2 "EC2 + S3 + RDS + ELB").
Follows the AWS node provider's pattern: boto3 is imported lazily and the
client is injectable so tests drive the full provider against a fake.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from cloudtik_tpu_torch.core.storage_provider import StorageProvider
from cloudtik_tpu_torch.providers.aws.node_provider import _boto3


def bucket_name(workspace_name: str, storage_name: str) -> str:
    return f"tik-{workspace_name}-{storage_name}"


def _client_error_code(e: Exception) -> str:
    return getattr(e, "response", {}).get("Error", {}).get("Code", "")


class S3StorageProvider(StorageProvider):
    """provider_config keys: region, profile, s3_client (tests)."""

    def __init__(self, provider_config: Dict[str, Any],
                 workspace_name: str, storage_name: str):
        super().__init__(provider_config, workspace_name, storage_name)
        self.region = provider_config.get("region", "us-west-2")
        self._client = provider_config.get("s3_client")

    @property
    def s3(self):
        if self._client is None:
            boto3 = _boto3()
            session = boto3.session.Session(
                profile_name=self.provider_config.get("profile"),
                region_name=self.region)
            self._client = session.client("s3")
        return self._client

    @property
    def bucket(self) -> str:
        return bucket_name(self.workspace_name, self.storage_name)

    def create(self, config: Dict[str, Any]) -> None:
        kwargs: Dict[str, Any] = {"Bucket": self.bucket}
        if self.region != "us-east-1":  # S3 quirk: default region rejects it
            kwargs["CreateBucketConfiguration"] = {
                "LocationConstraint": self.region}
        try:
            self.s3.create_bucket(**kwargs)
        except Exception as e:
            if _client_error_code(e) not in (
                    "BucketAlreadyOwnedByYou", "BucketAlreadyExists"):
                raise
        self.s3.put_bucket_tagging(
            Bucket=self.bucket,
            Tagging={"TagSet": [
                {"Key": "tik-workspace", "Value": self.workspace_name},
                {"Key": "tik-managed", "Value": "true"}]})

    def delete(self, config: Dict[str, Any]) -> None:
        try:
            # drain objects first (S3 refuses non-empty bucket deletes)
            paginator = self.s3.get_paginator("list_objects_v2")
            for page in paginator.paginate(Bucket=self.bucket):
                objs = [{"Key": o["Key"]} for o in page.get("Contents", [])]
                if objs:
                    self.s3.delete_objects(Bucket=self.bucket,
                                           Delete={"Objects": objs})
            self.s3.delete_bucket(Bucket=self.bucket)
        except Exception as e:
            if _client_error_code(e) not in ("NoSuchBucket", "404"):
                raise

    def get_info(self, config: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        try:
            self.s3.head_bucket(Bucket=self.bucket)
        except Exception as e:
            if _client_error_code(e) in ("NoSuchBucket", "404"):
                return None
            raise
        return {"name": self.bucket,
                "uri": f"s3://{self.bucket}",
                "location": self.region,
                "managed": True}

    def validate_config(self, provider_config: Dict[str, Any]) -> None:
        return None
