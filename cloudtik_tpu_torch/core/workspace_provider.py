"""WorkspaceProvider — shared-infrastructure (VPC/IAM/storage) abstraction.

Reference parity: core/workspace_provider.py:31 (`WorkspaceProvider`
create/delete/update/check_existence; `Existence` enum :21).
"""

from __future__ import annotations

from enum import Enum, auto
from typing import Any, Dict, Optional


class Existence(Enum):
    """Result of a workspace existence check (reference :21)."""

    NOT_EXIST = auto()
    STORAGE_ONLY = auto()          # only managed storage objects remain
    DATABASE_ONLY = auto()
    STORAGE_AND_DATABASE_ONLY = auto()
    IN_COMPLETED = auto()          # partially created/deleted
    COMPLETED = auto()


class WorkspaceProvider:
    """One instance per (provider_config, workspace_name).

    A workspace owns the network fabric (VPC, subnets, NAT, firewalls), the
    identity fabric (service accounts / instance roles — including TPU API
    access scopes on GCP), and optionally managed cloud storage / databases
    shared by every cluster inside it.
    """

    def __init__(self, provider_config: Dict[str, Any], workspace_name: str):
        self.provider_config = provider_config
        self.workspace_name = workspace_name

    def create_workspace(self, config: Dict[str, Any]) -> None:
        raise NotImplementedError

    def delete_workspace(
        self,
        config: Dict[str, Any],
        delete_managed_storage: bool = False,
        delete_managed_database: bool = False,
    ) -> None:
        raise NotImplementedError

    def update_workspace(
        self,
        config: Dict[str, Any],
        delete_managed_storage: bool = False,
        delete_managed_database: bool = False,
    ) -> None:
        raise NotImplementedError

    def check_workspace_existence(self, config: Dict[str, Any]) -> Existence:
        raise NotImplementedError

    def check_workspace_integrity(self, config: Dict[str, Any]) -> bool:
        return self.check_workspace_existence(config) == Existence.COMPLETED

    def list_clusters(self, config: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """cluster name -> cluster info for clusters in this workspace."""
        return None

    def list_storages(self, config: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        return None

    def list_databases(self, config: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        return None

    def publish_global_variables(
        self, cluster_config: Dict[str, Any], global_variables: Dict[str, Any]
    ) -> None:
        """Cross-cluster KV publish within the workspace (used e.g. to hand a
        Spark ETL cluster the ingestion endpoints of a TPU cluster)."""

    def subscribe_global_variables(
        self, cluster_config: Dict[str, Any]
    ) -> Dict[str, Any]:
        return {}

    def get_workspace_info(self, config: Dict[str, Any]) -> Dict[str, Any]:
        return {"name": self.workspace_name}

    @staticmethod
    def validate_config(provider_config: Dict[str, Any]) -> None:
        return None

    @staticmethod
    def bootstrap_workspace_config(config: Dict[str, Any]) -> Dict[str, Any]:
        return config
