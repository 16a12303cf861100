"""StorageProvider — managed cloud-storage (object store) abstraction.

Reference parity: core/storage_provider.py:10.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class StorageProvider:
    """One instance per (provider_config, workspace_name, storage_name)."""

    def __init__(
        self,
        provider_config: Dict[str, Any],
        workspace_name: str,
        storage_name: str,
    ):
        self.provider_config = provider_config
        self.workspace_name = workspace_name
        self.storage_name = storage_name

    def create(self, config: Dict[str, Any]) -> None:
        """Create the storage object (e.g. a GCS bucket)."""
        raise NotImplementedError

    def delete(self, config: Dict[str, Any]) -> None:
        raise NotImplementedError

    def get_info(self, config: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        return None

    def validate_config(self, provider_config: Dict[str, Any]) -> None:
        return None

    @staticmethod
    def bootstrap_config(config: Dict[str, Any]) -> Dict[str, Any]:
        return config
