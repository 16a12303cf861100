"""DatabaseProvider — managed cloud-database abstraction.

Reference parity: core/database_provider.py:10.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class DatabaseProvider:
    """One instance per (provider_config, workspace_name, database_name)."""

    def __init__(
        self,
        provider_config: Dict[str, Any],
        workspace_name: str,
        database_name: str,
    ):
        self.provider_config = provider_config
        self.workspace_name = workspace_name
        self.database_name = database_name

    def create(self, config: Dict[str, Any]) -> None:
        """Create the managed database instance (e.g. Cloud SQL)."""
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
