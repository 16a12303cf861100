"""Workspace operator: create/delete/update/status verbs.

Reference parity: core/_private/workspace/workspace_operator.py.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

from cloudtik_tpu_torch.core.workspace_provider import Existence
from cloudtik_tpu_torch.providers.factory import create_workspace_provider
from cloudtik_tpu_torch.utils.cli_logger import cli_logger

logger = logging.getLogger(__name__)


def create_workspace(config: Dict[str, Any], yes: bool = False) -> None:
    provider = create_workspace_provider(
        config["provider"], config["workspace_name"])
    existence = provider.check_workspace_existence(config)
    if existence == Existence.COMPLETED:
        cli_logger.info("Workspace {} already exists.",
                        config["workspace_name"])
        # Managed infra may have been added to the config after the
        # workspace was created; provider create() calls are idempotent.
        _create_managed_infra(config)
        return
    cli_logger.confirm(yes, "Create workspace {}?", config["workspace_name"])
    provider.create_workspace(config)
    _create_managed_infra(config)
    cli_logger.success("Workspace {} created.", config["workspace_name"])


def _create_managed_infra(config: Dict[str, Any]) -> None:
    """Provision managed storage/database declared in the workspace config
    (reference: gcp/config.py optional managed GCS bucket / Cloud SQL,
    SURVEY.md §3.5)."""
    from cloudtik_tpu_torch.providers.factory import (
        create_database_provider, create_storage_provider)

    for name, storage_config in (config.get("managed_storage")
                                 or {}).items():
        sp = create_storage_provider(
            config["provider"], config["workspace_name"], name)
        sp.create(dict(config, storage=storage_config or {}))
        cli_logger.info("Managed storage {} provisioned.", name)
    for name, db_config in (config.get("managed_database") or {}).items():
        dp = create_database_provider(
            config["provider"], config["workspace_name"], name)
        dp.create(dict(config, database=db_config or {}))
        cli_logger.info("Managed database {} provisioned.", name)


def delete_workspace(
    config: Dict[str, Any], yes: bool = False,
    delete_managed_storage: bool = False,
    delete_managed_database: bool = False,
) -> None:
    provider = create_workspace_provider(
        config["provider"], config["workspace_name"])
    existence = provider.check_workspace_existence(config)
    if existence == Existence.NOT_EXIST:
        cli_logger.info("Workspace {} does not exist.",
                        config["workspace_name"])
        return
    cli_logger.confirm(yes, "Delete workspace {}?", config["workspace_name"])
    from cloudtik_tpu_torch.providers.factory import (
        create_database_provider, create_storage_provider)
    if delete_managed_storage:
        for name in (config.get("managed_storage") or {}):
            create_storage_provider(
                config["provider"], config["workspace_name"],
                name).delete(config)
    if delete_managed_database:
        for name in (config.get("managed_database") or {}):
            create_database_provider(
                config["provider"], config["workspace_name"],
                name).delete(config)
    provider.delete_workspace(
        config, delete_managed_storage=delete_managed_storage,
        delete_managed_database=delete_managed_database)
    cli_logger.success("Workspace {} deleted.", config["workspace_name"])


def update_workspace(config: Dict[str, Any], yes: bool = False) -> None:
    provider = create_workspace_provider(
        config["provider"], config["workspace_name"])
    cli_logger.confirm(yes, "Update workspace {}?", config["workspace_name"])
    provider.update_workspace(config)
    _create_managed_infra(config)
    cli_logger.success("Workspace {} updated.", config["workspace_name"])


def get_workspace_status(config: Dict[str, Any]) -> Dict[str, Any]:
    provider = create_workspace_provider(
        config["provider"], config["workspace_name"])
    existence = provider.check_workspace_existence(config)
    info = provider.get_workspace_info(config)
    return {"existence": existence.name, **info}


def list_workspace_clusters(
        config: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    provider = create_workspace_provider(
        config["provider"], config["workspace_name"])
    return provider.list_clusters(config)
