"""JSON-schema validation of cluster/workspace configs.

Reference parity: schema/cluster.json, schema/workspace.json validated by
core/_private/utils.py:363 validate_config.  Schemas are embedded as Python
dicts so the package has no data-file loading concerns.
"""

from __future__ import annotations

from typing import Any, Dict

import jsonschema

NODE_TYPE_SCHEMA: Dict[str, Any] = {
    "type": "object",
    "properties": {
        "node_config": {"type": "object"},
        "resources": {
            "type": "object",
            "additionalProperties": {"type": "number"},
        },
        "min_workers": {"type": "integer", "minimum": 0},
        "max_workers": {"type": "integer", "minimum": 0},
        "labels": {"type": "object"},
        "worker_setup_commands": {"type": "array", "items": {"type": "string"}},
        "worker_start_commands": {"type": "array", "items": {"type": "string"}},
        "runtime": {"type": "object"},
        # TPU-specific: a node type may declare itself an atomic node group
        # (a pod slice); group_size is derived from accelerator topology.
        "node_group": {
            "type": "object",
            "properties": {
                "atomic": {"type": "boolean"},
                "group_size": {"type": "integer", "minimum": 1},
                "accelerator_type": {"type": "string"},
                "topology": {"type": "string"},
                "runtime_version": {"type": "string"},
            },
        },
    },
    "additionalProperties": True,
}

CLUSTER_SCHEMA: Dict[str, Any] = {
    "$schema": "http://json-schema.org/draft-07/schema#",
    "type": "object",
    "required": ["cluster_name", "provider"],
    "properties": {
        "from": {"type": "string"},
        "cluster_name": {"type": "string", "pattern": r"^[a-zA-Z0-9][a-zA-Z0-9\-_]*$"},
        "workspace_name": {"type": "string"},
        "max_workers": {"type": "integer", "minimum": 0},
        "idle_timeout_minutes": {"type": "number", "minimum": 0},
        "provider": {
            "type": "object",
            "required": ["type"],
            "properties": {
                "type": {"type": "string"},
                "module": {"type": "string"},
                "region": {"type": "string"},
                "availability_zone": {"type": "string"},
                "project_id": {"type": ["string", "null"]},
                "use_internal_ips": {"type": "boolean"},
            },
            "additionalProperties": True,
        },
        "auth": {
            "type": "object",
            "properties": {
                "ssh_user": {"type": "string"},
                "ssh_private_key": {"type": "string"},
                "ssh_public_key": {"type": "string"},
                "ssh_proxy_command": {"type": "string"},
            },
            "additionalProperties": True,
        },
        "available_node_types": {
            "type": "object",
            "additionalProperties": NODE_TYPE_SCHEMA,
        },
        "head_node_type": {"type": "string"},
        "file_mounts": {"type": "object"},
        "rsync_exclude": {"type": "array", "items": {"type": "string"}},
        "rsync_filter": {"type": "array", "items": {"type": "string"}},
        "initialization_commands": {"type": "array", "items": {"type": "string"}},
        "setup_commands": {"type": "array", "items": {"type": "string"}},
        "head_setup_commands": {"type": "array", "items": {"type": "string"}},
        "worker_setup_commands": {"type": "array", "items": {"type": "string"}},
        "head_start_commands": {"type": "array", "items": {"type": "string"}},
        "worker_start_commands": {"type": "array", "items": {"type": "string"}},
        "docker": {"type": "object"},
        "runtime": {
            "type": "object",
            "properties": {
                "types": {"type": "array", "items": {"type": "string"}},
            },
            "additionalProperties": True,
        },
        "encryption": {"type": "object"},
    },
    "additionalProperties": True,
}

WORKSPACE_SCHEMA: Dict[str, Any] = {
    "$schema": "http://json-schema.org/draft-07/schema#",
    "type": "object",
    "required": ["workspace_name", "provider"],
    "properties": {
        "from": {"type": "string"},
        "workspace_name": {"type": "string", "pattern": r"^[a-zA-Z0-9][a-zA-Z0-9\-_]*$"},
        "provider": {
            "type": "object",
            "required": ["type"],
            "additionalProperties": True,
        },
    },
    "additionalProperties": True,
}

STORAGE_SCHEMA: Dict[str, Any] = {
    "type": "object",
    "required": ["storage_name", "provider"],
    "properties": {
        "storage_name": {"type": "string"},
        "workspace_name": {"type": "string"},
        "provider": {"type": "object", "required": ["type"]},
    },
    "additionalProperties": True,
}

DATABASE_SCHEMA: Dict[str, Any] = {
    "type": "object",
    "required": ["database_name", "provider"],
    "properties": {
        "database_name": {"type": "string"},
        "workspace_name": {"type": "string"},
        "provider": {"type": "object", "required": ["type"]},
    },
    "additionalProperties": True,
}


class ConfigError(ValueError):
    pass


def _validate(config: Dict[str, Any], schema: Dict[str, Any], what: str) -> None:
    try:
        jsonschema.validate(config, schema)
    except jsonschema.ValidationError as e:
        path = "/".join(str(p) for p in e.absolute_path)
        raise ConfigError(f"Invalid {what} config at '{path}': {e.message}") from e


def validate_cluster_config(config: Dict[str, Any]) -> None:
    _validate(config, CLUSTER_SCHEMA, "cluster")
    # Cross-field checks beyond JSON schema:
    if config.get("docker"):
        from cloudtik_tpu_torch.control.executor.docker import (
            validate_docker_config)
        try:
            validate_docker_config(config)
        except ValueError as e:
            raise ConfigError(str(e)) from e
    node_types = config.get("available_node_types", {})
    head = config.get("head_node_type")
    if head is not None and head not in node_types:
        raise ConfigError(
            f"head_node_type {head!r} is not in available_node_types "
            f"({sorted(node_types)})")
    global_max = config.get("max_workers")
    for name, nt in node_types.items():
        max_workers = nt.get("max_workers", global_max)
        if max_workers is None:
            continue  # filled later by prepare_config
        if nt.get("min_workers", 0) > max_workers and name != head:
            raise ConfigError(
                f"node type {name!r}: min_workers > max_workers")


def validate_workspace_config(config: Dict[str, Any]) -> None:
    _validate(config, WORKSPACE_SCHEMA, "workspace")


def validate_storage_config(config: Dict[str, Any]) -> None:
    _validate(config, STORAGE_SCHEMA, "storage")


def validate_database_config(config: Dict[str, Any]) -> None:
    _validate(config, DATABASE_SCHEMA, "database")
