"""Config loading: YAML, `from:` template inheritance, deep merge, defaults.

Reference parity: core/_private/utils.py (prepare_config:418,
fill_with_defaults:599, merge_cluster_config:754) and templates/ resolution.

Layering (lowest precedence first):
    built-in template chain (config["from"]) ->
    provider defaults ->
    runtime defaults ->
    user config
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional

import yaml

# Directory of built-in templates, e.g. templates/gcp/tpu-v5p-32.yaml
_TEMPLATES_DIR = os.path.join(os.path.dirname(__file__), "..", "templates")

# Keys whose dict values are *replaced*, not merged, when overridden.
# available_node_types deep-merges per node type so a child config can add a
# TPU worker group while inheriting the template's head type; node_config
# replaces wholesale because partial cloud instance specs are not meaningful.
_REPLACE_KEYS = frozenset({"node_config"})

# Keys whose list values are appended rather than replaced.
_APPEND_KEYS = frozenset(
    {"initialization_commands", "setup_commands", "bootstrap_commands",
     "head_setup_commands", "worker_setup_commands",
     "head_start_commands", "worker_start_commands"}
)


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def deep_merge(
    base: Dict[str, Any],
    override: Dict[str, Any],
    replace_keys: frozenset = _REPLACE_KEYS,
    append_keys: frozenset = _APPEND_KEYS,
) -> Dict[str, Any]:
    """Merge `override` onto `base`, recursing into dicts.

    Returns a new dict; inputs are not mutated.
    """
    result = copy.deepcopy(base)
    for key, value in override.items():
        if key in result:
            if key in replace_keys:
                result[key] = copy.deepcopy(value)
            elif isinstance(result[key], dict) and isinstance(value, dict):
                result[key] = deep_merge(result[key], value, replace_keys, append_keys)
            elif key in append_keys and isinstance(result[key], list) and isinstance(value, list):
                result[key] = result[key] + copy.deepcopy(value)
            else:
                result[key] = copy.deepcopy(value)
        else:
            result[key] = copy.deepcopy(value)
    return result


def resolve_template(name: str, search_dirs: Optional[List[str]] = None) -> str:
    """Resolve a `from:` reference to a template file path.

    `name` may be an absolute/relative path to a YAML file, or a built-in
    template id like "gcp/tpu-v5p-small" (resolved under templates/).
    """
    if os.path.isfile(name):
        return name
    candidates = []
    for d in (search_dirs or []) + [_TEMPLATES_DIR]:
        candidates.append(os.path.join(d, name))
        candidates.append(os.path.join(d, name + ".yaml"))
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise FileNotFoundError(
        f"Template {name!r} not found (searched {candidates})")


def fill_with_defaults(
    config: Dict[str, Any], search_dirs: Optional[List[str]] = None,
    _depth: int = 0,
) -> Dict[str, Any]:
    """Resolve the `from:` inheritance chain bottom-up and merge.

    Reference parity: core/_private/utils.py:599.
    """
    if _depth > 16:
        raise ValueError("Template inheritance chain too deep (cycle?)")
    parent_ref = config.get("from")
    if not parent_ref:
        return copy.deepcopy(config)
    parent_path = resolve_template(parent_ref, search_dirs)
    parent = load_yaml(parent_path)
    parent_dirs = [os.path.dirname(parent_path)] + (search_dirs or [])
    parent = fill_with_defaults(parent, parent_dirs, _depth + 1)
    merged = deep_merge(parent, {k: v for k, v in config.items() if k != "from"})
    return merged


def _fill_node_type_defaults(config: Dict[str, Any]) -> None:
    """Normalize available_node_types: min/max workers, resources dict."""
    node_types = config.setdefault("available_node_types", {})
    head_type = config.get("head_node_type")
    if not head_type and node_types:
        head_type = next(iter(node_types))
        config["head_node_type"] = head_type
    global_max = config.get("max_workers", 0)
    for name, node_type in node_types.items():
        node_type.setdefault("node_config", {})
        node_type.setdefault("resources", {})
        if name == head_type:
            node_type.setdefault("min_workers", 0)
            node_type.setdefault("max_workers", 0)
        else:
            node_type.setdefault("min_workers", 0)
            node_type.setdefault("max_workers", global_max)


def prepare_config(
    config: Dict[str, Any], search_dirs: Optional[List[str]] = None
) -> Dict[str, Any]:
    """The full client-side config pipeline before provider/runtime hooks.

    Reference parity: core/_private/utils.py:418.
    """
    config = fill_with_defaults(config, search_dirs)
    # YAML sections present but empty ("runtime:") parse to None; normalize.
    for key, empty in (("runtime", {}), ("available_node_types", {}),
                       ("auth", {}), ("file_mounts", {}), ("provider", {})):
        if config.get(key) is None:
            config[key] = dict(empty) if isinstance(empty, dict) else empty
    config.setdefault("cluster_name", "default")
    config.setdefault("workspace_name", "default")
    config.setdefault("max_workers", 0)
    config.setdefault("auth", {})
    config.setdefault("file_mounts", {})
    config.setdefault("initialization_commands", [])
    config.setdefault("setup_commands", [])
    config.setdefault("head_setup_commands", [])
    config.setdefault("worker_setup_commands", [])
    config.setdefault("head_start_commands", [])
    config.setdefault("worker_start_commands", [])
    config.setdefault("runtime", {"types": []})
    config["runtime"].setdefault("types", [])
    _fill_node_type_defaults(config)
    return config


def get_head_node_type(config: Dict[str, Any]) -> str:
    return config["head_node_type"]


def get_worker_node_types(config: Dict[str, Any]) -> List[str]:
    head = config.get("head_node_type")
    return [t for t in config.get("available_node_types", {}) if t != head]
