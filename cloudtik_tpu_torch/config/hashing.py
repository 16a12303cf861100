"""Config hashing for idempotent reconciliation.

Reference parity: core/_private/utils.py hash_launch_conf:1516 and
hash_runtime_conf:1588.  Nodes are tagged with these hashes so `tik start`
and the scaler converge existing clusters instead of recreating them.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Iterable, Optional, Tuple


def _stable_dumps(obj: Any) -> str:
    return json.dumps(obj, sort_keys=True, default=str)


def hash_launch_conf(node_config: Dict[str, Any], auth: Dict[str, Any]) -> str:
    """Hash of everything that requires node *replacement* when changed."""
    hasher = hashlib.sha1()
    hasher.update(_stable_dumps({"node": node_config, "auth": auth}).encode())
    return hasher.hexdigest()


def _hash_file(hasher: "hashlib._Hash", path: str, rel_to: str) -> None:
    # Hash the path *relative to the mount root* so moving a checkout does not
    # change the contents hash (the remote paths are covered by runtime_hash).
    hasher.update(os.path.relpath(path, rel_to).encode())
    if os.path.isdir(path):
        for root, dirs, files in os.walk(path):
            dirs.sort()
            for name in sorted(files):
                _hash_file(hasher, os.path.join(root, name), rel_to)
        return
    try:
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(2 ** 20), b""):
                hasher.update(chunk)
    except OSError:
        hasher.update(b"<unreadable>")


def hash_runtime_conf(
    file_mounts: Dict[str, str],
    extra_objs: Any,
    generate_contents_hash: bool = False,
) -> Tuple[str, Optional[str]]:
    """(runtime_hash, file_mounts_contents_hash).

    runtime_hash covers mount *paths* + setup/start commands: change ->
    re-run node setup.  contents_hash covers mount file *contents*: change ->
    rsync without restart.
    """
    runtime_hasher = hashlib.sha1()
    runtime_hasher.update(_stable_dumps(sorted(file_mounts.items())).encode())
    runtime_hasher.update(_stable_dumps(extra_objs).encode())
    contents_hash = None
    if generate_contents_hash:
        contents_hasher = hashlib.sha1()
        for _remote, local in sorted(file_mounts.items()):
            local = os.path.expanduser(local)
            _hash_file(contents_hasher, local, os.path.dirname(local) or ".")
        contents_hash = contents_hasher.hexdigest()
    return runtime_hasher.hexdigest(), contents_hash
