"""Mount runtime: cloud-storage FUSE mounts on every node.

Reference parity: runtime/mount (SURVEY.md §2.3 — per-provider
s3fs/gcsfs/blobfuse/ossfs mounts, scripts/mount-storage.sh:10-48).  TPU
focus: gcsfuse for GCS buckets feeding training data to slice hosts; other
providers via their FUSE clients when present.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Any, Dict, List, Optional, Tuple

from cloudtik_tpu_torch.core.runtime import Runtime

_FUSE_BIN = {
    "gcs": "gcsfuse",
    "s3": "s3fs",
    "azure": "blobfuse2",
    "oss": "ossfs",
}


class MountRuntime(Runtime):
    """runtime_config: {"mounts": [{"kind": "gcs", "bucket": "...",
    "path": "/mnt/data", "options": [...]}]}"""

    def validate_config(self, cluster_config: Dict[str, Any]) -> None:
        for mount in self.runtime_config.get("mounts", []):
            kind = mount.get("kind")
            if kind not in _FUSE_BIN:
                raise ValueError(
                    f"mount kind {kind!r} not supported "
                    f"(known: {sorted(_FUSE_BIN)})")
            if not mount.get("bucket") or not mount.get("path"):
                raise ValueError("each mount needs 'bucket' and 'path'")

    def with_environment_variables(self, config, provider, node_id):
        env = {}
        for i, mount in enumerate(self.runtime_config.get("mounts", [])):
            env[f"TIK_MOUNT_{i}"] = mount["path"]
        return env

    def node_services(self, node_context: Dict[str, Any], command: str) -> None:
        for mount in self.runtime_config.get("mounts", []):
            if command == "start":
                mount_one(mount)
            elif command == "stop":
                unmount_one(mount)

    def get_processes(self) -> Optional[List[Tuple[str, bool, str, str]]]:
        return [(binary, False, f"Fuse:{kind}", "node")
                for kind, binary in _FUSE_BIN.items()]


def mount_one(mount: Dict[str, Any]) -> bool:
    """Mount a bucket; returns False when the FUSE binary is unavailable."""
    kind = mount["kind"]
    binary = _FUSE_BIN[kind]
    if not shutil.which(binary):
        return False
    path = os.path.expanduser(mount["path"])
    os.makedirs(path, exist_ok=True)
    if os.path.ismount(path):
        return True
    options = mount.get("options", [])
    if kind == "gcs":
        cmd = [binary, *options, mount["bucket"], path]
    elif kind == "s3":
        cmd = [binary, mount["bucket"], path, *options]
    else:
        cmd = [binary, *options, mount["bucket"], path]
    subprocess.check_call(cmd)
    return True


def unmount_one(mount: Dict[str, Any]) -> None:
    path = os.path.expanduser(mount["path"])
    if os.path.ismount(path):
        subprocess.call(["fusermount", "-u", path])
