"""MinIO runtime: S3-compatible object storage.

Reference parity: runtime/minio (SURVEY.md §2.3 — 591 LoC).  Distributed
mode: every server lists the full (identical, sorted) server-pool URL set
so MinIO forms one erasure set.
"""

from __future__ import annotations

from typing import Any, Dict, List

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    ALL_NODES, ServiceRuntimeBase)
from cloudtik_tpu_torch.runtimes.etcd.runtime import quorum_members

MINIO_PORT = 9000
MINIO_CONSOLE_PORT = 9001


def render_minio_env(peers: List[Dict[str, Any]],
                     port: int = MINIO_PORT,
                     root_user: str = "tikadmin",
                     root_password: str = "tikadmin",
                     data_dir: str = "~/.tik/minio/data") -> str:
    ordered = sorted(peers, key=lambda p: p["name"])
    if len(ordered) > 1:
        volumes = " ".join(f"http://{p['ip']}:{port}{data_dir}"
                           for p in ordered)
    else:
        volumes = data_dir
    return "\n".join([
        f"MINIO_ROOT_USER={root_user}",
        f"MINIO_ROOT_PASSWORD={root_password}",
        f"MINIO_VOLUMES=\"{volumes}\"",
        f"MINIO_OPTS=\"--address :{port} "
        f"--console-address :{MINIO_CONSOLE_PORT}\"",
    ]) + "\n"


class MinIORuntime(ServiceRuntimeBase):
    SERVICE_NAME = "minio"
    DEFAULT_PORT = MINIO_PORT
    PROTOCOL = "http"
    NODE_KIND = ALL_NODES
    PROCESS_KEYWORD = "minio server"
    ENDPOINT_NAME = "MinIO"
    BINARY = "minio"
    # Reference: runtime/minio install recipe (single static binary).
    INSTALL = {
        "type": "archive",
        "url": "https://dl.min.io/server/minio/release/linux-amd64/minio",
        "binary": "minio",
    }

    def service_command(self, node_context: Dict[str, Any]):
        import os
        binary = self.find_binary()
        if binary is None:
            return None
        data_dir = os.path.expanduser(
            self.runtime_config.get("data_dir", "~/.tik/minio/data"))
        os.makedirs(data_dir, exist_ok=True)
        return [binary, "server", data_dir, "--address", f":{self.port}"]

    def service_env(self, node_context: Dict[str, Any]):
        return {
            "MINIO_ROOT_USER": self.runtime_config.get(
                "root_user", "tikadmin"),
            "MINIO_ROOT_PASSWORD": self.runtime_config.get(
                "root_password", "tikadmin"),
        }

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        import os
        me = node_context.get("node_id", "")
        peers = quorum_members(node_context)
        if node_context.get("is_head") and all(
                p["name"] != me for p in peers):
            peers = [{"name": me, "ip": node_context.get("head_ip", "")}] \
                + peers
        env = render_minio_env(
            peers or [{"name": me,
                       "ip": node_context.get("head_ip", "127.0.0.1")}],
            port=self.port,
            root_user=self.runtime_config.get("root_user", "tikadmin"),
            root_password=self.runtime_config.get(
                "root_password", "tikadmin"))
        with open(os.path.join(self.conf_dir(node_context),
                               "minio.env"), "w") as f:
            f.write(env)
