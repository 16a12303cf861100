"""AI runtime: the port's training stack as a cluster service plugin.

Counterpart of `cloudtik_tpu/runtimes/ai/runtime.py`, with its hooks, for
GPU hosts.  A cluster config names it by module and class under
`runtime.types` (`cloudtik_tpu_torch.runtimes.ai.runtime:AIRuntime`; the
reference's registry loads such a name), and its options under the same
key.  The runtime's job is to
  * install the port's third-party packages on a node without torch,
  * expose the port's launcher as the runnable-command handler, so
    `tik submit train.py` lowers to one process per card on every host
    (`python -m cloudtik_tpu_torch.launch.run train.py`),
  * export the slice topology env (group id, worker index, coordinator
    port) on every node,
  * run the experiment tracker service on the head,
  * publish a host-granular scaling policy (asks in cards).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from cloudtik_tpu_torch.core.runtime import Runtime
from cloudtik_tpu_torch.core.scaling_policy import ScalingPolicy
from cloudtik_tpu_torch.core.tags import (
    TAG_NODE_GROUP_ID, TAG_NODE_GROUP_WORKER_INDEX)
from cloudtik_tpu_torch.launch.run import MODULE as LAUNCHER
from cloudtik_tpu_torch.utils.constants import TIK_COORDINATOR_PORT_DEFAULT

RUNNABLE_SUFFIXES = (".py",)


class AIRuntime(Runtime):
    # The third-party packages the port imports at run time (its own
    # imports: torch and numpy everywhere, msgpack in the state client,
    # pyyaml for fault plans written in YAML and the prometheus runtime's
    # config and rules, psutil in the node exporter of the default nodex
    # runtime).  The kernels are built by the CUDA toolkit's nvcc, which
    # no pip package provides.  Overridable per cluster via `install`;
    # skipped when torch is already importable.
    DEFAULT_PACKAGES = ["torch", "numpy", "msgpack", "pyyaml", "psutil"]

    def prepare_config(self, cluster_config: Dict[str, Any]) -> Dict[str, Any]:
        return cluster_config

    def validate_config(self, cluster_config: Dict[str, Any]) -> None:
        return None

    def get_runtime_shared_memory_ratio(
            self, config: Dict[str, Any], node_type: str) -> float:
        """Host data loaders stage batches through /dev/shm; dockerized
        nodes need --shm-size beyond the 64 MB default."""
        return float(self.runtime_config.get("shared_memory_ratio", 0.3))

    def node_install(self, node_context: Dict[str, Any]) -> None:
        """Install the port's packages on nodes that don't already have
        them."""
        try:
            import torch  # noqa: F401
            return  # environment already provisioned (images, tests)
        except ImportError:
            pass
        from cloudtik_tpu_torch.runtimes import installer
        spec = self.runtime_config.get("install") or {
            "type": "pip", "packages": list(self.DEFAULT_PACKAGES)}
        installer.install("ai", spec)

    def with_environment_variables(
        self, config: Dict[str, Any], provider: Any, node_id: str
    ) -> Dict[str, Any]:
        env: Dict[str, Any] = {}
        try:
            tags = provider.node_tags(node_id)
        except Exception:
            tags = {}
        group_id = tags.get(TAG_NODE_GROUP_ID)
        if group_id:
            env["TIK_SLICE_ID"] = group_id
            env["TIK_SLICE_WORKER_INDEX"] = tags.get(
                TAG_NODE_GROUP_WORKER_INDEX, "0")
        env["TIK_COORDINATOR_PORT"] = str(
            self.runtime_config.get(
                "coordinator_port", TIK_COORDINATOR_PORT_DEFAULT))
        return env

    def get_runnable_command(
        self, target: str, runtime_options: Optional[List[str]] = None
    ) -> Optional[List[str]]:
        """`tik submit train.py` -> the port's launcher on the head, which
        starts one process per card on every host.  `python` (default
        "python3") is the nodes' interpreter."""
        if not target.endswith(RUNNABLE_SUFFIXES):
            return None
        cmd = [self.runtime_config.get("python", "python3"), "-m", LAUNCHER]
        if runtime_options:
            cmd.extend(runtime_options)
        cmd.append(target)
        return cmd

    def get_runtime_services(
        self, cluster_config: Dict[str, Any], cluster_head_ip: str
    ) -> Optional[Dict[str, Dict[str, Any]]]:
        tracker_port = self.runtime_config.get("tracker_port", 5000)
        return {
            "ai-tracker": {
                "protocol": "http",
                "port": tracker_port,
                "node_kind": "head",
            },
        }

    def get_runtime_endpoints(
        self, cluster_config: Dict[str, Any], cluster_head_ip: str
    ) -> Optional[Dict[str, Dict[str, Any]]]:
        tracker_port = self.runtime_config.get("tracker_port", 5000)
        return {
            "ai-tracker": {
                "name": "Experiment Tracker",
                "url": f"http://{cluster_head_ip}:{tracker_port}",
            },
        }

    def get_head_service_ports(self) -> Optional[Dict[str, Dict[str, Any]]]:
        return {"ai-tracker": {
            "protocol": "TCP",
            "port": self.runtime_config.get("tracker_port", 5000)}}

    def get_scaling_policy(
        self, cluster_config: Dict[str, Any], head_host: str
    ) -> Optional[ScalingPolicy]:
        from cloudtik_tpu_torch.runtimes.ai.scaling import (
            AISliceScalingPolicy)

        if not self.runtime_config.get("scaling", {}).get("enabled", False):
            return None
        return AISliceScalingPolicy(
            cluster_config, head_host, self.runtime_config.get("scaling", {}))

    def get_logs(self) -> Dict[str, str]:
        return {"ai": "~/.tik/logs/ai"}

    def get_processes(self) -> Optional[List[Tuple[str, bool, str, str]]]:
        return [
            (LAUNCHER, True, "AILauncher", "node"),
            ("tik_tracker", True, "Tracker", "head"),
        ]

    @staticmethod
    def get_dependencies() -> List[str]:
        return ["mount"]
