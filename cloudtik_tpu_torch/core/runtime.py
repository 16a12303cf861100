"""Runtime — the service-plugin interface.

Reference parity: core/runtime.py:13 (`Runtime` ABC, lifecycle hooks :28-252).
A runtime is a service stack (AI training, monitoring, storage, discovery, …)
installed on cluster nodes.  The control plane drives runtimes through the
config pipeline at launch time and the node lifecycle at bootstrap time.

Lifecycle (client side, before launch):
    prepare_config -> validate_config -> verify_config -> bootstrap_config
Node side (driven by the node updater / `tik node` CLI):
    install -> configure -> services start/stop
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from cloudtik_tpu_torch.core.job_waiter import JobWaiter
from cloudtik_tpu_torch.core.scaling_policy import ScalingPolicy


class NodeConstraint:
    """Quorum/minimal-node launch semantics for stateful runtimes.

    Reference parity: core/runtime.py:193 get_node_constraints.
    """

    def __init__(
        self,
        minimal: int,
        quorum: bool = False,
        scalable: bool = True,
    ):
        # minimal: nodes that must launch together before runtime start
        # quorum: members form a quorum whose identity persists across scale
        self.minimal = minimal
        self.quorum = quorum
        self.scalable = scalable


class RuntimeHealthCheck:
    """A health-check the platform exposes over TCP (xinetd-style)."""

    def __init__(self, name: str, script: str, port: int):
        self.name = name
        self.script = script
        self.port = port


class Runtime:
    """Base class for all runtime plugins.

    Subclasses are registered in cloudtik_tpu_torch.runtimes.registry and looked up
    by name from the cluster config's `runtime.types` list.
    """

    def __init__(self, runtime_config: Dict[str, Any]):
        self.runtime_config = runtime_config

    # --- config pipeline (client, pre-launch) ------------------------------
    def prepare_config(self, cluster_config: Dict[str, Any]) -> Dict[str, Any]:
        return cluster_config

    def validate_config(self, cluster_config: Dict[str, Any]) -> None:
        return None

    def verify_config(self, cluster_config: Dict[str, Any]) -> None:
        return None

    def bootstrap_config(self, cluster_config: Dict[str, Any]) -> Dict[str, Any]:
        return cluster_config

    # --- environment / node lifecycle --------------------------------------
    def with_environment_variables(
        self, config: Dict[str, Any], provider: Any, node_id: str
    ) -> Dict[str, Any]:
        """Env vars exported to every setup/start command on a node."""
        return {}

    def node_install(self, node_context: Dict[str, Any]) -> None:
        """Install software on the node (idempotent)."""

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        """Write config files on the node after install."""

    def node_services(self, node_context: Dict[str, Any], command: str) -> None:
        """Start/stop the runtime's services on the node.

        command is "start" or "stop".
        """

    # --- metadata -----------------------------------------------------------
    def get_runtime_commands(self, cluster_config: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Optional dict of setup/start/stop command templates (commands.yaml
        equivalent) merged into the cluster's node commands."""
        return None

    def get_defaults_config(self, cluster_config: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Runtime defaults merged under the cluster config."""
        return None

    def get_runtime_environment_variables(
        self, config: Dict[str, Any], provider: Any, node_id: str
    ) -> Dict[str, Any]:
        return self.with_environment_variables(config, provider, node_id)

    def get_runtime_shared_memory_ratio(
        self, config: Dict[str, Any], node_type: str
    ) -> float:
        return 0.0

    def get_runtime_services(
        self, cluster_config: Dict[str, Any], cluster_head_ip: str
    ) -> Optional[Dict[str, Dict[str, Any]]]:
        """Service-discovery registrations: name -> {protocol, port, node_kind,
        tags}.  Reference parity: core/runtime.py:172."""
        return None

    def get_runtime_endpoints(
        self, cluster_config: Dict[str, Any], cluster_head_ip: str
    ) -> Optional[Dict[str, Dict[str, Any]]]:
        """User-facing URLs (e.g. MLflow UI, dashboards)."""
        return None

    def get_head_service_ports(self) -> Optional[Dict[str, Dict[str, Any]]]:
        return None

    def get_node_constraints(
        self, cluster_config: Dict[str, Any], node_type: str
    ) -> Optional[NodeConstraint]:
        """Reference parity: core/runtime.py:193."""
        return None

    def get_scaling_policy(
        self, cluster_config: Dict[str, Any], head_host: str
    ) -> Optional[ScalingPolicy]:
        """Reference parity: core/runtime.py:219."""
        return None

    def get_job_waiter(self, cluster_config: Dict[str, Any]) -> Optional[JobWaiter]:
        """Reference parity: core/runtime.py:229."""
        return None

    def get_health_check(
        self, cluster_config: Dict[str, Any]
    ) -> Optional[RuntimeHealthCheck]:
        """Reference parity: core/runtime.py:237."""
        return None

    def get_runnable_command(
        self, target: str, runtime_options: Optional[List[str]] = None
    ) -> Optional[List[str]]:
        """How to run a submitted file (e.g. train.py -> tik-run train.py).

        Reference parity: core/runtime.py:123.
        """
        return None

    def get_logs(self) -> Dict[str, str]:
        """log name -> directory, tailed by the log agent.

        Reference parity: core/runtime.py:255.
        """
        return {}

    def get_processes(self) -> Optional[List[Tuple[str, bool, str, str]]]:
        """Process match specs for the node agent:
        (keyword, match_cmdline, friendly_name, node_kind).

        Reference parity: core/runtime.py:262.
        """
        return None

    def require_minimal_nodes(self, cluster_config: Dict[str, Any]) -> bool:
        return False

    def cluster_booting_completed(
        self, cluster_config: Dict[str, Any], head_node_id: str
    ) -> None:
        """Hook fired once when the cluster finishes booting."""

    @staticmethod
    def get_dependencies() -> List[str]:
        """Names of runtimes that must configure before this one.

        Reference parity: core/runtime.py:280.
        """
        return []
