"""NodeProvider — the cloud/infra abstraction under the control plane.

Reference parity: core/node_provider.py:52 (`NodeProvider`: create_node:156,
non_terminated_nodes:78, terminate_node:188, get_command_executor:224, config
pipeline statics :336-376; `NodeLaunchException`:18).

TPU-first divergence: providers may expose **atomic node groups** — a TPU pod
slice is created and terminated as one unit spanning multiple host VMs.  The
scaler treats a group as the unit of launch/terminate/health; per-node
operations remain for ordinary (CPU / single-host) node types.
"""

from __future__ import annotations

import logging
from types import ModuleType
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


class NodeLaunchException(Exception):
    """Raised when a node (or node group) fails to launch.

    `category` is a short machine-readable string (e.g. "quota", "stockout");
    `src_exc_info` optionally carries the original exc_info tuple.
    Reference parity: core/node_provider.py:18.
    """

    def __init__(self, category: str, description: str, src_exc_info=None):
        super().__init__(f"{category}: {description}")
        self.category = category
        self.description = description
        self.src_exc_info = src_exc_info


class NodeKind:
    """What a provider node physically is."""

    VM = "vm"                 # ordinary single-host VM/container
    TPU_SLICE_HOST = "tpu-slice-host"   # one host VM inside a TPU pod slice


class NodeProvider:
    """Interface for node lifecycle against one infrastructure backend.

    One instance is constructed per (provider_config, cluster_name).  All
    methods receive/return provider-native *node ids* (strings).  Tags are
    the durable metadata channel (see cloudtik_tpu_torch.core.tags).

    Thread-safety: the control plane may call concurrently from the scaler,
    launcher threads, and updater threads; implementations must either be
    thread-safe or serialize internally.
    """

    def __init__(self, provider_config: Dict[str, Any], cluster_name: str):
        self.provider_config = provider_config
        self.cluster_name = cluster_name

    # --- queries -----------------------------------------------------------
    def non_terminated_nodes(self, tag_filters: Dict[str, str]) -> List[str]:
        """Node ids of all pending/running nodes matching the tag filters.

        The result of this call forms the scaler's weak-consistency snapshot;
        it is allowed to be stale by one reconciliation period.
        """
        raise NotImplementedError

    def is_running(self, node_id: str) -> bool:
        raise NotImplementedError

    def is_terminated(self, node_id: str) -> bool:
        raise NotImplementedError

    def node_tags(self, node_id: str) -> Dict[str, str]:
        raise NotImplementedError

    def external_ip(self, node_id: str) -> Optional[str]:
        raise NotImplementedError

    def internal_ip(self, node_id: str) -> Optional[str]:
        raise NotImplementedError

    def get_node_info(self, node_id: str) -> Dict[str, Any]:
        """Human-facing info dict (ips, status, instance type, …)."""
        tags = self.node_tags(node_id)
        return {
            "node_id": node_id,
            "tags": tags,
            "internal_ip": self.internal_ip(node_id),
            "external_ip": self.external_ip(node_id),
        }

    # --- mutation ------------------------------------------------------------
    def create_node(
        self,
        node_config: Dict[str, Any],
        tags: Dict[str, str],
        count: int,
    ) -> Optional[Dict[str, Any]]:
        """Create `count` nodes. May raise NodeLaunchException.

        Returns an optional dict of created node id -> metadata.
        """
        raise NotImplementedError

    def create_node_with_resources_and_labels(
        self,
        node_config: Dict[str, Any],
        tags: Dict[str, str],
        count: int,
        resources: Dict[str, float],
        labels: Dict[str, str],
    ) -> Optional[Dict[str, Any]]:
        """Create nodes honoring an explicit resource/label ask (used by the
        demand scheduler).  Default ignores resources/labels."""
        return self.create_node(node_config, tags, count)

    def set_node_tags(self, node_id: str, tags: Dict[str, str]) -> None:
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def terminate_nodes(self, node_ids: List[str]) -> Optional[Dict[str, Any]]:
        results = {}
        for node_id in node_ids:
            r = self.terminate_node(node_id)
            if r:
                results.update(r)
        return results or None

    # --- node groups (TPU pod slices) --------------------------------------
    # Default: provider has no atomic groups; every node is its own unit.

    def supports_node_groups(self) -> bool:
        return False

    def create_node_group(
        self,
        node_config: Dict[str, Any],
        tags: Dict[str, str],
        group_size: int,
    ) -> Optional[str]:
        """Create one atomic group of `group_size` host nodes (e.g. one TPU
        pod slice whose topology implies `group_size` worker VMs).  Returns
        the group id.  Member nodes appear in non_terminated_nodes with
        TAG_NODE_GROUP_ID / TAG_NODE_GROUP_WORKER_INDEX tags."""
        raise NotImplementedError

    def terminate_node_group(self, group_id: str) -> None:
        """Terminate an entire group atomically."""
        raise NotImplementedError

    def list_node_groups(self, tag_filters: Dict[str, str]) -> Dict[str, List[str]]:
        """group id -> ordered member node ids (worker index order)."""
        return {}

    # --- wiring --------------------------------------------------------------
    def get_command_executor(
        self,
        call_context,
        log_prefix: str,
        node_id: str,
        auth_config: Dict[str, Any],
        cluster_name: str,
        process_runner: ModuleType = None,
        use_internal_ip: bool = False,
        docker_config: Optional[Dict[str, Any]] = None,
    ):
        """Build the CommandExecutor used to reach this node (SSH by default).

        Reference parity: core/node_provider.py:224.
        """
        from cloudtik_tpu_torch.control.executor.factory import make_command_executor

        return make_command_executor(
            call_context=call_context,
            log_prefix=log_prefix,
            node_id=node_id,
            provider=self,
            auth_config=auth_config,
            cluster_name=cluster_name,
            process_runner=process_runner,
            use_internal_ip=use_internal_ip,
            docker_config=docker_config,
        )

    def prepare_for_head_node(
        self, cluster_config: Dict[str, Any], remote_config: Dict[str, Any]
    ) -> Dict[str, Any]:
        """Rewrite the config that will be stored on the head node."""
        return remote_config

    def cleanup(self) -> None:
        """Release provider resources (HTTP sessions, threads)."""

    # --- config pipeline (statics) ------------------------------------------
    # Order (reference node_provider.py:336-376):
    #   prepare_config -> post_prepare -> validate_config -> bootstrap_config
    # bootstrap runs only on the client before launch; verify runs on demand.

    @staticmethod
    def prepare_config(cluster_config: Dict[str, Any]) -> Dict[str, Any]:
        return cluster_config

    @staticmethod
    def post_prepare(cluster_config: Dict[str, Any]) -> Dict[str, Any]:
        return cluster_config

    @staticmethod
    def validate_config(provider_config: Dict[str, Any]) -> None:
        return None

    @staticmethod
    def bootstrap_config(cluster_config: Dict[str, Any]) -> Dict[str, Any]:
        return cluster_config

    @staticmethod
    def verify_config(provider_config: Dict[str, Any]) -> None:
        return None

    @staticmethod
    def bootstrap_config_for_api(cluster_config: Dict[str, Any]) -> Dict[str, Any]:
        """Light bootstrap for read-only API paths."""
        return cluster_config
