"""Programmatic API: Workspace / Cluster / ThisCluster.

Reference parity: core/api.py:22 (Workspace), :65 (Cluster: start:107,
stop:129, exec:153, submit:223, rsync:349, scale:382, wait_for_ready:586),
:630 (ThisCluster — the on-cluster self API).

Operators are imported lazily so that importing cloudtik_tpu_torch stays cheap and
has no side effects.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

from cloudtik_tpu_torch.config.loader import (
    fill_with_defaults, load_yaml, prepare_config)
from cloudtik_tpu_torch.config.schema import (
    validate_cluster_config, validate_workspace_config)


def _search_dirs(config: Union[str, Dict[str, Any]]):
    import os
    if isinstance(config, str):
        return [os.path.dirname(os.path.abspath(config))]
    return None


def _load_cluster_config(config: Union[str, Dict[str, Any]]) -> Dict[str, Any]:
    search_dirs = _search_dirs(config)
    if isinstance(config, str):
        config = load_yaml(config)
    config = prepare_config(config, search_dirs)
    validate_cluster_config(config)
    return config


def _load_workspace_config(config: Union[str, Dict[str, Any]]) -> Dict[str, Any]:
    # Workspace configs resolve templates but must NOT pass through the
    # cluster default pipeline (no node types / command lists / cluster_name).
    search_dirs = _search_dirs(config)
    if isinstance(config, str):
        config = load_yaml(config)
    config = fill_with_defaults(config, search_dirs)
    validate_workspace_config(config)
    return config


class Workspace:
    """Shared-infrastructure handle (VPC/IAM/storage scope for clusters)."""

    def __init__(self, workspace_config: Union[str, Dict[str, Any]]):
        self.config = _load_workspace_config(workspace_config)

    @property
    def name(self) -> str:
        return self.config["workspace_name"]

    def create(self, yes: bool = True) -> None:
        from cloudtik_tpu_torch.control import workspace_operator
        workspace_operator.create_workspace(self.config, yes=yes)

    def delete(
        self, yes: bool = True,
        delete_managed_storage: bool = False,
        delete_managed_database: bool = False,
    ) -> None:
        from cloudtik_tpu_torch.control import workspace_operator
        workspace_operator.delete_workspace(
            self.config, yes=yes,
            delete_managed_storage=delete_managed_storage,
            delete_managed_database=delete_managed_database)

    def update(self, yes: bool = True) -> None:
        from cloudtik_tpu_torch.control import workspace_operator
        workspace_operator.update_workspace(self.config, yes=yes)

    def status(self):
        from cloudtik_tpu_torch.control import workspace_operator
        return workspace_operator.get_workspace_status(self.config)

    def list_clusters(self) -> Optional[Dict[str, Any]]:
        from cloudtik_tpu_torch.control import workspace_operator
        return workspace_operator.list_workspace_clusters(self.config)


class Cluster:
    """Cluster handle: create/teardown/exec/submit/scale from a client."""

    def __init__(
        self,
        cluster_config: Union[str, Dict[str, Any]],
        should_bootstrap: bool = True,
    ):
        self.config = _load_cluster_config(cluster_config)
        self.should_bootstrap = should_bootstrap

    @property
    def name(self) -> str:
        return self.config["cluster_name"]

    def start(self, restart_only: bool = False, no_restart: bool = False) -> None:
        """Create or update the cluster (head + min workers)."""
        from cloudtik_tpu_torch.control import cluster_operator
        cluster_operator.create_or_update_cluster(
            self.config, restart_only=restart_only, no_restart=no_restart)

    def stop(
        self, workers_only: bool = False, keep_min_workers: bool = False,
        hard: bool = False,
    ) -> None:
        from cloudtik_tpu_torch.control import cluster_operator
        cluster_operator.teardown_cluster(
            self.config, workers_only=workers_only,
            keep_min_workers=keep_min_workers, hard=hard)

    def exec(
        self,
        cmd: str,
        node_ip: Optional[str] = None,
        all_nodes: bool = False,
        run_env: str = "auto",
        tmux: bool = False,
        stop: bool = False,
        port_forward: Optional[List[int]] = None,
        with_output: bool = False,
        job_waiter: Optional[str] = None,
    ) -> Optional[str]:
        from cloudtik_tpu_torch.control import cluster_operator
        return cluster_operator.exec_on_cluster(
            self.config, cmd, node_ip=node_ip, all_nodes=all_nodes,
            run_env=run_env, tmux=tmux, stop=stop,
            port_forward=port_forward, with_output=with_output,
            job_waiter_name=job_waiter)

    def submit(
        self,
        script: str,
        script_args: Optional[List[str]] = None,
        tmux: bool = False,
        stop: bool = False,
        job_waiter: Optional[str] = None,
    ) -> Optional[str]:
        """Rsync a job file to the head and run it via the matching runtime."""
        from cloudtik_tpu_torch.control import cluster_operator
        return cluster_operator.submit_to_cluster(
            self.config, script, script_args or [], tmux=tmux, stop=stop,
            job_waiter_name=job_waiter)

    def rsync(
        self, source: str, target: str, down: bool = False,
        node_ip: Optional[str] = None, all_workers: bool = False,
    ) -> None:
        from cloudtik_tpu_torch.control import cluster_operator
        cluster_operator.rsync_cluster(
            self.config, source, target, down=down, node_ip=node_ip,
            all_workers=all_workers)

    def scale(
        self,
        num_cpus: Optional[int] = None,
        num_workers: Optional[int] = None,
        node_type: Optional[str] = None,
    ) -> None:
        from cloudtik_tpu_torch.control import cluster_operator
        cluster_operator.scale_cluster(
            self.config, num_cpus=num_cpus, num_workers=num_workers,
            node_type=node_type)

    def status(self) -> Dict[str, Any]:
        from cloudtik_tpu_torch.control import cluster_operator
        return cluster_operator.get_cluster_status(self.config)

    def info(self) -> Dict[str, Any]:
        from cloudtik_tpu_torch.control import cluster_operator
        return cluster_operator.get_cluster_info(self.config)

    def get_head_node_ip(self) -> Optional[str]:
        from cloudtik_tpu_torch.control import cluster_operator
        return cluster_operator.get_head_node_ip(self.config)

    def get_worker_node_ips(self) -> List[str]:
        from cloudtik_tpu_torch.control import cluster_operator
        return cluster_operator.get_worker_node_ips(self.config)

    def wait_for_ready(
        self, min_workers: Optional[int] = None, timeout: int = 600
    ) -> None:
        from cloudtik_tpu_torch.control import cluster_operator
        cluster_operator.wait_for_ready(self.config, min_workers, timeout)


class ThisCluster:
    """Self API usable from a process running *on* the cluster head."""

    def __init__(self):
        from cloudtik_tpu_torch.control.services import load_bootstrap_config
        self.config = load_bootstrap_config()

    @property
    def name(self) -> str:
        return self.config["cluster_name"]

    def exec(self, cmd: str, all_nodes: bool = False, **kwargs) -> Optional[str]:
        from cloudtik_tpu_torch.control import cluster_operator
        return cluster_operator.exec_on_cluster(
            self.config, cmd, all_nodes=all_nodes, on_head=True, **kwargs)

    def scale(self, num_workers: Optional[int] = None,
              node_type: Optional[str] = None) -> None:
        from cloudtik_tpu_torch.control import cluster_operator
        cluster_operator.scale_cluster(
            self.config, num_workers=num_workers, node_type=node_type,
            on_head=True)

    def status(self) -> Dict[str, Any]:
        from cloudtik_tpu_torch.control import cluster_operator
        return cluster_operator.get_cluster_status(self.config, on_head=True)

    def get_worker_node_ips(self) -> List[str]:
        from cloudtik_tpu_torch.control import cluster_operator
        return cluster_operator.get_worker_node_ips(self.config, on_head=True)
