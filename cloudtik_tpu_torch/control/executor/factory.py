"""Command executor factory consumed by NodeProvider.get_command_executor.

Reference parity: the executor-selection logic inside
core/node_provider.py:224.
"""

from __future__ import annotations

from types import ModuleType
from typing import Any, Dict, Optional

from cloudtik_tpu_torch.control.executor.base import CommandExecutor
from cloudtik_tpu_torch.control.executor.docker import DockerCommandExecutor
from cloudtik_tpu_torch.control.executor.local import LocalCommandExecutor
from cloudtik_tpu_torch.control.executor.ssh import SSHCommandExecutor, SSHOptions


def make_command_executor(
    call_context=None,
    log_prefix: str = "",
    node_id: str = "",
    provider=None,
    auth_config: Optional[Dict[str, Any]] = None,
    cluster_name: str = "",
    process_runner: ModuleType = None,
    use_internal_ip: bool = False,
    docker_config: Optional[Dict[str, Any]] = None,
) -> CommandExecutor:
    auth_config = auth_config or {}
    if auth_config.get("executor") == "local":
        base: CommandExecutor = LocalCommandExecutor(
            call_context, process_runner, log_prefix, node_id=node_id)
    else:
        options = SSHOptions(
            private_key=auth_config.get("ssh_private_key"),
            proxy_command=auth_config.get("ssh_proxy_command"),
            port=auth_config.get("ssh_port", 22),
        )
        ip = None
        if provider is not None:
            ip = (provider.internal_ip(node_id) if use_internal_ip
                  else provider.external_ip(node_id)
                  or provider.internal_ip(node_id))
        base = SSHCommandExecutor(
            call_context=call_context,
            log_prefix=log_prefix,
            node_id=node_id,
            provider=provider,
            ssh_user=auth_config.get("ssh_user", "root"),
            ssh_ip=ip,
            ssh_options=options,
            process_runner=process_runner,
        )
    if docker_config and docker_config.get("enabled"):
        container = docker_config.get(
            "container_name", f"tik-{cluster_name}")
        return DockerCommandExecutor(
            base, container, docker_config, call_context)
    return base
