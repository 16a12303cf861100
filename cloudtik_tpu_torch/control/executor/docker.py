"""Docker command executor: wraps another executor with `docker exec`.

Reference parity: command_executor/docker_command_executor.py:27 and
core/_private/docker.py (with_docker_exec:74, validate_docker_config:54,
file-mount checks) + _auto_configure_shm
(docker_command_executor.py:500) for /dev/shm sizing from runtime
demand.
"""

from __future__ import annotations

import logging
import os
import shlex
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.control.executor.base import CommandExecutor

logger = logging.getLogger(__name__)


def validate_docker_config(config: Dict[str, Any]) -> None:
    """Reject unusable docker sections at config time instead of at
    first node boot (reference: docker.py validate_docker_config:54).

    Mirrors the executor factory's semantics exactly: docker is OFF
    unless `enabled` is truthy (a bare section is inert), and
    container_name is optional (the factory defaults it to
    tik-<cluster>).  When enabled, an image is required; file
    (non-directory) file_mounts draw a warning, since bind-mounted
    files do not reliably see host updates inside containers.
    """
    docker_config = config.get("docker") or {}
    if not docker_config.get("enabled"):
        return
    image = docker_config.get("image")
    head_image = docker_config.get("head_image", image)
    worker_image = docker_config.get("worker_image", image)
    if not (image or (head_image and worker_image)):
        raise ValueError(
            "docker config requires image (or both head_image and "
            "worker_image)")
    for remote, local in (config.get("file_mounts") or {}).items():
        if os.path.isfile(os.path.expanduser(local)):
            logger.warning(
                "file mount (%s: %s) is a FILE; docker bind-mounted "
                "files do not always see host updates — mount a "
                "directory instead", remote, local)


class DockerCommandExecutor(CommandExecutor):
    def __init__(self, host_executor: CommandExecutor,
                 container_name: str,
                 docker_config: Optional[Dict[str, Any]] = None,
                 call_context=None):
        super().__init__(call_context)
        self.host = host_executor
        self.container_name = container_name
        self.docker_config = docker_config or {}

    def _wrap(self, cmd: str,
              env: Optional[Dict[str, str]] = None) -> str:
        env_args = ""
        if env:
            env_args = " ".join(
                f"-e {k}={shlex.quote(str(v))}" for k, v in env.items())
        inner = shlex.quote(f"bash -c {shlex.quote(cmd)}")
        return (f"docker exec {env_args} {self.container_name} "
                f"/bin/bash -c {inner}")

    def run(self, cmd, *, environment_variables=None, with_output=False,
            run_env="auto", timeout=None, shutdown_after_run=False):
        if run_env == "host":
            return self.host.run(
                cmd, environment_variables=environment_variables,
                with_output=with_output, timeout=timeout)
        return self.host.run(
            self._wrap(cmd, environment_variables),
            with_output=with_output, timeout=timeout,
            shutdown_after_run=shutdown_after_run)

    def run_rsync_up(self, source, target, options=None):
        # Host rsync to a staging path, then docker cp into the container.
        staging = f"/tmp/tik-docker-staging{target}"
        self.host.run_rsync_up(source, staging, options)
        self.host.run(
            f"docker cp {shlex.quote(staging)} "
            f"{self.container_name}:{shlex.quote(target)}")

    def run_rsync_down(self, source, target, options=None):
        staging = f"/tmp/tik-docker-staging{source}"
        self.host.run(
            f"docker cp {self.container_name}:{shlex.quote(source)} "
            f"{shlex.quote(staging)}")
        self.host.run_rsync_down(staging, target, options)

    def remote_shell_command_str(self) -> str:
        return (self.host.remote_shell_command_str()
                + f" docker exec -it {self.container_name} /bin/bash")

    def _auto_shm_options(self, run_options: List[str],
                          shared_memory_ratio: float) -> List[str]:
        """--shm-size sized from the HOST's available memory times the
        runtimes' declared ratio (reference: _auto_configure_shm:500).
        Explicit --shm-size in run_options and a zero ratio both bypass
        detection."""
        if self.docker_config.get("disable_shm_size_detection"):
            return run_options
        if any("--shm-size" in opt for opt in run_options):
            return run_options
        if shared_memory_ratio <= 0:
            return run_options
        try:
            meminfo = self.host.run(
                "cat /proc/meminfo || true", with_output=True) or ""
            if isinstance(meminfo, bytes):
                meminfo = meminfo.decode(errors="replace")
            available_kb = int(next(
                line for line in meminfo.splitlines()
                if "MemAvailable" in line).split()[1])
        except Exception:
            logger.warning("cannot read host MemAvailable; skipping "
                           "--shm-size sizing")
            return run_options
        # overestimate by 10%, same as the reference
        shm_bytes = int(available_kb * 1024 * shared_memory_ratio * 1.1)
        return run_options + [f"--shm-size='{shm_bytes}b'"]

    def run_init(self, *, as_head: bool, file_mounts: Dict[str, str],
                 sync_run_yet: bool,
                 shared_memory_ratio: float = 0.0) -> Optional[bool]:
        """Ensure the container is running (image pull + docker run)."""
        image = self.docker_config.get(
            "head_image" if as_head else "worker_image") or \
            self.docker_config.get("image")
        if not image:
            return None
        check = (f"docker ps -q -f name=^{self.container_name}$")
        running = (self.host.run(check, with_output=True) or "").strip()
        if running:
            return False
        # shm probe (a remote exec) only when a container will start
        run_options = self._auto_shm_options(
            self.docker_config.get("run_options", []) +
            self.docker_config.get(
                "head_run_options" if as_head else "worker_run_options",
                []),
            shared_memory_ratio)
        options = " ".join(run_options)
        mounts = " ".join(
            f"-v {shlex.quote(path)}:{shlex.quote(path)}"
            for path in file_mounts)
        self.host.run(
            f"docker run --rm --name {self.container_name} -d --network "
            f"host {mounts} {options} {shlex.quote(image)} "
            f"sleep infinity")
        return True
