"""CommandExecutor — transport for running commands / syncing files on nodes.

Reference parity: core/command_executor.py ABC +
core/_private/command_executor/ (SSHCommandExecutor
ssh_command_executor.py:70, DockerCommandExecutor :27,
LocalCommandExecutor :23).
"""

from __future__ import annotations

import os
import subprocess
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch import telemetry
from cloudtik_tpu_torch.telemetry import instruments as ti
from cloudtik_tpu_torch.utils import compile_cache


class CommandError(RuntimeError):
    def __init__(self, cmd: str, returncode: int, output: Optional[str] = None):
        super().__init__(
            f"command failed (exit {returncode}): {cmd}"
            + (f"\n{output}" if output else ""))
        self.cmd = cmd
        self.returncode = returncode
        self.output = output


class CommandExecutor:
    def __init__(self, call_context=None):
        self.call_context = call_context

    def run(
        self,
        cmd: str,
        *,
        environment_variables: Optional[Dict[str, str]] = None,
        with_output: bool = False,
        run_env: str = "auto",
        timeout: Optional[int] = None,
        shutdown_after_run: bool = False,
    ) -> Optional[str]:
        """Run a shell command on the node.  Raises CommandError on failure;
        returns captured stdout when with_output."""
        raise NotImplementedError

    def run_rsync_up(self, source: str, target: str,
                     options: Optional[Dict[str, Any]] = None) -> None:
        raise NotImplementedError

    def run_rsync_down(self, source: str, target: str,
                       options: Optional[Dict[str, Any]] = None) -> None:
        raise NotImplementedError

    def remote_shell_command_str(self) -> str:
        """A shell command string that opens an interactive shell."""
        raise NotImplementedError

    def run_init(self, *, as_head: bool, file_mounts: Dict[str, str],
                 sync_run_yet: bool,
                 shared_memory_ratio: float = 0.0) -> Optional[bool]:
        """Pre-setup hook (e.g. start docker container).  Returns True if it
        changed node state in a way that requires re-running file sync.
        shared_memory_ratio: fraction of node memory for /dev/shm (docker
        --shm-size sizing; runtimes declare it via
        get_runtime_shared_memory_ratio)."""
        return None


class run_telemetry(telemetry.timed_span):
    """Span + latency histogram + result counter around one executor
    run — shared by the ssh/local/docker transports so every command the
    control plane issues shows up in the same series."""

    def __init__(self, node_id: str, cmd: str):
        super().__init__("executor.run", ti.EXECUTOR_RUN_SECONDS,
                         node_id=node_id, cmd=cmd[:120])

    def __exit__(self, exc_type, exc, tb) -> bool:
        super().__exit__(exc_type, exc, tb)
        ti.EXECUTOR_RUNS.inc(
            result="ok" if exc_type is None else "failed")
        return False


def _shell_env_prefix(env: Optional[Dict[str, str]]) -> str:
    if not env:
        return ""
    import shlex
    parts = [f"export {k}={shlex.quote(str(v))};" for k, v in env.items()]
    return " ".join(parts) + " "


def _propagation_env(span, env: Optional[Dict[str, str]]
                     ) -> Optional[Dict[str, str]]:
    """The remote half of trace propagation: export the executor.run
    span's traceparent into the command environment, so the child
    process adopts it (telemetry.adopt_traceparent_from_env) and its
    spans join the head-side trace that issued the command.  With
    telemetry disabled `span` is the noop span and the traceparent is
    not exported.

    TIK_COMPILE_CACHE_DIR rides along the same way when the operator
    set it (including an explicit "off"): every worker then shares the
    head's persistent-XLA-cache setting without per-node config."""
    merged = None
    traceparent = getattr(span, "traceparent", None)
    if traceparent is not None:
        merged = dict(env or {})
        merged.setdefault(telemetry.TRACEPARENT_ENV, traceparent)
    cache_dir = os.environ.get(compile_cache.CACHE_DIR_ENV)
    if cache_dir is not None:
        if merged is None:
            merged = dict(env or {})
        merged.setdefault(compile_cache.CACHE_DIR_ENV, cache_dir)
    return env if merged is None else merged
