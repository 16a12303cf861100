"""Kubernetes command executor: kubectl exec/cp transport to pods.

Reference parity: core/_private/command_executor/
kubernetes_command_executor.py:27 (`kubectl exec` command wrapping,
`kubectl cp` file sync).  With this, the kubernetes node provider's pods
run the same NodeUpdater bootstrap lifecycle (wait-ready -> file mounts ->
init/setup/start) as SSH-reachable cloud VMs — the round-3 gap where pods
could be created but never bootstrapped.

The process_runner indirection matches the other executors: tests inject a
recorder so the full updater lifecycle runs without a real cluster.
"""

from __future__ import annotations

import shlex
import subprocess
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.control.executor.base import (
    CommandError, CommandExecutor, _shell_env_prefix)


class KubernetesCommandExecutor(CommandExecutor):
    def __init__(
        self,
        call_context=None,
        node_id: str = "",
        namespace: str = "default",
        container: Optional[str] = None,
        process_runner=None,
        log_prefix: str = "",
        kubectl: str = "kubectl",
    ):
        super().__init__(call_context)
        self.node_id = node_id
        self.namespace = namespace
        self.container = container
        self.process_runner = process_runner or subprocess
        self.log_prefix = log_prefix
        self.kubectl = kubectl

    # -- building blocks ---------------------------------------------------
    def _base(self) -> List[str]:
        return [self.kubectl, "-n", self.namespace]

    def _exec_argv(self, interactive: bool = False) -> List[str]:
        argv = self._base() + ["exec"]
        if interactive:
            argv.append("-it")
        argv.append(self.node_id)
        if self.container:
            argv += ["-c", self.container]
        return argv + ["--"]

    # -- CommandExecutor ---------------------------------------------------
    def run(self, cmd, *, environment_variables=None, with_output=False,
            run_env="auto", timeout=None, shutdown_after_run=False):
        shell_cmd = _shell_env_prefix(environment_variables) + cmd
        argv = self._exec_argv() + ["/bin/sh", "-c", shell_cmd]
        try:
            if with_output:
                out = self.process_runner.check_output(
                    argv, stderr=subprocess.STDOUT, timeout=timeout)
                return out.decode() if isinstance(out, bytes) else out
            self.process_runner.check_call(argv, timeout=timeout)
            return None
        except subprocess.CalledProcessError as e:
            raise CommandError(cmd, e.returncode,
                               getattr(e, "output", None) and str(e.output))

    def run_rsync_up(self, source, target, options=None):
        # kubectl cp has no mkdir semantics; ensure the target dir first.
        target_dir = target.rsplit("/", 1)[0] if "/" in target else "."
        self.run(f"mkdir -p {shlex.quote(target_dir)}")
        self.process_runner.check_call(
            self._base() + ["cp", source,
                            f"{self.namespace}/{self.node_id}:{target}"])

    def run_rsync_down(self, source, target, options=None):
        self.process_runner.check_call(
            self._base() + ["cp",
                            f"{self.namespace}/{self.node_id}:{source}",
                            target])

    def remote_shell_command_str(self) -> str:
        return " ".join(self._exec_argv(interactive=True) + ["/bin/sh"])
