"""Local command executor: runs on this host (head-local ops, virtual nodes).

Reference parity: command_executor/local_command_executor.py:23.  The
process_runner indirection exists so tests can record commands instead of
executing them (reference test harness MockProcessRunner,
tests/unit/test_cloudtik.py:91).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Any, Dict, Optional

from cloudtik_tpu_torch.control.executor.base import (
    CommandError, CommandExecutor, _propagation_env, _shell_env_prefix,
    run_telemetry)
from cloudtik_tpu_torch.faults import seams


class LocalCommandExecutor(CommandExecutor):
    def __init__(self, call_context=None, process_runner=None,
                 log_prefix: str = "", node_id: str = ""):
        super().__init__(call_context)
        self.process_runner = process_runner or subprocess
        self.log_prefix = log_prefix
        self.node_id = node_id

    def run(self, cmd, *, environment_variables=None, with_output=False,
            run_env="auto", timeout=None, shutdown_after_run=False):
        # bare node_id, same as the SSH executor fires — fault-plan
        # match filters must behave identically on local/virtual drills
        seams.fire("executor.run", node_id=self.node_id, cmd=cmd)
        with run_telemetry(self.node_id, cmd) as span:
            full_cmd = _shell_env_prefix(
                _propagation_env(span, environment_variables)) + cmd
            if not with_output and self.process_runner is subprocess:
                # real execution path: stream per-line with the node
                # prefix while keeping a bounded tail for the failure
                # report (reference subprocess_output_util.py:392)
                from cloudtik_tpu_torch.utils.subprocess_output import (
                    run_with_streaming_output)
                rc, tail = run_with_streaming_output(
                    full_cmd, prefix=self.log_prefix, timeout=timeout)
                if rc != 0:
                    raise CommandError(cmd, rc, tail)
                return None
            try:
                if with_output:
                    out = self.process_runner.check_output(
                        full_cmd, shell=True, stderr=subprocess.STDOUT,
                        timeout=timeout)
                    return out.decode() if isinstance(out, bytes) else out
                self.process_runner.check_call(
                    full_cmd, shell=True, timeout=timeout)
                return None
            except subprocess.CalledProcessError as e:
                raise CommandError(
                    cmd, e.returncode,
                    getattr(e, "output", None) and str(e.output))

    def _copy(self, source: str, target: str) -> None:
        target_dir = os.path.dirname(target)
        if target_dir:
            os.makedirs(target_dir, exist_ok=True)
        if os.path.isdir(source):
            shutil.copytree(source, target, dirs_exist_ok=True)
        else:
            shutil.copy2(source, target)

    def run_rsync_up(self, source, target, options=None):
        if shutil.which("rsync"):
            self.run(f"mkdir -p {os.path.dirname(target) or '.'} && "
                     f"rsync -a {source} {target}")
        else:
            self._copy(os.path.expanduser(source), os.path.expanduser(target))

    def run_rsync_down(self, source, target, options=None):
        self.run_rsync_up(source, target, options)

    def remote_shell_command_str(self) -> str:
        return os.environ.get("SHELL", "/bin/bash")
