"""SSH command executor with ControlMaster connection reuse + rsync.

Reference parity: command_executor/ssh_command_executor.py:70 (SSHOptions:25,
SSHCommandExecutor, _run_helper).
"""

from __future__ import annotations

import os
import posixpath
import shlex
import subprocess
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.control.executor.base import (
    CommandError, CommandExecutor, _propagation_env, _shell_env_prefix,
    run_telemetry)
from cloudtik_tpu_torch.faults import seams
from cloudtik_tpu_torch.utils.retry import (
    RetriesExhausted, RetryPolicy, call_with_retry)


class SSHOptions:
    def __init__(self, private_key: Optional[str] = None,
                 control_path: Optional[str] = None,
                 proxy_command: Optional[str] = None,
                 port: int = 22,
                 extra: Optional[Dict[str, str]] = None):
        self.private_key = private_key
        self.control_path = control_path
        self.proxy_command = proxy_command
        self.port = port
        self.options = {
            "StrictHostKeyChecking": "no",
            "UserKnownHostsFile": os.devnull,
            "ConnectTimeout": "10s",
            "ServerAliveInterval": "5",
            "ServerAliveCountMax": "3",
            "LogLevel": "ERROR",
            "IdentitiesOnly": "yes",
            "ExitOnForwardFailure": "yes",
            **(extra or {}),
        }

    def to_ssh_args(self) -> List[str]:
        args = ["-o", "PasswordAuthentication=no"]
        if self.private_key:
            args += ["-i", self.private_key]
        for k, v in self.options.items():
            args += ["-o", f"{k}={v}"]
        if self.control_path:
            args += [
                "-o", f"ControlPath={self.control_path}/%C",
                "-o", "ControlMaster=auto",
                "-o", "ControlPersist=30s",
            ]
        if self.proxy_command:
            args += ["-o", f"ProxyCommand={self.proxy_command}"]
        if self.port != 22:
            args += ["-p", str(self.port)]
        return args


class SSHCommandExecutor(CommandExecutor):
    def __init__(
        self,
        call_context=None,
        log_prefix: str = "",
        node_id: str = "",
        provider=None,
        ssh_user: str = "root",
        ssh_ip: Optional[str] = None,
        ssh_options: Optional[SSHOptions] = None,
        process_runner=None,
    ):
        super().__init__(call_context)
        self.log_prefix = log_prefix
        self.node_id = node_id
        self.provider = provider
        self.ssh_user = ssh_user
        self._ssh_ip = ssh_ip
        self.ssh_options = ssh_options or SSHOptions()
        self.process_runner = process_runner or subprocess

    @property
    def ssh_ip(self) -> str:
        if self._ssh_ip is None:
            self._ssh_ip = self.provider.internal_ip(self.node_id) or \
                self.provider.external_ip(self.node_id)
        return self._ssh_ip

    def _ssh_base(self) -> List[str]:
        return ["ssh", "-tt"] + self.ssh_options.to_ssh_args()

    def run(self, cmd, *, environment_variables=None, with_output=False,
            run_env="auto", timeout=None, shutdown_after_run=False):
        seams.fire("executor.run", node_id=self.node_id, cmd=cmd)
        with run_telemetry(self.node_id, cmd) as span:
            remote_cmd = _shell_env_prefix(
                _propagation_env(span, environment_variables)) + cmd
            if shutdown_after_run:
                remote_cmd += "; sudo shutdown -h now"
            wrapped = _quote("true && source ~/.bashrc && "
                             "export OMP_NUM_THREADS=1 && " + remote_cmd)
            final = self._ssh_base() + [
                f"{self.ssh_user}@{self.ssh_ip}",
                f"bash --login -c -i {wrapped}",
            ]
            try:
                if with_output:
                    out = self.process_runner.check_output(
                        final, stderr=subprocess.STDOUT, timeout=timeout)
                    return out.decode() if isinstance(out, bytes) else out
                self.process_runner.check_call(final, timeout=timeout)
                return None
            except subprocess.CalledProcessError as e:
                raise CommandError(
                    cmd, e.returncode,
                    getattr(e, "output", None) and str(e.output))

    def _rsync_rsh(self) -> str:
        return " ".join(["ssh"] + self.ssh_options.to_ssh_args())

    def run_rsync_up(self, source, target, options=None):
        # First-boot nodes lack the target's parent dirs (e.g. ~/.tik);
        # rsync does not create them, so make them in the same remote call.
        parent = posixpath.dirname(target.rstrip("/"))
        rsync_path = "rsync"
        if parent and parent not in ("/", "~"):
            rsync_path = f"mkdir -p {_remote_path_arg(parent)} && rsync"
        args = ["rsync", "-avz", "--delete",
                "--rsync-path", rsync_path, "-e", self._rsync_rsh(),
                source, f"{self.ssh_user}@{self.ssh_ip}:{target}"]
        self.process_runner.check_call(args)

    def run_rsync_down(self, source, target, options=None):
        args = ["rsync", "-avz", "-e", self._rsync_rsh(),
                f"{self.ssh_user}@{self.ssh_ip}:{source}", target]
        self.process_runner.check_call(args)

    def remote_shell_command_str(self) -> str:
        return " ".join(self._ssh_base() +
                        [f"{self.ssh_user}@{self.ssh_ip}"])

    def wait_ready(self, deadline_s: float, retry_interval: float = 5.0) -> bool:
        """Poll `uptime` over SSH until the node answers or deadline.

        Runs under the tree-wide RetryPolicy: fixed interval (a booting
        node is not a backoff situation — it answers when sshd is up),
        unlimited attempts, bounded by the wall deadline."""
        policy = RetryPolicy(
            max_attempts=0 if deadline_s > 0 else 1,
            base_delay_s=retry_interval,
            multiplier=1.0, jitter=0.0, deadline_s=max(deadline_s, 0.0))

        def probe():
            self.run("uptime", with_output=True, timeout=15)

        try:
            call_with_retry(probe, policy)
            return True
        except RetriesExhausted:
            return False


def _quote(s: str) -> str:
    return shlex.quote(s)


def _remote_path_arg(path: str) -> str:
    """Quote a remote path but leave a leading ~ bare so the remote shell
    expands it (a quoted ~ is a literal directory named '~')."""
    if path == "~":
        return path
    if path.startswith("~/"):
        return "~/" + shlex.quote(path[2:])
    return shlex.quote(path)
