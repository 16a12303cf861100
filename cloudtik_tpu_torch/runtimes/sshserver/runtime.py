"""SSH server runtime: in-container sshd for the virtual provider.

Reference parity: runtime/sshserver (SURVEY.md §2.3 — sshd inside
containers so the control plane can reach virtual nodes over real SSH).
"""

from __future__ import annotations

import os
import subprocess
from typing import Any, Dict, List, Optional, Tuple

from cloudtik_tpu_torch.core.runtime import Runtime


class SSHServerRuntime(Runtime):
    def node_configure(self, node_context: Dict[str, Any]) -> None:
        port = self.runtime_config.get("port", 22022)
        conf_dir = os.path.expanduser("~/.tik/sshserver")
        os.makedirs(conf_dir, exist_ok=True)
        host_key = os.path.join(conf_dir, "host_key")
        if not os.path.exists(host_key):
            subprocess.call(["ssh-keygen", "-q", "-t", "ed25519", "-N", "",
                             "-f", host_key])
        with open(os.path.join(conf_dir, "sshd_config"), "w") as f:
            f.write(f"""Port {port}
HostKey {host_key}
PidFile {conf_dir}/sshd.pid
PasswordAuthentication no
PubkeyAuthentication yes
AuthorizedKeysFile {conf_dir}/authorized_keys
StrictModes no
""")

    def node_services(self, node_context: Dict[str, Any], command: str) -> None:
        conf_dir = os.path.expanduser("~/.tik/sshserver")
        pid_file = os.path.join(conf_dir, "sshd.pid")
        if command == "start":
            sshd = "/usr/sbin/sshd"
            if os.path.exists(sshd):
                subprocess.call([sshd, "-f",
                                 os.path.join(conf_dir, "sshd_config")])
        elif command == "stop" and os.path.exists(pid_file):
            try:
                with open(pid_file) as f:
                    os.kill(int(f.read().strip()), 15)
            except (OSError, ValueError):
                pass

    def get_processes(self) -> Optional[List[Tuple[str, bool, str, str]]]:
        return [("sshd", False, "SSHServer", "node")]
