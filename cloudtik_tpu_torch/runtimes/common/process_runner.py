"""Service process management: spawn/stop/track long-running services.

Reference parity: each reference runtime's `scripts/services.sh` started
daemons with nohup + pidfiles and the node agent scanned psutil for them
(SURVEY.md §2.3).  Here the same contract is a library: detached spawn with
pidfile + log capture, port-wait with log-tail diagnostics, and
SIGTERM→SIGKILL stop.  A failed service start RAISES (round-1 review: a
failed `subprocess.call` was indistinguishable from success).
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import time
from typing import Dict, List, Optional

from cloudtik_tpu_torch.utils.constants import tik_home


class ServiceStartError(RuntimeError):
    pass


def service_dir(name: str) -> str:
    path = os.path.join(tik_home(), "services", name)
    os.makedirs(path, exist_ok=True)
    return path


def _pidfile(name: str) -> str:
    return os.path.join(service_dir(name), "service.pid")


def _logfile(name: str) -> str:
    return os.path.join(service_dir(name), "service.log")


def read_pid(name: str) -> Optional[int]:
    try:
        with open(_pidfile(name)) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    # signal 0 also succeeds for a ZOMBIE — a dead child whose parent
    # (us, when the stopper spawned the service) has not reaped it yet.
    # Without this check stop_service waits its full SIGTERM->SIGKILL
    # timeout on a process that is already gone.
    try:
        with open(f"/proc/{pid}/stat") as f:
            # field 3 (after the parenthesized comm, which may itself
            # contain spaces) is the state letter
            if f.read().rsplit(")", 1)[-1].split()[0] == "Z":
                try:
                    os.waitpid(pid, os.WNOHANG)   # reap if it is ours
                except (ChildProcessError, OSError):
                    pass
                return False
    except (OSError, IndexError):
        pass  # no /proc (non-Linux): keep the signal-0 answer
    return True


def service_running(name: str) -> bool:
    pid = read_pid(name)
    return pid is not None and pid_alive(pid)


def tail_log(name: str, max_bytes: int = 2000) -> str:
    try:
        with open(_logfile(name), "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - max_bytes))
            return f.read().decode(errors="replace")
    except OSError:
        return "<no log>"


def spawn_service(
    name: str,
    cmd: List[str],
    env: Optional[Dict[str, str]] = None,
    cwd: Optional[str] = None,
) -> int:
    """Start `cmd` detached with pidfile + log; idempotent if running."""
    if service_running(name):
        return read_pid(name)  # type: ignore[return-value]
    full_env = dict(os.environ)
    if env:
        full_env.update({k: str(v) for k, v in env.items()})
    log = open(_logfile(name), "ab")
    try:
        # NOTE: no fate-sharing here — runtime services are spawned by
        # short-lived CLI invocations (`tik runtime services start`) and
        # must outlive them; PDEATHSIG belongs only on children of the
        # long-lived node-services process (native state server/sampler)
        proc = subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, cwd=cwd,
            env=full_env, start_new_session=True)
    except OSError as e:
        raise ServiceStartError(f"{name}: cannot exec {cmd[0]!r}: {e}")
    finally:
        log.close()
    with open(_pidfile(name), "w") as f:
        f.write(str(proc.pid))
    return proc.pid


def stop_service(name: str, timeout_s: float = 10.0) -> bool:
    """SIGTERM the service's process group, escalate to SIGKILL."""
    pid = read_pid(name)
    if pid is None or not pid_alive(pid):
        return False
    try:
        os.killpg(os.getpgid(pid), signal.SIGTERM)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            os.kill(pid, signal.SIGTERM)
        except ProcessLookupError:
            return False
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if not pid_alive(pid):
            break
        time.sleep(0.2)
    if pid_alive(pid):
        try:
            os.killpg(os.getpgid(pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError, OSError):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    try:
        os.unlink(_pidfile(name))
    except OSError:
        pass
    return True


def port_open(host: str, port: int, timeout_s: float = 1.0) -> bool:
    try:
        with socket.create_connection((host, port), timeout=timeout_s):
            return True
    except OSError:
        return False


def wait_for_port(
    name: str,
    port: int,
    host: str = "127.0.0.1",
    timeout_s: float = 30.0,
) -> None:
    """Wait for the service to accept TCP; raise with log tail if it dies
    or never listens."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if port_open(host, port):
            return
        if not service_running(name):
            raise ServiceStartError(
                f"{name}: process exited before listening on :{port}\n"
                f"--- log tail ---\n{tail_log(name)}")
        time.sleep(0.3)
    raise ServiceStartError(
        f"{name}: not listening on {host}:{port} after {timeout_s}s\n"
        f"--- log tail ---\n{tail_log(name)}")
