"""Built-in job waiters: tmux/screen session polling + factory.

Reference parity: core/_private/job_waiter/ (session_job_waiter.py
tmux/screen pollers, job_waiter_chain.py:9, job_waiter_factory.py).
`tik submit --job-waiter=tmux` waits for the submitted job's session to
exit before optional cluster stop/teardown (cluster_operator _exec flow,
reference cluster_operator.py:1343-1351).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

from cloudtik_tpu_torch.core.job_waiter import JobWaiter, JobWaiterChain


class SessionJobWaiter(JobWaiter):
    """Polls until the named tmux/screen session disappears.

    `executor_factory(node_id)` returns a CommandExecutor for the node
    (injected by the operator layer so the waiter stays transport-
    agnostic).
    """

    def __init__(self, config: Dict[str, Any],
                 executor_factory: Callable[[str], Any],
                 session_kind: str = "tmux",
                 poll_interval_s: float = 5.0):
        super().__init__(config)
        self.executor_factory = executor_factory
        self.session_kind = session_kind
        self.poll_interval_s = poll_interval_s

    def _session_alive(self, executor, session_name: str) -> bool:
        if self.session_kind == "tmux":
            cmd = f"tmux has-session -t {session_name} 2>/dev/null"
        else:
            cmd = f"screen -ls | grep -q {session_name}"
        try:
            executor.run(cmd, with_output=True)
            return True
        except Exception:
            return False

    def wait_for_completion(self, node_id: str, cmd: str,
                            session_name: str,
                            timeout: Optional[int] = None) -> None:
        executor = self.executor_factory(node_id)
        deadline = None if timeout is None else time.time() + timeout
        while self._session_alive(executor, session_name):
            if deadline is not None and time.time() > deadline:
                raise TimeoutError(
                    f"job session {session_name!r} still running after "
                    f"{timeout}s")
            time.sleep(self.poll_interval_s)


def create_job_waiter(
        name: str, config: Dict[str, Any],
        executor_factory: Callable[[str], Any],
        runtime_waiters: Optional[Dict[str, JobWaiter]] = None
) -> JobWaiter:
    """Factory (reference job_waiter_factory.py): "tmux", "screen",
    a runtime name (its get_job_waiter), or "chain:a,b,c"."""
    runtime_waiters = runtime_waiters or {}
    if name.startswith("chain:"):
        members = [create_job_waiter(n.strip(), config, executor_factory,
                                     runtime_waiters)
                   for n in name[len("chain:"):].split(",") if n.strip()]
        return JobWaiterChain(config, members)
    if name in ("tmux", "screen"):
        return SessionJobWaiter(config, executor_factory,
                                session_kind=name)
    if name in runtime_waiters:
        return runtime_waiters[name]
    raise ValueError(
        f"unknown job waiter {name!r}; known: tmux, screen, chain:..., "
        f"runtimes {sorted(runtime_waiters)}")
