"""JobWaiter — pluggable job-completion waiting.

Reference parity: core/job_waiter.py:10, chain impl
core/_private/job_waiter/job_waiter_chain.py:9, session waiter
session_job_waiter.py.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class JobWaiter:
    def __init__(self, config: Dict[str, Any]):
        self.config = config

    def wait_for_completion(
        self, node_id: str, cmd: str, session_name: str, timeout: Optional[int] = None
    ) -> None:
        raise NotImplementedError


class JobWaiterChain(JobWaiter):
    """Waits on every waiter in the chain, in order."""

    def __init__(self, config: Dict[str, Any], waiters: List[JobWaiter]):
        super().__init__(config)
        self.waiters = waiters

    def wait_for_completion(
        self, node_id: str, cmd: str, session_name: str, timeout: Optional[int] = None
    ) -> None:
        for waiter in self.waiters:
            waiter.wait_for_completion(node_id, cmd, session_name, timeout)
