"""Active/standby service coordination.

Reference parity: runtime/common/active_standby_service.py — HA runtimes
(postgres, metastore, ...) run on several nodes but exactly one is active;
standbys take over when the active's lease lapses.  Built on LeaderElection.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

from cloudtik_tpu_torch.control.state import StateClient
from cloudtik_tpu_torch.runtimes.common.leader_election import LeaderElection


class ActiveStandbyService:
    """Runs `activate` when this member becomes active and `deactivate`
    when it loses the lease.  `get_active` lets clients find the active
    member's endpoint."""

    def __init__(self, state: StateClient, service_name: str,
                 member_id: str, metadata: Optional[Dict[str, Any]] = None,
                 activate: Optional[Callable[[], None]] = None,
                 deactivate: Optional[Callable[[], None]] = None,
                 ttl_s: float = 15.0):
        self.service_name = service_name
        self._activated = threading.Event()
        self._user_activate = activate
        self._user_deactivate = deactivate
        self.election = LeaderElection(
            state, f"svc/{service_name}", member_id=member_id,
            metadata=metadata or {}, ttl_s=ttl_s,
            on_elected=self._on_elected, on_revoked=self._on_revoked)

    def _on_elected(self):
        self._activated.set()
        if self._user_activate:
            self._user_activate()

    def _on_revoked(self):
        self._activated.clear()
        if self._user_deactivate:
            self._user_deactivate()

    def start(self) -> None:
        self.election.start()

    def stop(self) -> None:
        self.election.resign()

    @property
    def is_active(self) -> bool:
        return self.election.is_leader

    def wait_active(self, timeout_s: Optional[float] = None) -> bool:
        return self._activated.wait(timeout=timeout_s)

    def get_active(self) -> Optional[Dict[str, Any]]:
        return self.election.leader()
