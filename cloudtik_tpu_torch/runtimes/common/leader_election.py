"""Leader election over the state-store lock lease.

Reference parity: runtime/common/leader_election/
(consul_leader_election.py — session-based leadership with a key holding the
leader's identity).  Used by HA runtimes (postgres primary, HDFS NN,
active/standby services) to pick exactly one active member.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Any, Callable, Dict, Optional

from cloudtik_tpu_torch.control.state import StateClient
from cloudtik_tpu_torch.runtimes.common.lock import (
    LOCK_NS, StateLock, _decode, default_owner_id)

logger = logging.getLogger(__name__)

ELECTION_NS = "elections"


class LeaderElection:
    """Campaign for leadership of `name`; hold while the lease renews.

    on_elected / on_revoked callbacks fire from the campaign thread.  The
    leader's advertised metadata (ip, port, ...) is published alongside the
    lease so followers can find the active member.
    """

    def __init__(self, state: StateClient, name: str,
                 member_id: Optional[str] = None,
                 metadata: Optional[Dict[str, Any]] = None,
                 ttl_s: float = 15.0,
                 on_elected: Optional[Callable[[], None]] = None,
                 on_revoked: Optional[Callable[[], None]] = None):
        self.state = state
        self.name = name
        self.member_id = member_id or default_owner_id()
        self.metadata = metadata or {}
        self.on_elected = on_elected
        self.on_revoked = on_revoked
        self._lock = StateLock(state, f"election/{name}", ttl_s=ttl_s,
                               owner_id=self.member_id)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._is_leader = False

    # -- queries ----------------------------------------------------------
    @property
    def is_leader(self) -> bool:
        return self._is_leader and self._lock.held()

    def leader(self) -> Optional[Dict[str, Any]]:
        """Current leader's identity + metadata, or None."""
        info = _decode(self.state.backend.get(
            LOCK_NS, f"election/{self.name}"))
        if info is None or info.get("expires", 0) < time.time():
            return None
        raw = self.state.kv_get(f"{self.name}:{info['owner']}",
                                ns=ELECTION_NS)
        meta = json.loads(raw.decode()) if raw else {}
        return {"member_id": info["owner"], **meta}

    # -- campaign ---------------------------------------------------------
    def start(self, poll_s: float = 0.5) -> None:
        self.state.kv_put(f"{self.name}:{self.member_id}",
                          json.dumps(self.metadata).encode(),
                          ns=ELECTION_NS)

        def _campaign():
            while not self._stop.is_set():
                if not self._is_leader:
                    if self._lock.try_acquire():
                        self._lock._start_renewer()
                        self._is_leader = True
                        if self.on_elected:
                            try:
                                self.on_elected()
                            except Exception:
                                # failed activation: give up leadership so
                                # a standby can take over (a raised
                                # callback must never leave a dead member
                                # renewing the lease)
                                logger.exception(
                                    "on_elected failed for %s; "
                                    "resigning", self.name)
                                self._is_leader = False
                                self._lock.release()
                else:
                    if not self._lock.held():
                        self._is_leader = False
                        if self.on_revoked:
                            try:
                                self.on_revoked()
                            except Exception:
                                logger.exception(
                                    "on_revoked failed for %s", self.name)
                self._stop.wait(poll_s)

        self._thread = threading.Thread(
            target=_campaign, name=f"tik-election-{self.name}", daemon=True)
        self._thread.start()

    def resign(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._is_leader:
            self._is_leader = False
            self._lock.release()
            if self.on_revoked:
                self.on_revoked()
        self.state.kv_delete(f"{self.name}:{self.member_id}",
                             ns=ELECTION_NS)
