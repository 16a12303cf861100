"""Database failover: active-standby promotion for replicated runtimes.

Reference parity: runtime/{postgres,redis,mysql} HA — the reference
elects a primary through consul/etcd locks and promotes a replica when
the lease lapses (leader_election/ + active_standby_service.py).  Here
the same roles ride the head state store's leases
(`runtimes/common/leader_election.py`):

* Every DB node campaigns for `<service>-primary`.
* The node that starts as the primary (the head, per each runtime's
  config render) wins the initial election and simply advertises itself.
* When its lease lapses (process death, node loss), a replica's campaign
  succeeds; the daemon runs the runtime-supplied `promote` action
  (pg_ctl promote / REPLICAOF NO ONE / ...) exactly once and re-points
  the discovery registry's `<service>` primary record at itself, so
  pgpool/haproxy/clients following discovery fail over with it.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Dict, Optional

from cloudtik_tpu_torch.runtimes.common.active_standby import ActiveStandbyService

logger = logging.getLogger(__name__)


class DBFailoverDaemon:
    """Campaigns for the primary role; promotes on takeover.

    promote: zero-arg callable executing the engine-specific promotion.
    It runs at most once, and never on the member that started as the
    primary (it is already writable)."""

    def __init__(self, state, service_name: str, member_id: str,
                 node_ip: str, port: int,
                 promote: Callable[[], None],
                 *, initially_primary: bool = False,
                 cluster_name: str = "", workspace_name: str = "",
                 ttl_s: float = 15.0,
                 follow: Optional[Callable[[Dict[str, Any]], None]] = None,
                 follow_poll_s: float = 1.0):
        """`follow(primary_meta)` (optional) is the replica-side half of a
        failover: invoked whenever the elected primary CHANGES to another
        member, so replicas re-point their replication stream (mysql
        CHANGE REPLICATION SOURCE / redis REPLICAOF / postgres
        primary_conninfo) at the new primary instead of replicating from
        a corpse.  Called once per distinct primary; must be idempotent
        (it also fires for the boot primary the member already follows)."""
        self.service_name = service_name
        self.member_id = member_id
        self.node_ip = node_ip
        self.port = port
        self._promote = promote
        self._needs_promote = not initially_primary
        self._promote_lock = threading.Lock()
        self._state = state
        self._cluster_name = cluster_name
        self._workspace_name = workspace_name
        self._follow = follow
        self._follow_poll_s = follow_poll_s
        self._followed: Optional[str] = None
        self._follow_stop = threading.Event()
        self.service = ActiveStandbyService(
            state, f"{service_name}-primary", member_id,
            metadata={"ip": node_ip, "port": port},
            activate=self._on_active, ttl_s=ttl_s)

    def _on_active(self) -> None:
        with self._promote_lock:
            if self._needs_promote:
                logger.warning(
                    "%s: promoting %s to primary", self.service_name,
                    self.member_id)
                self._promote()
                self._needs_promote = False
        self._advertise()

    def _advertise(self) -> None:
        try:
            from cloudtik_tpu_torch.runtimes.discovery.runtime import (
                ServiceRegistry)
            registry = ServiceRegistry(
                self._state, self._cluster_name, self._workspace_name)
            registry.register(
                self.service_name, self.member_id, self.node_ip,
                self.port, tags={"role": "primary"})
        except Exception:
            logger.exception("%s: primary advertisement failed",
                             self.service_name)

    def start(self, poll_s: float = 0.5) -> None:
        self.service.election.start(poll_s=poll_s)
        if self._follow is not None:
            threading.Thread(
                target=self._follow_loop,
                name=f"tik-{self.service_name}-follow",
                daemon=True).start()

    def _follow_loop(self) -> None:
        while not self._follow_stop.wait(self._follow_poll_s):
            try:
                active = self.current_primary()
                if not active:
                    continue
                mid = active.get("member_id")
                if mid == self.member_id:
                    # we are (or just became) the primary: nothing to
                    # follow, but remember it so losing the lease to a
                    # NEW primary later still triggers follow
                    self._followed = mid
                    continue
                if mid != self._followed:
                    self._follow(dict(active))
                    self._followed = mid
            except Exception:
                logger.exception("%s: follow re-point failed",
                                 self.service_name)

    def stop(self) -> None:
        self._follow_stop.set()
        self.service.stop()

    @property
    def is_primary(self) -> bool:
        return self.service.is_active

    def current_primary(self) -> Optional[Dict[str, Any]]:
        return self.service.get_active()


def read_primary(state, service_name: str) -> Optional[Dict[str, Any]]:
    """Current <service>-primary lease holder ({"member_id", "ip",
    "port"}) WITHOUT campaigning — the observer read pools/gateways use."""
    from cloudtik_tpu_torch.runtimes.common.leader_election import LeaderElection
    return LeaderElection(state, f"svc/{service_name}-primary",
                          member_id="__observer__").leader()


class PrimaryChangeWatcher:
    """Observe a service's primary lease; call `on_change(meta)` whenever
    the holder changes (including on first observation — the callback
    must be an idempotent re-render).  This is how pools and gateways
    that sit IN FRONT of a replicated DB (pgpool, pgbouncer) follow a
    failover without being election members themselves."""

    def __init__(self, state, service_name: str,
                 on_change: Callable[[Dict[str, Any]], None],
                 *, poll_s: float = 1.0):
        self.service_name = service_name
        self._state = state
        self._on_change = on_change
        self._poll_s = poll_s
        self._stop = threading.Event()
        self._seen: Optional[str] = None

    def poll_once(self) -> None:
        primary = read_primary(self._state, self.service_name)
        if not primary:
            return
        key = f"{primary.get('ip')}:{primary.get('port')}"
        if key == self._seen:
            return
        self._on_change(dict(primary))
        self._seen = key

    def _loop(self) -> None:
        while not self._stop.wait(self._poll_s):
            try:
                self.poll_once()
            except Exception:
                logger.exception("%s: primary-change follow failed",
                                 self.service_name)

    def start(self) -> None:
        threading.Thread(target=self._loop, daemon=True,
                         name=f"tik-{self.service_name}-pwatch").start()

    def stop(self) -> None:
        self._stop.set()


class PrimaryWatchDaemon:
    """For engines with NATIVE elections (mongodb replica sets): the
    engine picks its own primary, so there is nothing to promote — the
    cluster's job is to keep the discovery registry's primary record
    pointed at whatever the engine elected.  Polls `get_primary()` (an
    engine-specific callable returning {"ip", "port", "member_id"} or
    None) and re-registers on change."""

    def __init__(self, state, service_name: str,
                 get_primary: Callable[[], Optional[Dict[str, Any]]],
                 *, cluster_name: str = "", workspace_name: str = "",
                 poll_s: float = 2.0):
        self.service_name = service_name
        self._get_primary = get_primary
        self._state = state
        self._cluster_name = cluster_name
        self._workspace_name = workspace_name
        self._poll_s = poll_s
        self._stop = threading.Event()
        self._advertised: Optional[str] = None

    def poll_once(self) -> None:
        primary = self._get_primary()
        if not primary:
            return
        key = f"{primary.get('ip')}:{primary.get('port')}"
        if key == self._advertised:
            return
        from cloudtik_tpu_torch.runtimes.discovery.runtime import ServiceRegistry
        registry = ServiceRegistry(
            self._state, self._cluster_name, self._workspace_name)
        registry.register(
            self.service_name,
            str(primary.get("member_id") or primary.get("ip", "")),
            str(primary.get("ip", "")), int(primary.get("port", 0)),
            tags={"role": "primary"})
        logger.info("%s: primary now %s", self.service_name, key)
        self._advertised = key

    def _loop(self) -> None:
        while not self._stop.wait(self._poll_s):
            try:
                self.poll_once()
            except Exception:
                logger.exception("%s: primary watch failed",
                                 self.service_name)

    def start(self) -> None:
        threading.Thread(target=self._loop, daemon=True,
                         name=f"tik-{self.service_name}-watch").start()

    def stop(self) -> None:
        self._stop.set()


def spawn_db_failover(
        runtime, node_context: Dict[str, Any],
        promote: Callable[[], None],
        *, ttl_s: float = 15.0,
        follow: Optional[Callable[[Dict[str, Any]], None]] = None,
) -> Optional[DBFailoverDaemon]:
    """Shared post-start wiring for DB runtimes: start the daemon when a
    state client is present and `failover` isn't disabled in the
    runtime's config.  Returns the daemon (kept on the runtime so stop
    can resign)."""
    state = node_context.get("state_client")
    if state is None or not runtime.runtime_config.get("failover", True):
        return None
    config = node_context.get("config", {})
    daemon = DBFailoverDaemon(
        state, runtime.SERVICE_NAME,
        node_context.get("node_id", "") or "node",
        node_context.get("node_ip") or node_context.get("head_ip", ""),
        runtime.port, promote,
        initially_primary=bool(node_context.get("is_head")),
        cluster_name=config.get("cluster_name", ""),
        workspace_name=config.get("workspace_name", ""),
        ttl_s=float(runtime.runtime_config.get("failover_ttl_s", ttl_s)),
        follow=follow)
    daemon.start()
    return daemon
