"""Replica registry + SLO-driven replica scaling for the serving fabric.

One `DecodeEngine` per host cannot serve heavy traffic; the fabric is
N engine replicas behind the affinity router (serve/router.py).  This
module is the MEMBERSHIP half: who is serving, are they healthy, and
how many of them should there be.

The registry rides the SAME head-state path every other liveness signal
in the tree uses (control/state.py — the heartbeat table the scaler
health-judges, the slice-membership table the elastic trainer reads):

  * engines **register** on boot with role + capacity
    (``TABLE_SERVE_REPLICAS``) and **beat** periodically, each beat
    carrying the replica's live load stats (queue depth, active slots,
    slot-idle fraction) so the scaling signal needs no extra scrape
    path;
  * a replica is **routable** while its last beat is within
    ``deadline_s``, it is not draining, and it is not condemned; the
    router additionally health-probes and **condemns** a replica after
    consecutive probe failures (a condemned replica needs an explicit
    re-register to serve again — probes failing is a stronger signal
    than a beat arriving);
  * **drain** (SIGTERM) marks the replica not-routable immediately;
    in-flight requests finish, new traffic spills to the ring
    neighbors, and the record ages out after deregister.

:class:`ReplicaAutoscaler` is the `serve_demand` scaling signal: queue
depth and slot-idle fraction come from the beat stats, serve-ttft burn
rates from an injectable burn source (the SloEngine's fast/slow
multi-window gauges in production, a stub in tests).  It adds a
replica on sustained fast+slow burn with a real backlog, removes one
on sustained idle, and asks for a replacement the moment a condemned
or dead replica drops the routable count below target — every decision
WHY-labeled (``serve_demand`` / ``serve_idle`` / ``lost_node``) on a
``scaler.decision`` span and journaled as a durable
``tik_scaler_decision`` event, exactly like the cluster scaler's own
decisions.  `control/scaling_policies.py` wraps it as the
``serve-demand`` scaling policy so the controller's scaler consumes
the asks like any other demand source.

A fleet registering PREFILL/DECODE roles (the role-aware fabric,
serve/fabric.py) scales each role independently: prefill queue depth
and decode slot idleness drive separate targets and separate asks,
each decision carrying its ``role`` — a deep prompt backlog with idle
decode lanes grows the prefill role, never both (the
"scale prefill and decode independently" runbook in
docs/operations.md reads these decisions).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from cloudtik_tpu_torch import telemetry
from cloudtik_tpu_torch.control.state import StateClient, TABLE_SERVE_REPLICAS
from cloudtik_tpu_torch.telemetry import events
from cloudtik_tpu_torch.telemetry import instruments as ti

# A replica is condemned for routing purposes after this many missed
# beat periods.  Deliberately tighter than the cluster scaler's node
# timeout: a falsely-unroutable replica costs a few spilled requests,
# not a recycle.
DEFAULT_BEAT_PERIOD_S = 2.0
DEFAULT_DEADLINE_S = 5 * DEFAULT_BEAT_PERIOD_S

ROLE_ENGINE = "engine"
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"


@dataclasses.dataclass
class ReplicaInfo:
    """One registry record, decoded."""

    replica_id: str
    url: Optional[str]
    role: str
    slots: int
    time: float                       # last beat (epoch)
    draining: bool = False
    condemned: Optional[str] = None   # why, or None
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # deployment version label (rollout groundwork): both request
    # ledgers stamp it so a rollout can prove which version served
    # each request; "0" = unversioned
    version: str = "0"

    @property
    def queue_depth(self) -> float:
        return float(self.stats.get("queue_depth", 0.0))

    @property
    def slot_idle_fraction(self) -> float:
        return float(self.stats.get("slot_idle_fraction", 0.0))


class ReplicaRegistry:
    """Head-state-backed view of the serving replica set."""

    def __init__(self, state_client: StateClient,
                 deadline_s: float = DEFAULT_DEADLINE_S):
        self.state = state_client
        self.deadline_s = float(deadline_s)

    # -- write side (replicas + router) -----------------------------------
    def register(self, replica_id: str, url: Optional[str],
                 role: str = ROLE_ENGINE, slots: int = 0,
                 stats: Optional[Dict[str, Any]] = None,
                 version: str = "0") -> None:
        """Register (or re-register) a replica; clears any condemnation
        — a fresh registration is the operator's 'this one is back'."""
        self.state.table_put(TABLE_SERVE_REPLICAS, replica_id, {
            "replica_id": replica_id, "url": url, "role": role,
            "slots": int(slots), "time": time.time(),
            "draining": False, "condemned": None,
            "stats": dict(stats or {}), "version": str(version)})
        events.emit("tik_serve_replica_registered",
                    replica=replica_id, role=role, slots=int(slots),
                    version=str(version))

    def beat(self, replica_id: str,
             stats: Optional[Dict[str, Any]] = None) -> None:
        """Refresh the replica's liveness stamp + load stats.  A beat
        from an unregistered replica is dropped (registration carries
        the role/capacity the routing decisions need)."""
        record = self.state.table_get(TABLE_SERVE_REPLICAS, replica_id)
        if record is None:
            return
        record["time"] = time.time()
        if stats is not None:
            record["stats"] = dict(stats)
        self.state.table_put(TABLE_SERVE_REPLICAS, replica_id, record)

    def set_draining(self, replica_id: str) -> None:
        """Mark the replica not-routable; in-flight work finishes."""
        record = self.state.table_get(TABLE_SERVE_REPLICAS, replica_id)
        if record is None:
            return
        record["draining"] = True
        record["time"] = time.time()
        self.state.table_put(TABLE_SERVE_REPLICAS, replica_id, record)
        events.emit("tik_serve_replica_drain", replica=replica_id)

    def condemn(self, replica_id: str, reason: str) -> None:
        """Mark the replica dead for routing (probe failures or a
        heartbeat timeout the router chose to make durable)."""
        record = self.state.table_get(TABLE_SERVE_REPLICAS, replica_id)
        if record is None:
            return
        if record.get("condemned"):
            return                      # already condemned; keep the why
        record["condemned"] = reason
        self.state.table_put(TABLE_SERVE_REPLICAS, replica_id, record)
        events.emit("tik_serve_replica_condemned",
                    replica=replica_id, reason=reason)

    def deregister(self, replica_id: str) -> None:
        self.state.table_delete(TABLE_SERVE_REPLICAS, replica_id)

    # -- read side (router + autoscaler) ----------------------------------
    def _decode(self, record: Dict[str, Any]) -> ReplicaInfo:
        return ReplicaInfo(
            replica_id=record.get("replica_id", ""),
            url=record.get("url"),
            role=record.get("role", ROLE_ENGINE),
            slots=int(record.get("slots", 0) or 0),
            time=float(record.get("time", 0.0) or 0.0),
            draining=bool(record.get("draining", False)),
            condemned=record.get("condemned"),
            stats=dict(record.get("stats") or {}),
            version=str(record.get("version", "0") or "0"))

    def list_replicas(self) -> List[ReplicaInfo]:
        return [self._decode(r) for r in
                self.state.table_list(TABLE_SERVE_REPLICAS).values()]

    def alive(self, info: ReplicaInfo,
              now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        return now - info.time <= self.deadline_s

    def routable(self, now: Optional[float] = None,
                 role: Optional[str] = None) -> List[ReplicaInfo]:
        """Replicas traffic may land on: alive, not draining, not
        condemned (sorted by id for deterministic ring builds)."""
        now = time.time() if now is None else now
        out = [info for info in self.list_replicas()
               if self.alive(info, now) and not info.draining
               and info.condemned is None
               and (role is None or info.role == role)]
        return sorted(out, key=lambda i: i.replica_id)


class ReplicaHeartbeat:
    """Background beater: registers once, then beats with live stats.

    ``stats_fn`` returns the replica's load snapshot (e.g.
    ``DecodeEngine.stats()``); exceptions there skip the beat rather
    than kill the thread — one bad snapshot must not age the replica
    out."""

    def __init__(self, registry: ReplicaRegistry, replica_id: str,
                 url: Optional[str], role: str = ROLE_ENGINE,
                 slots: int = 0,
                 stats_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 period_s: float = DEFAULT_BEAT_PERIOD_S,
                 version: str = "0"):
        self.registry = registry
        self.replica_id = replica_id
        self.url = url
        self.role = role
        self.slots = int(slots)
        self.stats_fn = stats_fn
        self.period_s = float(period_s)
        self.version = str(version)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self.registry.register(self.replica_id, self.url, self.role,
                               self.slots,
                               stats=self._snapshot(),
                               version=self.version)
        self._thread = threading.Thread(
            target=self._loop, name=f"tik-replica-beat-{self.replica_id}",
            daemon=True)
        self._thread.start()

    def _snapshot(self) -> Dict[str, Any]:
        if self.stats_fn is None:
            return {}
        try:
            return dict(self.stats_fn())
        except Exception:
            return {}

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.registry.beat(self.replica_id, self._snapshot())
            except Exception:
                continue              # a flapped state write is not death

    def drain(self) -> None:
        """Mark not-routable (the SIGTERM half of graceful drain)."""
        self.registry.set_draining(self.replica_id)

    def stop(self, deregister: bool = False) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if deregister:
            try:
                self.registry.deregister(self.replica_id)
            except Exception:
                pass


# ----------------------------------------------------------- autoscaler --

def slo_burn_source(url: str, slo: str = "serve-ttft",
                    timeout_s: float = 5.0
                    ) -> Callable[[], Optional[Dict[str, float]]]:
    """Burn-rate source over the collector's ``/api/v1/slos`` endpoint
    (the SloEngine's fast/slow multi-window state) — the production
    wiring for the `serve-demand` policy.  Returns None on any fetch
    or parse failure, or while a window has no data: the autoscaler
    HOLDS (no demand add) rather than scaling on a flapped scrape."""
    import urllib.request

    endpoint = url.rstrip("/") + "/api/v1/slos"

    def fetch() -> Optional[Dict[str, float]]:
        try:
            with urllib.request.urlopen(endpoint,
                                        timeout=timeout_s) as resp:
                payload = json.loads(resp.read().decode())
            for state in payload["data"]["slos"]:
                if state.get("name") != slo:
                    continue
                fast = state.get("burn_fast")
                slow = state.get("burn_slow")
                if fast is None or slow is None:
                    return None
                return {"fast": float(fast), "slow": float(slow)}
            return None
        except Exception:
            return None

    return fetch

@dataclasses.dataclass
class AutoscalerConfig:
    min_replicas: int = 1
    max_replicas: int = 8
    # both the fast AND slow serve-ttft burn rates must exceed this for
    # `sustain_cycles` consecutive evaluations before a demand add (the
    # SRE multi-window discipline the SloEngine already applies)
    burn_threshold: float = 1.0
    sustain_cycles: int = 3
    # remove one replica after `idle_cycles` consecutive evaluations
    # with zero queue and mean slot-idle above `idle_slot_fraction`
    idle_cycles: int = 5
    idle_slot_fraction: float = 0.75
    # role-aware fabric scaling (prefill/decode roles registered):
    # sustained burn picks WHICH role to grow from the beat stats.  A
    # prompt backlog at least `prefill_backlog` deep on prefill-role
    # replicas while decode slots still have headroom (mean decode
    # slot-idle above `decode_busy_idle_fraction`) is PREFILL-bound;
    # otherwise the burn is DECODE-bound (a decode-side backlog, or
    # decode lanes saturated).  min/max_replicas bound each role
    # independently — scaling them independently is the point of the
    # split (docs/operations.md runbook).
    prefill_backlog: float = 1.0
    decode_busy_idle_fraction: float = 0.1


class ReplicaAutoscaler:
    """The `serve_demand` scaling signal over the replica registry.

    ``evaluate()`` runs one decision cycle and returns the decision
    dict (or None).  ``ask(delta, reason)`` is the effector — the
    serve-demand scaling policy turns the target into resource
    demands; in-process drills record the asks.  ``burn_source()``
    returns ``{"fast": x, "slow": y}`` serve-ttft burn rates; with no
    burn source demand adds are disabled (backlog alone flaps — a
    queue within the latency budget is not a capacity problem).
    """

    def __init__(self, registry: ReplicaRegistry,
                 ask: Optional[Callable[[int, str], None]] = None,
                 config: Optional[AutoscalerConfig] = None,
                 burn_source: Optional[
                     Callable[[], Optional[Dict[str, float]]]] = None):
        self.registry = registry
        self.ask = ask
        self.config = config or AutoscalerConfig()
        self.burn_source = burn_source
        self.target = self.config.min_replicas
        self._burn_streak = 0
        self._idle_streak = 0
        self._asked_deficit = 0
        # role-aware fabric state (prefill/decode roles registered):
        # one target, streak, and outstanding-deficit slot PER ROLE —
        # the roles scale independently, that is the point of the
        # split.  Empty until the registry shows a role-split fleet.
        self.role_targets: Dict[str, int] = {}
        self._role_burn: Dict[str, int] = {}
        self._role_idle: Dict[str, int] = {}
        self._role_asked: Dict[str, int] = {}

    def total_target(self) -> int:
        """Replicas the fleet should hold in total — the serve-demand
        scaling policy's demand count (sum of role targets in a
        role-split fabric, the single target otherwise)."""
        if self.role_targets:
            return sum(self.role_targets.values())
        return self.target

    def _decide(self, action: str, reason: str,
                role: Optional[str] = None, **attrs) -> Dict[str, Any]:
        """WHY-labeled, journaled, mirrored on a decision span — the
        same triple the cluster scaler's `_decide` emits, so `tik
        events dump` narrates serve scaling next to node scaling.
        Role-aware decisions carry the role in every surface (span,
        journal, returned dict) so a controller drill can launch the
        RIGHT kind of replica."""
        if role is not None:
            attrs = dict(attrs, role=role)
            ti.SERVE_REPLICA_TARGET.set(
                self.role_targets.get(role, 0), role=role)
        else:
            ti.SERVE_REPLICA_TARGET.set(self.target, role=ROLE_ENGINE)
        telemetry.add_span("scaler.decision", time.time(), 0.0,
                           action=action, reason=reason, **attrs)
        events.emit("tik_scaler_decision", action=action,
                    reason=reason, **attrs)
        if self.ask is not None:
            self.ask(1 if action == "add_replica" else -1, reason)
        return {"action": action, "reason": reason, **attrs}

    def evaluate(self, now: Optional[float] = None
                 ) -> Optional[Dict[str, Any]]:
        """One decision cycle; at most one replica added/removed.
        A fleet registering prefill/decode roles takes the role-aware
        path — separate targets, separate asks; a monolithic fleet
        keeps the single-target behavior unchanged."""
        cfg = self.config
        now = time.time() if now is None else now
        if any(info.role in (ROLE_PREFILL, ROLE_DECODE)
               for info in self.registry.list_replicas()):
            return self._evaluate_roles(now)
        routable = self.registry.routable(now)
        n = len(routable)
        ti.SERVE_REPLICA_TARGET.set(self.target, role=ROLE_ENGINE)
        # 1. replacement: a condemned/dead replica dropped the routable
        # count below target — ask NOW, the why is the loss, not
        # demand.  One journaled ask per additional loss: the deficit
        # stays published (the serve-demand policy re-emits the demand
        # every tick until the launch lands) but the flight recorder
        # gets one decision per event, not one per evaluation cycle.
        deficit = self.target - n
        if deficit > 0:
            if deficit > self._asked_deficit:
                self._asked_deficit = deficit
                return self._decide("add_replica", "lost_node",
                                    routable=n, target=self.target)
            return None
        self._asked_deficit = 0
        queue_depth = sum(i.queue_depth for i in routable)
        idle = (sum(i.slot_idle_fraction for i in routable) / n
                if n else 0.0)
        # 2. demand: sustained fast+slow serve-ttft burn with a real
        # backlog behind it (burn without backlog is a latency problem
        # scaling cannot fix; backlog without burn is within budget)
        burn = self.burn_source() if self.burn_source else None
        burning = (burn is not None
                   and burn.get("fast", 0.0) > cfg.burn_threshold
                   and burn.get("slow", 0.0) > cfg.burn_threshold)
        if burning and queue_depth > 0:
            self._burn_streak += 1
        else:
            self._burn_streak = 0
        if self._burn_streak >= cfg.sustain_cycles \
                and self.target < cfg.max_replicas:
            self.target += 1
            self._burn_streak = 0
            return self._decide(
                "add_replica", "serve_demand", target=self.target,
                queue_depth=queue_depth,
                burn_fast=burn.get("fast"), burn_slow=burn.get("slow"))
        # 3. idle: a sustained empty queue with mostly-idle slots —
        # shed one replica, never below the floor
        if queue_depth == 0 and n > 0 \
                and idle >= cfg.idle_slot_fraction:
            self._idle_streak += 1
        else:
            self._idle_streak = 0
        if self._idle_streak >= cfg.idle_cycles \
                and self.target > cfg.min_replicas:
            self.target -= 1
            self._idle_streak = 0
            return self._decide(
                "remove_replica", "serve_idle", target=self.target,
                slot_idle_fraction=round(idle, 4))
        return None

    def _evaluate_roles(self, now: float) -> Optional[Dict[str, Any]]:
        """Role-aware decision cycle: prefill queue depth and decode
        slot idleness drive SEPARATE asks (same WHY vocabulary —
        `lost_node` / `serve_demand` / `serve_idle` — each carrying
        its role).  Monolithic replicas serving alongside a role-split
        fleet are fallback capacity, not a scaling surface here."""
        cfg = self.config
        by_role: Dict[str, List[ReplicaInfo]] = {}
        for info in self.registry.routable(now):
            by_role.setdefault(info.role, []).append(info)
        # a role grows a target only once a replica has ever
        # REGISTERED it (routable or not): seeding an absent role from
        # min_replicas would journal a `lost_node` ask for a replica
        # that never existed — permanently for a deliberately
        # single-role fleet, transiently when one role's replicas
        # simply register before the other's on boot
        registered_roles = {info.role
                            for info in self.registry.list_replicas()}
        for role in (ROLE_PREFILL, ROLE_DECODE):
            if role not in registered_roles \
                    and role not in self.role_targets:
                continue
            n = len(by_role.get(role, []))
            self.role_targets.setdefault(role,
                                         max(n, cfg.min_replicas))
            ti.SERVE_REPLICA_TARGET.set(self.role_targets[role],
                                        role=role)
        # 1. replacement, per role: a condemned/dead replica dropped
        # a role below its target — ask NOW, one journaled ask per
        # additional loss (the monolithic deficit discipline, applied
        # independently to each role)
        standing_deficit = False
        for role in (ROLE_PREFILL, ROLE_DECODE):
            if role not in self.role_targets:
                continue
            n = len(by_role.get(role, []))
            deficit = self.role_targets[role] - n
            if deficit > 0:
                standing_deficit = True
                if deficit > self._role_asked.get(role, 0):
                    self._role_asked[role] = deficit
                    return self._decide(
                        "add_replica", "lost_node", role=role,
                        routable=n, target=self.role_targets[role])
            else:
                self._role_asked[role] = 0
        if standing_deficit:
            # a fleet mid-replacement holds: the monolithic path's
            # `return None` during a deficit, carried over — letting
            # the idle arm run here would let a quiet window shed the
            # very target the lost_node ask is replacing toward
            return None
        prefill = by_role.get(ROLE_PREFILL, [])
        decode = by_role.get(ROLE_DECODE, [])
        prefill_queue = sum(i.queue_depth for i in prefill)
        prefill_idle = (sum(i.slot_idle_fraction for i in prefill)
                        / len(prefill)) if prefill else 0.0
        decode_queue = sum(i.queue_depth for i in decode)
        decode_idle = (sum(i.slot_idle_fraction for i in decode)
                       / len(decode)) if decode else 0.0
        # 2. demand: sustained fast+slow burn, attributed to a role by
        # the beat stats — a deep PROMPT backlog while decode lanes
        # still have headroom is prefill-bound; a decode backlog or
        # saturated decode lanes is decode-bound.  Burn with neither
        # signal holds (scaling the wrong role helps nobody).
        burn = self.burn_source() if self.burn_source else None
        burning = (burn is not None
                   and burn.get("fast", 0.0) > cfg.burn_threshold
                   and burn.get("slow", 0.0) > cfg.burn_threshold)
        bound: Optional[str] = None
        if burning:
            if prefill_queue >= cfg.prefill_backlog \
                    and decode_idle > cfg.decode_busy_idle_fraction:
                bound = ROLE_PREFILL
            elif decode_queue > 0 \
                    or decode_idle <= cfg.decode_busy_idle_fraction:
                bound = ROLE_DECODE
            if bound is not None and bound not in self.role_targets:
                # the attributed role never registered a replica
                # (single-role fleet): there is no target to grow
                bound = None
        for role in (ROLE_PREFILL, ROLE_DECODE):
            self._role_burn[role] = (self._role_burn.get(role, 0) + 1
                                     if bound == role else 0)
        if bound is not None \
                and self._role_burn[bound] >= cfg.sustain_cycles \
                and self.role_targets[bound] < cfg.max_replicas:
            self.role_targets[bound] += 1
            self._role_burn[bound] = 0
            return self._decide(
                "add_replica", "serve_demand", role=bound,
                target=self.role_targets[bound],
                queue_depth=(prefill_queue if bound == ROLE_PREFILL
                             else decode_queue),
                slot_idle_fraction=round(
                    prefill_idle if bound == ROLE_PREFILL
                    else decode_idle, 4),
                burn_fast=burn.get("fast"), burn_slow=burn.get("slow"))
        # 3. idle, per role: a sustained empty queue with mostly-idle
        # lanes sheds one replica of THAT role, never below the floor
        for role, queue, idle in (
                (ROLE_PREFILL, prefill_queue, prefill_idle),
                (ROLE_DECODE, decode_queue, decode_idle)):
            n = len(by_role.get(role, []))
            if queue == 0 and n > 0 and idle >= cfg.idle_slot_fraction:
                self._role_idle[role] = self._role_idle.get(role, 0) + 1
            else:
                self._role_idle[role] = 0
            if self._role_idle[role] >= cfg.idle_cycles \
                    and self.role_targets[role] > cfg.min_replicas:
                self.role_targets[role] -= 1
                self._role_idle[role] = 0
                return self._decide(
                    "remove_replica", "serve_idle", role=role,
                    target=self.role_targets[role],
                    slot_idle_fraction=round(idle, 4))
        return None
