"""Role-aware serving fabric: cross-replica disaggregated
prefill/decode over the socket KV transport.

PRs 11-12 built both halves separately — per-host disaggregated
prefill/decode with a real socket transport (serve/migration.py,
DistServe OSDI'24 / Splitwise ISCA'24 lineage) and the prefix-affinity
router with replica registry and failover (serve/router.py,
serve/replicas.py).  This module is the join: replica ROLES become
routable surfaces, so one fabric spreads prompt-heavy work over
dedicated prefill replicas and streams finished KV state to the
decode replica the affinity hash already warms.

  * :class:`PrefillReplica` fronts a prefill-role `DecodeEngine`
    (``migrator=FabricMigrator(...)``).  ``forward_to(payload, decode,
    ...)`` runs chunked prefill and, at prompt completion, exports the
    request's KV blocks over a fresh :class:`SocketKVTransport` to the
    decode replica the ROUTER chose (the adapter-salted prefix-affinity
    hash — shared prompts land where their blocks already live).
  * :class:`DecodeReplica` is an :class:`EngineReplica` that also runs
    a :class:`MigrationReceiver`: migrated streams construct a Request
    FROM THE HEADER and decode locally; a fabric ticket (keyed by the
    header's origin request id) hands the completed output back to the
    waiting prefill forward, so the router's synchronous `handle()`
    surface is unchanged.  Decode replicas keep full prefill
    capability: decode-heavy traffic forwards to them directly, and a
    torn migration degrades to a plain re-prefill submit here.
  * :class:`FabricMigrator` is the per-request routing migrator: each
    export opens a fresh socket transport to the request's stamped
    decode target (``request.fabric``), so ONE prefill engine feeds N
    decode replicas.  ``frame_delay_s`` forwards the DCN-emulation
    knob to every transport it builds — the CPU bench pays an honest
    per-frame wire cost.

Failure discipline (the part that makes this deployable):

  * a fault mid-export (``serve.kvcache.migrate`` seam, connect
    refusal, send timeout) tears the transfer; the receiver drops the
    partial stream whole and the engine-level fallback re-submits the
    request as a plain prefill on the SAME decode replica — the
    router never sees it, never double-routes, and the request costs
    recompute, never loss (``tik_serve_fabric_requests_total
    {path="fallback"}`` counts the degrade);
  * a prefill replica dying BEFORE the handoff surfaces
    connection-shaped to the router, whose unified retry policy
    re-runs idempotent work on the plain decode/monolithic path —
    the fabric loses a role, not a request;
  * a prefill replica dying AFTER a committed export changes nothing:
    the decode side owns the request and the ticket still resolves.

Greedy output through prefill-role -> socket migration -> decode-role
is bit-identical to a monolithic replica (tests/test_fabric.py),
including prefix-reused and adapter-bearing prompts.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, Optional

from cloudtik_tpu_torch import telemetry
from cloudtik_tpu_torch.serve import migration
from cloudtik_tpu_torch.serve.router import (
    EngineReplica, ReplicaClient, ReplicaDraining,
    ReplicaUnavailable, raise_replica_error)
from cloudtik_tpu_torch.telemetry import instruments as ti

logger = logging.getLogger(__name__)

# how often a waiting prefill forward re-checks its prefill-side
# request for an early failure; the happy path never polls (the ticket
# event fires the moment the decode side completes)
_TICKET_POLL_S = 0.02


class FabricHandoff:
    """Per-request routing state the prefill engine's migrator reads:
    where to stream this request's KV blocks, and what to do when the
    stream tears.  ``exported`` flips once the commit frame is sent —
    past that point the decode side owns the request and a dying
    prefill replica must NOT fail it."""

    def __init__(self, host: str, port: int,
                 fallback: Optional[Callable[[Any], None]] = None):
        self.host = host
        self.port = int(port)
        self.fallback = fallback
        self.exported = False


class FabricMigrator(migration.BlockMigrator):
    """Routing :class:`BlockMigrator`: a fresh socket transport per
    export, targeted by the request's stamped :class:`FabricHandoff`.

    The base class's single-transport shape fits a pinned pair
    (serve/disagg.py); a fabric prefill engine feeds WHICHEVER decode
    replica the router chose per request, and a torn transport is
    never reused — so each export builds, uses, and closes its own
    :class:`SocketKVTransport`.  Fallback routing is per-request too:
    the handoff's fallback (a plain re-prefill submit on the chosen
    decode replica) owns the torn-stream degrade.

    ``async_send`` (the default) overlaps the wire with the next
    prompt's prefill: the engine hands over HOST copies of the planes,
    so the sender thread owns the stream and the engine loop frees the
    lane immediately instead of sleeping through the DCN round trip —
    the DistServe transfer-overlap discipline.  Consequences, both
    deliberate: ``tik_serve_kv_migrations_total{direction="out"}``
    counts exports DISPATCHED (the engine's accounting point), and a
    tear surfaces on the sender thread, which runs the request-side
    half of the degrade itself (failure metric + journal event + stamp
    reset + the handoff fallback) — the engine's slot state was
    already clean when the send began, so no engine state is touched
    from this thread."""

    def __init__(self, connect_timeout_s: float = 5.0,
                 send_timeout_s: float = 10.0,
                 frame_delay_s: float = 0.0,
                 async_send: bool = True):
        super().__init__(transport=migration.KVTransport(),
                         fallback=self._route_fallback)
        self.connect_timeout_s = float(connect_timeout_s)
        self.send_timeout_s = float(send_timeout_s)
        self.frame_delay_s = float(frame_delay_s)
        self.async_send = bool(async_send)

    @staticmethod
    def _handoff(request) -> FabricHandoff:
        handoff = getattr(request, "fabric", None)
        if handoff is None:
            raise migration.MigrationError(
                f"request {request.request_id} reached a fabric "
                "prefill engine with no decode handoff stamped — "
                "route it through the role-aware router")
        return handoff

    def _route_fallback(self, request) -> None:
        self._handoff(request).fallback(request)

    def export(self, request, **kw) -> None:
        handoff = self._handoff(request)
        if not self.async_send:
            self._send(request, handoff, kw)
            return
        threading.Thread(
            target=self._send_owning_degrade,
            args=(request, handoff, kw),
            daemon=True, name="tik-fabric-export").start()

    def _send(self, request, handoff: FabricHandoff,
              kw: Dict[str, Any]) -> None:
        t0 = time.perf_counter()
        transport = migration.SocketKVTransport(
            handoff.host, handoff.port,
            connect_timeout_s=self.connect_timeout_s,
            send_timeout_s=self.send_timeout_s,
            frame_delay_s=self.frame_delay_s)
        try:
            migration.BlockMigrator(transport).export(request, **kw)
            handoff.exported = True
            ti.SERVE_FABRIC_HANDOFF_SECONDS.observe(
                time.perf_counter() - t0)
        finally:
            transport.close()

    def _send_owning_degrade(self, request, handoff: FabricHandoff,
                             kw: Dict[str, Any]) -> None:
        """Async sender body: on a tear, run the degrade the engine
        would have run inline (serve/engine._migrate_out's failure
        arm), minus the slot release the engine already did."""
        from cloudtik_tpu_torch.faults.plan import FaultInjected
        from cloudtik_tpu_torch.telemetry import events
        try:
            self._send(request, handoff, kw)
        except (FaultInjected, migration.MigrationError, OSError) as e:
            ti.SERVE_KV_MIGRATION_FAILURES.inc()
            with telemetry.trace_context(request.traceparent):
                events.emit("tik_serve_migration",
                            request=request.request_id,
                            direction="out", result="failed",
                            tokens=int(kw.get("length", 0)),
                            error=str(e))
            request.admitted = None
            request.admitted_mono = None
            try:
                handoff.fallback(request)
            except Exception:
                logger.exception(
                    "fabric export fallback failed for request %s",
                    request.request_id)
        except Exception:
            logger.exception("fabric export failed unexpectedly for "
                             "request %s", request.request_id)


class _Ticket:
    """One in-flight fabric handoff: the prefill forward blocks on
    ``event``; whichever side completes the request (migration import,
    fallback re-prefill, or a failure) resolves it exactly once."""

    def __init__(self):
        self.event = threading.Event()
        self.request: Any = None
        self.error: Optional[BaseException] = None

    def resolve(self, request) -> None:
        self.request = request
        self.event.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self.event.set()


class DecodeReplica(EngineReplica):
    """Decode-role replica: an in-process :class:`EngineReplica` plus
    the socket :class:`MigrationReceiver` that lets prefill replicas
    stream KV state into its pool.

    Plain forwards work unchanged (decode replicas keep full prefill
    capability — decode-heavy traffic and fabric fallbacks both land
    here); migrated-in requests resolve the fabric ticket registered
    under their origin request id when they finish."""

    def __init__(self, replica_id: str, engine,
                 host: str = "127.0.0.1"):
        super().__init__(replica_id, engine)
        self._tickets: Dict[int, _Ticket] = {}
        self._ticket_lock = threading.Lock()
        self._closed = False
        self.receiver = migration.MigrationReceiver(
            engine, host=host, on_finish=self._migrated_finished)
        self.receiver.start()
        self.migration_host = host
        self.migration_port = self.receiver.port

    # -- fabric ticket surface (PrefillReplica calls these) ---------------
    def expect(self, origin_id: int) -> _Ticket:
        """Register a waiter for the migration stream that will arrive
        carrying ``origin_id`` as its header request id."""
        ticket = _Ticket()
        with self._ticket_lock:
            self._tickets[origin_id] = ticket
        return ticket

    def forget(self, origin_id: int) -> None:
        with self._ticket_lock:
            self._tickets.pop(origin_id, None)

    def _claim(self, origin_id) -> Optional[_Ticket]:
        if origin_id is None:
            return None
        with self._ticket_lock:
            return self._tickets.pop(origin_id, None)

    def _migrated_finished(self, request) -> None:
        ticket = self._claim(getattr(request, "migrated_from", None))
        if ticket is None:
            return                    # nobody waiting (direct import)
        if getattr(request, "error", None) is None:
            # an errored import surfaces through the ticket and the
            # router retries it elsewhere — booking `migrated` here
            # AND the retry's path would double-count the request
            ti.SERVE_FABRIC_REQUESTS.inc(path="migrated")
        ticket.resolve(request)

    def take_fallback(self, ticket: _Ticket, request) -> None:
        """Degrade path for a torn migration: the prefill engine hands
        the live request over (KV discarded, stamps reset) and it
        re-prefills HERE as a plain submit — the router never sees the
        tear, so it cannot double-route.  Runs on the prefill engine's
        loop thread; completion watches from its own thread exactly
        like a migrated import."""
        self.forget(request.request_id)
        if self._dead:
            ticket.fail(self._down_error(
                f"decode replica {self.replica_id} is down"))
            return
        ti.SERVE_FABRIC_REQUESTS.inc(path="fallback")
        # the request's ledger record (and the router's decision
        # ledger, through forward_to's result) must say the handoff
        # tore and this replica re-prefilled it plain
        request.fabric_path = "fallback"
        self.engine.submit(request)

        def _watch():
            try:
                request.wait(timeout=600)
            except Exception:
                pass
            ticket.resolve(request)

        threading.Thread(target=_watch, daemon=True,
                         name="tik-fabric-fallback").start()

    def _down_error(self, message: str) -> ReplicaUnavailable:
        """A decode-side failure NAMES its origin (`replica_id`
        attribute) so the router excludes THIS replica from the retry
        instead of the healthy prefill replica that merely carried
        the handoff (router._failed_replica reads the stamp)."""
        error = ReplicaUnavailable(message)
        error.replica_id = self.replica_id
        return error

    # -- lifecycle --------------------------------------------------------
    def kill(self) -> None:
        """Crash emulation: everything EngineReplica abandons, plus
        every fabric ticket still waiting on this replica — and the
        migration receiver goes down with it (a dead process listens
        on nothing), so a handoff targeting this replica after the
        kill fails connection-shaped at the wire instead of silently
        importing into a 'dead' replica's still-live engine."""
        super().kill()
        self.close()
        with self._ticket_lock:
            tickets = list(self._tickets.values())
            self._tickets.clear()
        for ticket in tickets:
            ticket.fail(self._down_error(
                f"decode replica {self.replica_id} died with the "
                "migration in flight"))

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.receiver.stop()

    def stop(self) -> None:
        """Convenience teardown for benches/drills: receiver + engine."""
        self.close()
        self.engine.stop()


class PrefillReplica(ReplicaClient):
    """Prefill-role replica: fronts a `DecodeEngine` built with a
    :class:`FabricMigrator` (it only ever prefills — prompt completion
    exports the KV blocks and frees the lane).

    ``forward_to`` is the role-aware router's prefill path; plain
    ``forward`` refuses cleanly (a prefill-role engine has no decode
    lanes), which a correct router never exercises — the refusal is
    drain-shaped so any role-race respills instead of erroring."""

    def __init__(self, replica_id: str, engine):
        if not isinstance(getattr(engine, "_migrator", None),
                          FabricMigrator):
            raise ValueError(
                "PrefillReplica needs an engine built with "
                "migrator=FabricMigrator(...) — a pinned BlockMigrator "
                "cannot route exports per request")
        self.replica_id = replica_id
        self.engine = engine
        # the engine's ledger records carry the replica identity —
        # `tik serve requests --fleet` needs to know whose they are
        # (EngineReplica does the same for the decode/monolithic roles)
        if getattr(engine, "replica_id", None) is None:
            engine.replica_id = replica_id
        self._dead = False
        self._draining = False
        self._lock = threading.Lock()
        self._inflight: Dict[int, Any] = {}

    def forward(self, payload: Dict[str, Any], timeout_s: float,
                traceparent: Optional[str] = None) -> Dict[str, Any]:
        logger.warning("prefill-role replica %s refused a direct "
                       "forward (role-blind routing?)", self.replica_id)
        raise ReplicaDraining(
            f"replica {self.replica_id} is prefill-role: it takes "
            "migration handoffs, not direct traffic")

    def forward_to(self, payload: Dict[str, Any],
                   decode_replica: DecodeReplica, timeout_s: float,
                   traceparent: Optional[str] = None) -> Dict[str, Any]:
        """Run one prompt-heavy request through the disaggregated path:
        chunk-prefill here, stream KV blocks to ``decode_replica``'s
        receiver, return the output the decode side produced.  Raises
        the same error shapes as :meth:`EngineReplica.forward`, so the
        router's retry/spill/availability semantics are unchanged."""
        from cloudtik_tpu_torch.serve.engine import Request
        if self._draining:
            raise ReplicaDraining(
                f"replica {self.replica_id} is draining")
        if self._dead:
            raise ReplicaUnavailable(
                f"replica {self.replica_id} is down")
        req = Request(list(payload["tokens"]),
                      max_new_tokens=int(
                          payload.get("max_new_tokens", 16)),
                      temperature=float(payload.get("temperature", 0.0)),
                      eos_id=payload.get("eos_id"),
                      tenant=str(payload.get("tenant", "default")),
                      adapter_id=payload.get("adapter"))
        ticket = decode_replica.expect(req.request_id)
        req.fabric = FabricHandoff(
            decode_replica.migration_host,
            decode_replica.migration_port,
            fallback=lambda r: decode_replica.take_fallback(ticket, r))
        with self._lock:
            if self._dead:
                decode_replica.forget(req.request_id)
                raise ReplicaUnavailable(
                    f"replica {self.replica_id} is down")
            self._inflight[req.request_id] = req
        try:
            with telemetry.trace_context(traceparent):
                self.engine.submit(req)
            done = self._await(req, ticket, decode_replica, timeout_s)
            error = done.error
            if error is not None:
                raise_replica_error(self.replica_id, error)
            # fabric forensics ride along (harmless extra keys through
            # the HTTP router): which fabric path actually finished the
            # request — "migrated" / "fallback" from the completing
            # request's stamp, "prefill_local" when it never left this
            # engine (eos at the first token) — and the decode-side
            # join key back to the prefill record
            return {"tokens": [list(done.tokens)],
                    "request_id": done.request_id,
                    "migrated_from": getattr(done, "migrated_from",
                                             None),
                    "fabric_path": (getattr(done, "fabric_path", None)
                                    or "prefill_local")}
        finally:
            with self._lock:
                self._inflight.pop(req.request_id, None)
            # drop the ticket if nothing claimed it: an early-exit
            # request (eos or max_new_tokens=1 at the first token)
            # finishes ON the prefill engine and never migrates — its
            # ticket would otherwise sit in the decode replica's
            # table forever (forget is a no-op on the claimed paths)
            decode_replica.forget(req.request_id)

    def _await(self, req, ticket: _Ticket,
               decode_replica: DecodeReplica, timeout_s: float):
        """Block until the handoff resolves; returns the COMPLETED
        request (decode-side constructed, fallback-resubmitted, or the
        local one when prefill failed before handing anything off)."""
        deadline = time.monotonic() + timeout_s
        while True:
            if ticket.event.wait(timeout=_TICKET_POLL_S):
                if ticket.error is not None:
                    raise ticket.error
                return ticket.request
            if time.monotonic() >= deadline:
                # abandon our attempt so replica-side state frees; the
                # retry (if any) runs elsewhere — EngineReplica's
                # deadline discipline
                decode_replica.forget(req.request_id)
                req.cancel()
                raise TimeoutError(
                    f"fabric handoff for request {req.request_id} "
                    f"missed its {timeout_s:.1f}s deadline")
            if req._done.is_set():
                if req.error is None:
                    return req    # completed via the fallback path
                if getattr(req, "fabric").exported:
                    # the commit frame went through before this side
                    # failed (e.g. a kill racing the export): the
                    # decode side owns the request — keep waiting
                    continue
                decode_replica.forget(req.request_id)
                raise_replica_error(self.replica_id, req.error)

    def health(self, timeout_s: float = 2.0) -> bool:
        thread = getattr(self.engine, "_thread", None)
        return (not self._dead
                and thread is not None and thread.is_alive())

    def drain(self) -> None:
        self._draining = True

    def kill(self) -> None:
        """Abrupt death: abandon everything in flight, refuse the rest.
        Requests whose export already committed are NOT abandoned —
        the decode side owns them (`_await` keeps waiting)."""
        with self._lock:
            self._dead = True
            inflight = list(self._inflight.values())
        for req in inflight:
            if not getattr(req, "fabric").exported:
                req.cancel()

    def stop(self) -> None:
        self.engine.stop()
