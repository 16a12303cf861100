"""Prefix-affinity HTTP router over N engine replicas, with failover.

The traffic half of the multi-replica serving fabric (the membership
half is serve/replicas.py).  PAPER parity: the runtime layer's
kong/apisix/haproxy load balancers wired by service discovery — built
TPU-first, because the balancing signal that matters here is KV-cache
locality, not connection counts:

* **Prefix-affinity routing.**  Requests consistent-hash on their
  prompt-prefix CHAIN KEY — the PR 8 chain-key tuple over the prompt's
  full ``block_size``-aligned blocks (serve/kvcache.py), digested with
  a stable hash — so requests sharing a system prompt land on the
  replica whose prefix blocks are warm.  Prefix-cache locality is
  worth 2.4x capacity on the shared-prefix workload (BENCH_r08):
  affinity is a first-order capacity lever, not a nicety.
* **Bounded load.**  Pure affinity lets one hot prefix melt one
  replica; the ring walk skips any replica whose in-flight count
  exceeds ``load_factor`` x the fair share (consistent hashing with
  bounded loads) and spills to the next replica on the ring —
  ``tik_serve_router_spills_total{reason="load"}`` counts the cost of
  the safety valve, ``tik_serve_router_affinity_hits_total`` the
  locality it preserved.
* **Mid-traffic failover.**  Every forward attempt runs under the
  ``serve.router.forward`` fault seam and the unified retry policy
  (utils/retry.py): connection errors, per-request deadlines, and
  drain refusals retry IDEMPOTENT work (greedy, temperature 0) on the
  next ring replica; sampled requests never silently re-run.  A dead
  replica's queued-but-unstarted requests fail over the same way —
  their forward attempts die with the replica and resubmit on a
  survivor.  Exhaustion surfaces the ORIGINAL error, not the retry
  wrapper.  Every hop carries the request's ``x-tik-traceparent``, so
  one stitched trace narrates submit -> route -> failover -> finish.
* **Health probing.**  A background cycle re-reads the registry,
  probes every routable replica, and condemns one after
  ``probe_failures`` consecutive failures — within
  ``probe_failures x probe_interval_s`` of a kill, its traffic is on
  survivors and the `serve_demand` autoscaler (when attached) journals
  a ``lost_node`` replacement ask.
* **Graceful drain.**  A draining replica (SIGTERM -> registry mark +
  HTTP 503 with ``Retry-After``) takes no new traffic; the router
  spills (``reason="drain"``) without spending availability budget,
  and the replica's in-flight requests finish ``done``, not
  ``drained``.
* **Role-aware disaggregation (serve/fabric.py).**  Replicas register
  a role; prefill-role replicas never join the decode ring.  While one
  is routable, a PROMPT-HEAVY request (prompt length >=
  ``prefill_len_threshold``) chunk-prefills there and its KV blocks
  stream over the socket `KVTransport` to the decode replica the
  adapter-salted affinity hash chose — shared prompts land where
  their blocks already live, and decode lanes never pay long-prompt
  prefill interleave.  With no prefill role routable the request
  degrades to the plain path (``tik_serve_fabric_requests_total
  {path="direct"}``); greedy output is bit-identical either way.

* **Decision ledger (serve/routerlog.py).**  Every routed request
  appends one durable record at completion — the unfiltered ring
  primary vs the replica that actually served it, the decision path
  (affinity | spill_load | spill_drain | failover | fabric_migrated |
  fabric_fallback | direct), per-hop WHY sentences and monotonic
  stamps, retries and excluded replicas — so ``tik serve explain``
  can replay the router's reasoning for one request after the fact.

Transports are pluggable :class:`ReplicaClient`s: :class:`HttpReplica`
(stdlib HTTP to a tik-serve instance) for the real fabric,
:class:`EngineReplica` (in-process `DecodeEngine`) for benches and the
tier-1 chaos drill.  :class:`RouterServer` is the HTTP front door
(``tik-serve-router``); ``tik serve replicas --url`` prints its view.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import math
import threading
import time
from bisect import bisect_right
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from cloudtik_tpu_torch import telemetry
from cloudtik_tpu_torch.faults import seams
from cloudtik_tpu_torch.faults.plan import FaultInjected
from cloudtik_tpu_torch.serve import kvcache, routerlog
from cloudtik_tpu_torch.serve.replicas import (
    ROLE_PREFILL, ReplicaAutoscaler, ReplicaRegistry)
from cloudtik_tpu_torch.telemetry import instruments as ti
from cloudtik_tpu_torch.utils.retry import (
    RetriesExhausted, RetryPolicy, call_with_retry)

logger = logging.getLogger(__name__)


class NoRoutableReplica(RuntimeError):
    """The registry holds no replica traffic may land on."""


class ReplicaDraining(RuntimeError):
    """The replica refused new work because it is draining (HTTP 503
    with Retry-After) — spill to the next ring replica, spend no
    availability budget."""


class ReplicaUnavailable(ConnectionError):
    """The replica cannot take or finish work (killed, unreachable)."""


class ReplicaRejected(RuntimeError):
    """The replica refused the REQUEST itself (4xx — oversized prompt,
    malformed payload): client-caused, never retried, surfaced with
    the replica's own status code instead of a retriable-looking
    router error."""

    def __init__(self, message: str, status: int = 400):
        super().__init__(message)
        self.status = status


def fire_forward_seam(replica_id: str, request_id: Any) -> None:
    """The ``serve.router.forward`` injection seam, fired immediately
    before every forward attempt (``raise`` -> the attempt fails like
    a connection error and the request fails over to the next ring
    replica).  Unarmed this is one attribute check — the tripwire test
    runs this exact path."""
    seams.fire("serve.router.forward", replica=replica_id,
               request=request_id)


# ------------------------------------------------------------ chain keys --

def prefix_chain_key(prompt: Sequence[int], block_size: int,
                     namespace=None) -> Tuple:
    """The routing key: the chain-key tuple over the prompt's FULL
    ``block_size``-aligned blocks — built by the SAME
    `kvcache.chain_keys` the prefix map shares blocks by (the partial
    tail block is excluded, exactly as the prefix map excludes it), so
    two prompts sharing their block-aligned prefix route identically
    no matter how their tails differ.  ``namespace`` (an adapter_id)
    salts the chain ROOT exactly as the prefix map salts it: fleets
    serving disjoint adapter sets keep adapter-warm replicas hot
    because identical prompts under different adapters hash apart —
    just as their KV blocks never share.

    A prompt with NO full block has nothing the prefix map could
    share, so there is no warm replica to aim for — and pinning every
    sub-block prompt to the single "root" ring position would melt
    one replica under short-prompt traffic.  Those prompts key on
    their raw content instead: deterministic (same prompt, same
    replica) but spread."""
    keys = kvcache.chain_keys(prompt, block_size, namespace=namespace)
    if keys:
        return keys[-1]
    salt = () if namespace is None else (namespace,)
    return ("tail",) + salt + tuple(prompt)


def chain_hash(prompt: Sequence[int], block_size: int,
               namespace=None) -> int:
    """Stable 64-bit digest of the prompt's chain key.  ``hash()`` is
    salted per process (PYTHONHASHSEED) — a router restart must not
    reshuffle every prefix onto cold replicas, so the digest is a
    content hash of a canonical encoding."""
    key = prefix_chain_key(prompt, block_size, namespace=namespace)
    digest = hashlib.blake2b(repr(key).encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "big")


class HashRing:
    """Consistent-hash ring with virtual nodes.

    ``preference(h)`` returns ALL members in ring order from the key's
    position — index 0 is the affinity primary, the rest the spill /
    failover order.  Adding one member to an N-member ring remaps only
    ~1/(N+1) of the key space (tested)."""

    def __init__(self, members: Sequence[str], vnodes: int = 64):
        self.vnodes = int(vnodes)
        points: List[Tuple[int, str]] = []
        for member in members:
            for i in range(self.vnodes):
                digest = hashlib.blake2b(
                    f"{member}#{i}".encode(), digest_size=8)
                points.append(
                    (int.from_bytes(digest.digest(), "big"), member))
        points.sort()
        self._hashes = [h for h, _m in points]
        self._members = [m for _h, m in points]

    def preference(self, key_hash: int) -> List[str]:
        """Unique members in ring-walk order from the key's position."""
        if not self._members:
            return []
        start = bisect_right(self._hashes, key_hash)
        seen: Dict[str, None] = {}
        n = len(self._members)
        for i in range(n):
            member = self._members[(start + i) % n]
            if member not in seen:
                seen[member] = None
        return list(seen)


# ------------------------------------------------------------ transports --

class ReplicaClient:
    """Transport to one engine replica.  ``forward`` runs one request
    to completion and returns its output tokens; it raises
    :class:`ReplicaDraining` on a drain refusal and
    :class:`ReplicaUnavailable` (or OSError/TimeoutError) on
    connection-shaped failures — the router's failover boundary."""

    replica_id: str = ""

    def forward(self, payload: Dict[str, Any], timeout_s: float,
                traceparent: Optional[str] = None) -> Dict[str, Any]:
        raise NotImplementedError

    def health(self, timeout_s: float = 2.0) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        pass


def raise_replica_error(replica_id: str,
                        error: BaseException) -> None:
    """Translate engine-request errors into the router's failover
    vocabulary.  ONE mapping shared by :class:`EngineReplica.forward`
    and the fabric's ``PrefillReplica`` (serve/fabric.py) — the two
    paths must keep identical failover/availability semantics, so the
    table lives in exactly one place:

    * ``queue_full`` rejection → :class:`ReplicaDraining` (bounded
      admission queue overflow is back-pressure, not a client error —
      respill to the next ring replica, spending no availability
      budget);
    * other rejections → :class:`ReplicaRejected` (413 for capacity,
      400 otherwise — the client's problem, never retried);
    * cancellation (a kill abandoned it) → connection-shaped
      :class:`ReplicaUnavailable`;
    * anything else re-raises as-is."""
    from cloudtik_tpu_torch.serve.engine import (
        RequestCancelled, RequestRejected)
    if isinstance(error, RequestRejected):
        if error.reason == "queue_full":
            raise ReplicaDraining(
                f"replica {replica_id} admission queue "
                f"full: {error}") from error
        raise ReplicaRejected(
            str(error),
            status=413 if error.reason == "capacity" else 400
        ) from error
    if isinstance(error, RequestCancelled):
        raise ReplicaUnavailable(
            f"replica {replica_id} died mid-request") from error
    raise error


def _failed_replica(error: BaseException, prid: Optional[str],
                    rid: str) -> str:
    """Which replica a failed attempt excludes from the retry.

    On the fabric path the default blame is the PREFILL replica (the
    retry either reaches another prefill replica or degrades to the
    plain path — a sick decode replica is the probe loop's to
    condemn), but an error that NAMES its origin (``replica_id``
    stamped by the fabric's decode side, e.g. a decode replica dying
    with the migration in flight) excludes THAT replica instead:
    blaming prefill would burn every retry re-targeting the same dead
    decode replica while healthy decode capacity sat on the ring."""
    failed = getattr(error, "replica_id", None)
    if failed:
        return failed
    return prid if prid is not None else rid


class EngineReplica(ReplicaClient):
    """In-process replica over a live `DecodeEngine` (benches, drills).

    Each forward attempt submits a FRESH engine Request built from the
    payload — the idempotent-resubmission unit — so a retry on a
    survivor is exactly a resubmit.  ``kill()`` emulates a crash:
    in-flight attempts abort with :class:`ReplicaUnavailable` (their
    engine-side requests are abandoned via cancel — a dead process
    writes no ledger records, and cancels spend no availability
    budget), queued work dies the same way, and health probes fail."""

    def __init__(self, replica_id: str, engine):
        self.replica_id = replica_id
        self.engine = engine
        # the engine's ledger records carry the replica identity —
        # `tik serve requests --fleet` merges many replicas' ledgers
        # and needs to know whose each record is
        if getattr(engine, "replica_id", None) is None:
            engine.replica_id = replica_id
        self._dead = False
        self._draining = False
        self._lock = threading.Lock()
        self._inflight: Dict[int, Any] = {}

    def forward(self, payload: Dict[str, Any], timeout_s: float,
                traceparent: Optional[str] = None) -> Dict[str, Any]:
        from cloudtik_tpu_torch.serve.engine import (
            Request, RequestCancelled, RequestRejected)
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
        with self._lock:
            if self._dead:
                raise ReplicaUnavailable(
                    f"replica {self.replica_id} is down")
            self._inflight[req.request_id] = req
        try:
            # the hop carries the caller's trace: the engine-side spans
            # (enqueue/prefill/decode) join the router's stitched story
            with telemetry.trace_context(traceparent):
                self.engine.submit(req)
            try:
                tokens = req.wait(timeout=timeout_s)
            except (RequestRejected, RequestCancelled) as e:
                raise_replica_error(self.replica_id, e)
            except TimeoutError:
                # per-request deadline: abandon our attempt so the
                # replica-side slot frees; the retry runs elsewhere
                req.cancel()
                raise
            return {"tokens": [tokens], "request_id": req.request_id}
        finally:
            with self._lock:
                self._inflight.pop(req.request_id, None)

    def health(self, timeout_s: float = 2.0) -> bool:
        thread = getattr(self.engine, "_thread", None)
        return (not self._dead
                and thread is not None and thread.is_alive())

    def drain(self) -> None:
        self._draining = True

    def kill(self) -> None:
        """Abrupt death: abandon everything in flight, refuse the rest."""
        with self._lock:
            self._dead = True
            inflight = list(self._inflight.values())
        for req in inflight:
            req.cancel()


class HttpReplica(ReplicaClient):
    """HTTP transport to a tik-serve replica (serve/server.py)."""

    def __init__(self, replica_id: str, url: str,
                 connect_timeout_s: float = 5.0):
        self.replica_id = replica_id
        self.url = url.rstrip("/")
        self.connect_timeout_s = float(connect_timeout_s)

    def _request(self, method: str, path: str,
                 body: Optional[bytes], timeout_s: float,
                 headers: Optional[Dict[str, str]] = None):
        import urllib.request
        req = urllib.request.Request(
            self.url + path, data=body, method=method,
            headers={"Content-Type": "application/json",
                     **(headers or {})})
        return urllib.request.urlopen(req, timeout=timeout_s)

    def forward(self, payload: Dict[str, Any], timeout_s: float,
                traceparent: Optional[str] = None) -> Dict[str, Any]:
        import urllib.error
        headers = {}
        if traceparent:
            headers["traceparent"] = traceparent
        try:
            with self._request("POST", "/v1/generate",
                               json.dumps(payload).encode(), timeout_s,
                               headers) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            if e.code in (503, 429):
                # 503 = draining, 429 = admission queue full: both are
                # clean back-pressure refusals (Retry-After on the
                # wire, work never started) — respill to the next ring
                # replica, spend no availability budget
                raise ReplicaDraining(
                    f"replica {self.replica_id} refused new work "
                    f"({e.code}; Retry-After: "
                    f"{e.headers.get('Retry-After')})") from e
            body = e.read().decode(errors="replace")
            if 400 <= e.code < 500:
                # the replica refused the REQUEST (oversized prompt,
                # malformed payload): client-caused, not retryable —
                # surface the replica's own status code
                raise ReplicaRejected(
                    f"replica {self.replica_id} rejected the request "
                    f"({e.code}): {body}", status=e.code) from e
            raise RuntimeError(
                f"replica {self.replica_id} returned {e.code}: {body}"
            ) from e
        except urllib.error.URLError as e:
            raise ReplicaUnavailable(
                f"replica {self.replica_id} unreachable: {e.reason}"
            ) from e

    def health(self, timeout_s: float = 2.0) -> bool:
        try:
            with self._request("GET", "/healthz", None,
                               timeout_s) as resp:
                return resp.status == 200
        except Exception:
            return False


# ---------------------------------------------------------------- router --

@dataclasses.dataclass
class RouterConfig:
    block_size: int = 16              # chain-key block alignment
    vnodes: int = 64                  # ring virtual nodes per replica
    # bounded load: a replica takes a request only while its in-flight
    # count stays <= load_factor x the fair share (ceil), else spill
    load_factor: float = 1.5
    probe_interval_s: float = 1.0
    probe_timeout_s: float = 2.0
    probe_failures: int = 3           # consecutive fails -> condemn
    request_deadline_s: float = 120.0  # per-attempt forward deadline
    policy: str = "affinity"          # or "round_robin" (baseline)
    # role-aware fabric (serve/fabric.py): a request whose prompt is at
    # least this many tokens is PROMPT-HEAVY — while a prefill-role
    # replica is routable it chunk-prefills there and its KV blocks
    # stream to the affinity-chosen decode replica over the socket
    # transport.  Shorter prompts (and every request when no prefill
    # role is routable) forward directly to a decode-capable replica.
    prefill_len_threshold: int = 32
    retry: RetryPolicy = RetryPolicy(
        max_attempts=4, base_delay_s=0.05, multiplier=2.0,
        max_delay_s=1.0, jitter=0.1)


class Router:
    """Routing core: registry view -> ring -> pick -> forward/retry.

    ``clients`` maps replica_id -> :class:`ReplicaClient`;
    ``client_factory(info)`` builds one from a registry record
    (default: :class:`HttpReplica` from the record's url) so replicas
    registering at runtime become routable without restarts."""

    def __init__(self, registry: ReplicaRegistry,
                 config: Optional[RouterConfig] = None,
                 client_factory: Optional[
                     Callable[[Any], ReplicaClient]] = None,
                 autoscaler: Optional[ReplicaAutoscaler] = None,
                 traceparent: Optional[str] = None):
        self.registry = registry
        self.config = config or RouterConfig()
        self.autoscaler = autoscaler
        self._client_factory = client_factory or (
            lambda info: HttpReplica(info.replica_id, info.url))
        self._clients: Dict[str, ReplicaClient] = {}
        self._ring = HashRing([], self.config.vnodes)
        self._routable: List[str] = []
        # role-aware fabric state: prefill-role replicas never join the
        # decode-capable ring (their engines have no decode lanes) —
        # they form their own routable list, picked least-loaded for
        # prompt-heavy traffic.  `_has_prefill_role` is true while ANY
        # replica (routable or not) registered the prefill role, so
        # the direct-fallback metric only counts in fabrics that have
        # the role at all.
        self._prefill: List[str] = []
        self._has_prefill_role = False
        # replica_id -> deployment version label (registry-sourced):
        # the decision ledger stamps each hop with the version it hit,
        # so a bad rollout shows up in `tik serve explain` output
        self._versions: Dict[str, str] = {}
        self._inflight: Dict[str, int] = {}
        self._probe_fails: Dict[str, int] = {}
        self._rr = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the probe/scale cycle runs on its own thread; adopting the
        # composer's traceparent keeps condemnations and replacement
        # asks in the same stitched trace as the traffic they concern
        self._traceparent = traceparent
        self.sync()

    # -- membership -------------------------------------------------------
    def sync(self) -> None:
        """Re-read the registry; rebuild the ring when the routable set
        changed."""
        infos = {i.replica_id: i for i in self.registry.routable()}
        with self._lock:
            for rid in list(self._clients):
                if rid not in infos:
                    self._clients.pop(rid).close()
                    self._probe_fails.pop(rid, None)
            for rid, info in infos.items():
                if rid not in self._clients:
                    self._clients[rid] = self._client_factory(info)
                    self._inflight.setdefault(rid, 0)
            # the ring holds DECODE-CAPABLE replicas only: monolithic
            # engines and decode-role replicas take direct forwards;
            # prefill-role replicas are a separate pick (role-aware
            # prompt-heavy path) because their engines never decode
            routable = sorted(rid for rid, info in infos.items()
                              if info.role != ROLE_PREFILL)
            self._prefill = sorted(rid for rid, info in infos.items()
                                   if info.role == ROLE_PREFILL)
            self._versions.update(
                (rid, info.version) for rid, info in infos.items())
            if routable != self._routable:
                self._routable = routable
                self._ring = HashRing(routable, self.config.vnodes)
        all_replicas = self.registry.list_replicas()
        self._has_prefill_role = any(
            info.role == ROLE_PREFILL for info in all_replicas)
        if telemetry.enabled():
            states = {"routable": 0, "draining": 0, "condemned": 0}
            for info in all_replicas:
                if info.condemned is not None:
                    states["condemned"] += 1
                elif info.draining:
                    states["draining"] += 1
                elif self.registry.alive(info):
                    states["routable"] += 1
            for state, count in states.items():
                ti.SERVE_ROUTER_REPLICAS.set(count, state=state)

    def add_client(self, client: ReplicaClient, role: str = "engine",
                   slots: int = 0) -> None:
        """Register an in-process replica (benches / drills): one call
        registers it in the registry AND makes it routable."""
        self.registry.register(client.replica_id, None, role=role,
                               slots=slots)
        with self._lock:
            self._clients[client.replica_id] = client
            self._inflight.setdefault(client.replica_id, 0)
        self.sync()

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._probe_loop, name="tik-router-probe",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _probe_loop(self) -> None:
        with telemetry.trace_context(self._traceparent):
            while not self._stop.wait(self.config.probe_interval_s):
                try:
                    self.probe_cycle()
                except Exception:
                    logger.exception("router probe cycle failed")

    def probe_cycle(self) -> None:
        """One health pass: probe every routable replica, condemn after
        `probe_failures` consecutive failures, then let the autoscaler
        react to the new membership."""
        self.sync()
        with self._lock:
            clients = dict(self._clients)
        for rid, client in clients.items():
            try:
                ok = client.health(self.config.probe_timeout_s)
            except Exception:
                ok = False
            if ok:
                self._probe_fails[rid] = 0
                continue
            ti.SERVE_ROUTER_PROBE_FAILURES.inc()
            self._probe_fails[rid] = self._probe_fails.get(rid, 0) + 1
            if self._probe_fails[rid] >= self.config.probe_failures:
                logger.warning("condemning replica %s after %d failed "
                               "probes", rid, self._probe_fails[rid])
                self.registry.condemn(rid, "probe_failed")
        self.sync()
        if self.autoscaler is not None:
            self.autoscaler.evaluate()

    # -- routing ----------------------------------------------------------
    def _fair_bound(self, n: int) -> int:
        with self._lock:
            total = sum(self._inflight.values())
        return max(1, math.ceil(
            self.config.load_factor * (total + 1) / max(n, 1)))

    def _pick(self, key_hash: int, excluded: set,
              out: Optional[Dict[str, Any]] = None) -> Tuple[
            ReplicaClient, bool]:
        """(client, is_primary): the affinity primary unless bounded
        load or exclusion walks the ring past it.

        ``out`` (when the decision ledger is live) receives the pick's
        WHY: {primary: the unfiltered ring head, why: one operator
        sentence, spill: "load"|None} — computed only when asked for,
        so the disabled-telemetry path never builds strings."""
        with self._lock:
            routable = [r for r in self._routable if r not in excluded]
            clients = dict(self._clients)
            inflight = dict(self._inflight)
        if not routable:
            raise NoRoutableReplica(
                "no routable serving replica (registry empty, all "
                "draining/condemned, or every survivor already failed "
                "this request)")
        if self.config.policy == "round_robin":
            with self._lock:
                self._rr += 1
                rid = routable[self._rr % len(routable)]
            if out is not None:
                out.update(primary=None, spill=None,
                           why="round-robin policy pick")
            return clients[rid], True
        # the affinity primary is the ring's first pick BEFORE this
        # request's exclusions: a failover landing on the ring-second
        # replica is NOT an affinity hit — its blocks are cold, and
        # the locality metrics must say so
        full_preference = self._ring.preference(key_hash)
        primary_rid = full_preference[0] if full_preference else None
        preference = [r for r in full_preference if r in routable]
        if not preference:       # ring is stale vs. exclusions; rebuild
            preference = routable
        bound = self._fair_bound(len(routable))
        for i, rid in enumerate(preference):
            if inflight.get(rid, 0) + 1 <= bound:
                if i > 0:
                    ti.SERVE_ROUTER_SPILLS.inc(reason="load")
                if out is not None:
                    out.update(primary=primary_rid,
                               spill="load" if i > 0 else None,
                               why=self._pick_why(
                                   rid, primary_rid, excluded, i,
                                   bound, inflight))
                return clients[rid], rid == primary_rid
        # everyone over the bound (a burst mid-flight): least loaded
        rid = min(preference, key=lambda r: inflight.get(r, 0))
        ti.SERVE_ROUTER_SPILLS.inc(reason="load")
        if out is not None:
            out.update(primary=primary_rid, spill="load",
                       why=(f"every candidate over the bounded-load "
                            f"cap ({bound} in flight): least-loaded "
                            f"fallback"))
        return clients[rid], rid == primary_rid

    @staticmethod
    def _pick_why(rid: str, primary_rid: Optional[str], excluded: set,
                  walk: int, bound: int,
                  inflight: Dict[str, int]) -> str:
        """One operator sentence for the decision ledger: why THIS
        replica took the request."""
        if rid == primary_rid:
            return ("chain-key ring primary (prefix blocks warm for "
                    "this prompt's chain)")
        if primary_rid in excluded:
            return (f"ring primary {primary_rid} excluded after an "
                    f"earlier failed attempt; next survivor in ring "
                    f"order")
        if walk > 0:
            return (f"ring primary {primary_rid} over the "
                    f"bounded-load cap ({inflight.get(primary_rid, 0)}"
                    f" in flight, cap {bound}): spilled {walk} "
                    f"step{'s' if walk > 1 else ''} down the ring")
        return f"first routable replica in ring order after {primary_rid}"

    def _pick_prefill(self, excluded: set,
                      decode_client: ReplicaClient
                      ) -> Optional[ReplicaClient]:
        """Least-loaded routable prefill-role replica for a
        prompt-heavy request, or None (then the request takes the
        plain decode/monolithic path — the fabric degrades to
        role-blind, it never refuses).  The handoff needs both ends to
        speak the fabric surface: a prefill client without
        ``forward_to`` (e.g. a plain HTTP transport) or a decode
        target without a migration receiver (no ``expect``) routes
        direct."""
        if not hasattr(decode_client, "expect"):
            return None
        with self._lock:
            candidates = [r for r in self._prefill if r not in excluded]
            clients = dict(self._clients)
            inflight = dict(self._inflight)
        candidates = [r for r in candidates
                      if hasattr(clients.get(r), "forward_to")]
        if not candidates:
            return None
        return clients[min(candidates,
                           key=lambda r: inflight.get(r, 0))]

    def handle(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Route one request to completion (synchronous; HTTP handler
        threads and bench workers call this).  Raises the ORIGINAL
        replica error on retry exhaustion."""
        prompt = payload.get("tokens") or []
        if prompt and isinstance(prompt[0], list):
            prompt = prompt[0]
        payload = dict(payload, tokens=list(prompt))
        temperature = float(payload.get("temperature", 0.0))
        key_hash = chain_hash(prompt, self.config.block_size,
                              namespace=payload.get("adapter"))
        excluded: set = set()
        last_error: List[Optional[BaseException]] = [None]
        traceparent = telemetry.current_traceparent()

        prompt_heavy = (len(prompt)
                        >= self.config.prefill_len_threshold)
        # the decision ledger (None with telemetry off or no journal
        # installed — every downstream stamp is then one None test)
        trail = routerlog.begin(payload.get("request_id"),
                                str(payload.get("tenant", "default")),
                                len(prompt), key_hash, prompt_heavy,
                                traceparent)

        def attempt() -> Dict[str, Any]:
            pick_info = {} if trail is not None else None
            client, primary = self._pick(key_hash, excluded,
                                         out=pick_info)
            rid = client.replica_id
            pclient = None
            if prompt_heavy:
                pclient = self._pick_prefill(excluded, client)
            prid = pclient.replica_id if pclient is not None else None
            hop = None
            if trail is not None:
                hop = trail.start_hop(
                    rid, prid, primary, pick_info.get("primary"),
                    pick_info.get("why"), pick_info.get("spill"),
                    self._versions.get(rid))
            # a fabric hop charges both ends: the decode replica does
            # the lasting work (its count drives the bounded-load
            # walk), the prefill count drives the least-loaded
            # prefill pick
            if primary and self.config.policy == "affinity":
                ti.SERVE_ROUTER_AFFINITY_HITS.inc()
            with self._lock:
                self._inflight[rid] = self._inflight.get(rid, 0) + 1
                if prid is not None:
                    self._inflight[prid] = \
                        self._inflight.get(prid, 0) + 1
                ti.SERVE_ROUTER_INFLIGHT.set(
                    sum(self._inflight.values()))
            try:
                if pclient is not None:
                    # failures on this path exclude the PREFILL
                    # replica: the retry either reaches another
                    # prefill replica or degrades to the plain path —
                    # a sick decode replica is the probe loop's to
                    # condemn
                    with telemetry.span("serve.router.forward",
                                        replica=prid, primary=primary,
                                        decode_replica=rid):
                        fire_forward_seam(prid,
                                          payload.get("request_id"))
                        out = pclient.forward_to(
                            payload, client,
                            self.config.request_deadline_s,
                            traceparent=traceparent)
                    if hop is not None:
                        # which fabric path actually finished it —
                        # migrated / fallback from the result, nothing
                        # for a prefill-local early exit
                        fp = out.get("fabric_path")
                        trail.end_hop(hop, fabric=fp if fp in (
                            "migrated", "fallback") else None)
                    return out
                with telemetry.span("serve.router.forward",
                                    replica=rid, primary=primary):
                    fire_forward_seam(rid, payload.get("request_id"))
                    out = client.forward(
                        payload, self.config.request_deadline_s,
                        traceparent=traceparent)
                direct = prompt_heavy and self._has_prefill_role
                if direct:
                    # the fabric HAS the role but could not use it for
                    # this request (killed/draining/already-failed
                    # prefill, or a decode target without a receiver).
                    # Counted at COMPLETION like migrated/fallback so
                    # the three paths sum to completed prompt-heavy
                    # requests — a retried attempt must not book twice
                    ti.SERVE_FABRIC_REQUESTS.inc(path="direct")
                if hop is not None:
                    trail.end_hop(hop,
                                  fabric="direct" if direct else None)
                return out
            except ReplicaDraining as e:
                failed = _failed_replica(e, prid, rid)
                excluded.add(failed)
                last_error[0] = e
                ti.SERVE_ROUTER_SPILLS.inc(reason="drain")
                if hop is not None:
                    trail.end_hop(hop, error=e, kind="drain",
                                  excluded=failed)
                raise
            except (ReplicaUnavailable, ConnectionError, TimeoutError,
                    OSError, FaultInjected) as e:
                failed = _failed_replica(e, prid, rid)
                excluded.add(failed)
                last_error[0] = e
                ti.SERVE_ROUTER_FAILOVERS.inc()
                if hop is not None:
                    trail.end_hop(hop, error=e, kind="failover",
                                  excluded=failed)
                raise
            finally:
                with self._lock:
                    self._inflight[rid] = max(
                        0, self._inflight.get(rid, 0) - 1)
                    if prid is not None:
                        self._inflight[prid] = max(
                            0, self._inflight.get(prid, 0) - 1)
                    ti.SERVE_ROUTER_INFLIGHT.set(
                        sum(self._inflight.values()))

        def retryable(exc: BaseException) -> bool:
            # drain refusals always respill (the work never started);
            # failure-shaped errors re-run only idempotent (greedy)
            # requests — a sampled generation must not silently re-run
            if isinstance(exc, ReplicaDraining):
                return True
            if isinstance(exc, (ReplicaUnavailable, ConnectionError,
                                TimeoutError, OSError, FaultInjected)):
                return temperature <= 0.0
            return False

        def _surface(exc: BaseException):
            # refusals are not errors: a drain/empty-registry refusal
            # is cleanly retriable (503, work never started) and a
            # replica 4xx is client-caused — neither spends the
            # router's availability story; everything else does
            result = "rejected" if isinstance(
                exc, (ReplicaDraining, NoRoutableReplica,
                      ReplicaRejected)) else "error"
            ti.SERVE_ROUTER_REQUESTS.inc(result=result)
            routerlog.record(trail, result)
            raise exc

        policy = dataclasses.replace(self.config.retry,
                                     retryable=retryable)
        try:
            result = call_with_retry(attempt, policy)
        except RetriesExhausted as e:
            _surface(e.last)         # surface the original error
        except NoRoutableReplica as e:
            if last_error[0] is not None:
                # "no routable replica" only because every survivor
                # already failed this request: the ORIGINAL replica
                # error is the story, not the empty candidate list
                _surface(last_error[0])
            _surface(e)
        except Exception as e:
            _surface(e)
        ti.SERVE_ROUTER_REQUESTS.inc(result="ok")
        routerlog.record(trail, routerlog.OUTCOME_OK, result=result)
        return result

    # -- bench/drill submit surface (DecodeEngine-compatible) -------------
    def submit(self, request) -> Any:
        """Drive an engine-style `Request` through the router on a
        worker thread; the caller blocks on ``request.wait()`` exactly
        as with a `DecodeEngine`.  The ledger records come from the
        replica-side requests the forwards create — this client-side
        object is completed without a ledger record (a router is a
        proxy, not a second serving engine)."""
        traceparent = telemetry.current_traceparent()
        payload = {"tokens": list(request.prompt),
                   "max_new_tokens": request.max_new_tokens,
                   "temperature": request.temperature,
                   "eos_id": request.eos_id,
                   "request_id": request.request_id,
                   "tenant": getattr(request, "tenant", "default"),
                   "adapter": getattr(request, "adapter_id", None)}

        def run() -> None:
            with telemetry.trace_context(traceparent):
                try:
                    result = self.handle(payload)
                    request.tokens = list(result["tokens"][0])
                except Exception as e:
                    request.error = e
            request.done_time = time.time()
            request.done_mono = time.monotonic()
            request._done.set()

        threading.Thread(target=run, daemon=True,
                         name="tik-router-request").start()
        return request

    def generate(self, prompt: List[int], **kw) -> List[int]:
        from cloudtik_tpu_torch.serve.engine import Request
        return self.submit(Request(prompt, **kw)).wait(timeout=600)

    # -- introspection ----------------------------------------------------
    def describe(self) -> Dict[str, Any]:
        """The `tik serve replicas` view: registry records + live load."""
        with self._lock:
            inflight = dict(self._inflight)
            routable = list(self._routable)
        replicas = []
        for info in sorted(self.registry.list_replicas(),
                           key=lambda i: i.replica_id):
            replicas.append({
                "replica_id": info.replica_id,
                "url": info.url,
                "role": info.role,
                "version": info.version,
                "slots": info.slots,
                "routable": info.replica_id in routable,
                "draining": info.draining,
                "condemned": info.condemned,
                "beat_age_s": round(time.time() - info.time, 3),
                "inflight": inflight.get(info.replica_id, 0),
                "stats": info.stats,
            })
        out: Dict[str, Any] = {"policy": self.config.policy,
                               "replicas": replicas}
        if self.autoscaler is not None:
            out["target_replicas"] = self.autoscaler.target
            role_targets = getattr(self.autoscaler, "role_targets",
                                   None)
            if role_targets:
                out["target_replicas_by_role"] = dict(role_targets)
        return out


# ------------------------------------------------------------- HTTP front --

class RouterServer:
    """Stdlib-threaded HTTP front door over a :class:`Router`.

    POST /v1/generate   routed generation (the tik-serve surface)
    GET  /healthz       router liveness
    GET  /v1/replicas   the registry + live-load view
    """

    def __init__(self, router: Router, host: str = "0.0.0.0",
                 port: int = 0):
        from http.server import BaseHTTPRequestHandler, \
            ThreadingHTTPServer
        self.router = router

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, code: int, obj: Dict[str, Any],
                      extra: Optional[Dict[str, str]] = None) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for key, value in (extra or {}).items():
                    self.send_header(key, value)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"status": "ok"})
                elif self.path == "/v1/replicas":
                    self._send(200, router.describe())
                elif self.path.startswith("/v1/explain"):
                    # the router-side half of `tik serve explain
                    # --url`: this process holds the decision ledger
                    # (replica request ledgers live on their own
                    # hosts — stitch those with --reqlog files)
                    from urllib.parse import parse_qs, urlparse
                    from cloudtik_tpu_torch.serve import explain as _explain
                    query = parse_qs(urlparse(self.path).query)
                    rid = (query.get("request_id") or [None])[0]
                    if rid is None:
                        self._send(400,
                                   {"error": "request_id required"})
                        return
                    routes = routerlog.read_routes()
                    self._send(200, _explain.build(rid, routes, []))
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/v1/generate":
                    self._send(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(
                        self.rfile.read(length) or b"{}")
                    with telemetry.trace_context(
                            self.headers.get("traceparent")):
                        result = router.handle(payload)
                        # read INSIDE the context: the trace id the
                        # hops carried is what the client joins on
                        tp = telemetry.current_traceparent()
                    headers = {}
                    if tp:
                        headers["x-tik-traceparent"] = tp
                    self._send(200, result, headers)
                except (NoRoutableReplica, ReplicaDraining) as e:
                    # nothing can take the work RIGHT NOW (registry
                    # empty, or every candidate draining): a clean,
                    # retriable refusal, never a 500
                    self._send(503, {"error": str(e)},
                               {"Retry-After": "1"})
                except ReplicaRejected as e:
                    # the replica refused the request itself: relay
                    # its client-error status (413 capacity, 400
                    # malformed), not a retriable-looking 500
                    self._send(e.status, {"error": str(e)})
                except Exception as e:
                    logger.exception("router request failed")
                    self._send(500, {"error": str(e)})

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self.router.start()
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="tik-serve-router",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self.router.stop()


def main(argv=None) -> int:
    import argparse

    from cloudtik_tpu_torch.control.state import StateClient, TcpStateBackend

    p = argparse.ArgumentParser("tik-serve-router")
    p.add_argument("--state-host", required=True,
                   help="head state server the replica registry lives "
                        "in (replicas register themselves there)")
    p.add_argument("--state-port", type=int, default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8210)
    p.add_argument("--block-size", type=int, default=16,
                   help="chain-key block alignment; match the "
                        "replicas' --block-size or affinity degrades "
                        "to random placement")
    p.add_argument("--load-factor", type=float, default=1.5)
    p.add_argument("--probe-interval", type=float, default=1.0)
    p.add_argument("--probe-failures", type=int, default=3)
    p.add_argument("--policy", choices=["affinity", "round_robin"],
                   default="affinity")
    p.add_argument("--router-log", default=None,
                   help="router decision ledger path (default "
                        "TIK_ROUTER_LOG_PATH or "
                        "~/.tik/logs/serve-router.jsonl)")
    args = p.parse_args(argv)

    # daemon boot installs the decision ledger (libraries never do);
    # the router appends one durable record per routed request
    # (TIK_ROUTER_LOG_PATH / --router-log override the default path)
    try:
        routerlog.install(args.router_log)
    except OSError:
        logger.warning("router decision ledger not installed",
                       exc_info=True)

    backend_kw = {}
    if args.state_port is not None:
        backend_kw["port"] = args.state_port
    registry = ReplicaRegistry(
        StateClient(TcpStateBackend(args.state_host, **backend_kw)))
    router = Router(registry, RouterConfig(
        block_size=args.block_size, load_factor=args.load_factor,
        probe_interval_s=args.probe_interval,
        probe_failures=args.probe_failures, policy=args.policy))
    server = RouterServer(router, host=args.host, port=args.port)
    server.start()
    print(f"tik-serve-router listening on {args.host}:{server.port}",
          flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
