"""Router decision ledger: one durable JSONL record per routed request.

The router's counters say HOW OFTEN it spilled or failed over; this
ledger says WHY for request 714 specifically — the per-request half of
the fleet forensics story (`tik serve explain` joins it against every
replica's request ledger on ``request_id`` / ``migrated_from``).
``Router.handle`` appends exactly one record per routed request at
completion:

    {ts, seq, name: "route", traceparent?, request_id,
     client_request_id, outcome, path, why, key,
     primary, replica, prefill_replica, version, tenant,
     prompt_tokens, retries, excluded, hops,
     arrival_ts, done_ts, arrival_mono, done_mono, wall_s}

``path`` is the routing decision taxonomy — ``affinity`` (landed on
the chain-key ring primary), ``spill_load`` (bounded-load walk past a
hot primary), ``spill_drain`` (a candidate refused draining and the
request respilled), ``failover`` (a candidate failed
connection-shaped and the request retried on a survivor),
``fabric_migrated`` (prompt-heavy: prefill role -> socket KV handoff
-> decode role), ``fabric_fallback`` (handoff torn, re-prefilled
plain on the decode replica), ``direct`` (prompt-heavy but no usable
prefill-role replica; role-blind path) — and ``hops`` carries one
entry per forward attempt with the pick's WHY and monotonic stamps,
so a failed-over request's full story survives the process.

``ROUTER_RECORD_FIELDS`` is the authoritative record schema:
`tools/check_telemetry_names.py` verifies that every field
docs/observability.md's router-ledger table names exists here, and
vice versa — exactly the request ledger's contract.

Durability is the flight recorder's (telemetry/events.py): explicit
flush per append, size-capped rotation to ``<path>.1`` keeping the
newest records, a torn final line skipped on read — drilled through
the ``serve.router.record`` fault seam.

Emit discipline: with ``TIK_TELEMETRY=off`` or no journal installed,
``begin(...)`` returns None after attribute checks only and every
downstream hop/record call is a None test — the router daemon installs
the journal at boot (serve/router.py main); libraries never install.
``TIK_ROUTER_LOG_PATH`` / ``TIK_ROUTER_LOG_MAX_BYTES`` override the
defaults.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.faults import seams
from cloudtik_tpu_torch.telemetry import core, events
from cloudtik_tpu_torch.telemetry.events import EventJournal, read_file

RECORD_NAME = "route"

# Every field a router record may carry (the journal adds the envelope
# ts/seq/name/traceparent).  Keep docs/observability.md's "Router
# record fields" table in sync — tools/check_telemetry_names.py
# enforces it both directions.
ROUTER_RECORD_FIELDS = (
    "request_id", "client_request_id", "outcome", "path", "why",
    "key", "primary", "replica", "prefill_replica", "version",
    "tenant", "prompt_tokens", "retries", "excluded", "hops",
    "arrival_ts", "done_ts", "arrival_mono", "done_mono", "wall_s",
)

OUTCOME_OK = "ok"
OUTCOME_REJECTED = "rejected"
OUTCOME_ERROR = "error"

# the decision-path vocabulary (mirrors the router's spill/failover
# counters and the fabric's path counter — one taxonomy, two surfaces)
PATHS = ("affinity", "spill_load", "spill_drain", "failover",
         "fabric_migrated", "fabric_fallback", "direct")


def default_path() -> str:
    """`~/.tik/logs/serve-router.jsonl` (inside the shipped log dirs so
    the log agent and cluster dumps pick it up); TIK_ROUTER_LOG_PATH
    overrides."""
    override = os.environ.get("TIK_ROUTER_LOG_PATH")
    if override:
        return os.path.expanduser(override)
    from cloudtik_tpu_torch.utils.constants import tik_home
    return os.path.join(tik_home(), "logs", "serve-router.jsonl")


class RouterJournal(EventJournal):
    """The flight recorder's rotation/torn-line discipline, under the
    router ledger's own fault seam."""

    def _fire_seam(self, name: str) -> Optional[str]:
        return seams.fire("serve.router.record", name=name,
                          path=self.path)


# ------------------------------------------------------------- module api --

_SLOT = events.JournalSlot(RouterJournal, default_path,
                           "TIK_ROUTER_LOG_MAX_BYTES", "router ledger")


def install(path: Optional[str] = None,
            max_bytes: Optional[int] = None) -> RouterJournal:
    """Install the process router journal (router daemons, drills)."""
    return _SLOT.install(path, max_bytes)


def installed() -> Optional[RouterJournal]:
    return _SLOT.journal


def uninstall() -> None:
    _SLOT.uninstall()


class RouterTrail:
    """One routed request's decision story, accumulated across forward
    attempts.  Constructed ONLY by :func:`begin` once the journal and
    telemetry checks pass — the disabled path never allocates one, so
    every stamp site in the router is a plain ``trail is None`` test."""

    __slots__ = ("client_request_id", "tenant", "prompt_tokens", "key",
                 "prompt_heavy", "traceparent", "arrival_ts",
                 "arrival_mono", "hops")

    def __init__(self, client_request_id: Any, tenant: str,
                 prompt_tokens: int, key_hash: int, prompt_heavy: bool,
                 traceparent: Optional[str]):
        self.client_request_id = client_request_id
        self.tenant = tenant
        self.prompt_tokens = int(prompt_tokens)
        self.key = f"{key_hash:016x}"
        self.prompt_heavy = bool(prompt_heavy)
        self.traceparent = traceparent
        self.arrival_ts = time.time()
        self.arrival_mono = time.monotonic()
        self.hops: List[Dict[str, Any]] = []

    # -- per-attempt hooks (Router.handle's attempt closure) -------------
    def start_hop(self, replica: str, prefill_replica: Optional[str],
                  primary: bool, primary_rid: Optional[str],
                  why: Optional[str], spill: Optional[str],
                  version: Optional[str]) -> Dict[str, Any]:
        hop: Dict[str, Any] = {
            "replica": replica,
            "prefill_replica": prefill_replica,
            "primary": bool(primary),
            "primary_rid": primary_rid,
            "why": why,
            "spill": spill,              # "load" | None (pick-time)
            "version": version,
            "fabric": None,              # migrated|fallback|direct|None
            "kind": None,                # drain|failover|None (outcome)
            "error": None,
            "excluded": None,            # replica this failure excluded
            "start_ts": time.time(),
            "start_mono": time.monotonic(),
            "end_mono": None,
        }
        self.hops.append(hop)
        return hop

    @staticmethod
    def end_hop(hop: Dict[str, Any],
                error: Optional[BaseException] = None,
                kind: Optional[str] = None,
                excluded: Optional[str] = None,
                fabric: Optional[str] = None) -> None:
        hop["end_mono"] = time.monotonic()
        if error is not None:
            hop["error"] = f"{type(error).__name__}: {error}"
        hop["kind"] = kind
        hop["excluded"] = excluded
        if fabric is not None:
            hop["fabric"] = fabric

    # -- completion ------------------------------------------------------
    def _classify(self) -> tuple:
        """(path, why) for the record's final decision."""
        last = self.hops[-1] if self.hops else None
        if last is None:
            return None, ("no routable replica: the registry offered "
                          "no candidate to attempt")
        failed = [h for h in self.hops if h.get("error")]
        fabric = last.get("fabric")
        if fabric == "migrated":
            return "fabric_migrated", (
                f"prompt-heavy ({self.prompt_tokens} tokens): "
                f"chunk-prefilled on {last['prefill_replica']}, KV "
                f"blocks streamed to {last['replica']} over the "
                "socket transport")
        if fabric == "fallback":
            return "fabric_fallback", (
                f"prompt-heavy, but the KV handoff from "
                f"{last['prefill_replica']} tore mid-stream; "
                f"re-prefilled plain on {last['replica']}")
        if fabric == "direct":
            return "direct", (
                f"prompt-heavy ({self.prompt_tokens} tokens) but no "
                "usable prefill-role replica; degraded to the "
                "role-blind path")
        if any(h.get("kind") == "failover" for h in failed):
            lost = sorted({h["excluded"] for h in failed
                           if h.get("excluded")})
            return "failover", (
                f"{', '.join(lost) or 'a candidate'} failed "
                f"connection-shaped; retried on {last['replica']} "
                f"({last.get('why')})")
        if any(h.get("kind") == "drain" for h in failed):
            lost = sorted({h["excluded"] for h in failed
                           if h.get("excluded")})
            return "spill_drain", (
                f"{', '.join(lost) or 'a candidate'} refused draining "
                f"(503); respilled to {last['replica']}")
        if last.get("spill") == "load":
            return "spill_load", last.get("why")
        return "affinity", (last.get("why")
                            or "chain-key ring primary")

    def finish(self, outcome: str,
               result: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
        done_ts = time.time()
        done_mono = time.monotonic()
        last = self.hops[-1] if self.hops else None
        first = self.hops[0] if self.hops else None
        path, why = self._classify()
        return {
            # the REPLICA-side id the result carries is the join key
            # into that replica's request ledger; the client-side id
            # (the payload's, when the submitter stamped one) is kept
            # so failed requests — which produce no result — still
            # resolve by the id the caller knows
            "request_id": (result or {}).get("request_id"),
            "client_request_id": self.client_request_id,
            "outcome": outcome,
            "path": path,
            "why": why,
            "key": self.key,
            "primary": first.get("primary_rid") if first else None,
            "replica": last.get("replica") if last else None,
            "prefill_replica": (last.get("prefill_replica")
                                if last else None),
            "version": last.get("version") if last else None,
            "tenant": self.tenant,
            "prompt_tokens": self.prompt_tokens,
            "retries": sum(1 for h in self.hops if h.get("error")),
            "excluded": sorted({h["excluded"] for h in self.hops
                                if h.get("excluded")}),
            "hops": list(self.hops),
            "arrival_ts": self.arrival_ts,
            "done_ts": done_ts,
            "arrival_mono": self.arrival_mono,
            "done_mono": done_mono,
            "wall_s": max(done_mono - self.arrival_mono, 0.0),
        }


def begin(client_request_id: Any, tenant: str, prompt_tokens: int,
          key_hash: int, prompt_heavy: bool,
          traceparent: Optional[str]) -> Optional[RouterTrail]:
    """Start a decision trail for one routed request, or None.

    Fast path (telemetry off, or no journal installed) is attribute
    checks only — no allocation, no stamps; the router's single entry
    check, so every later hop call is a plain None test.
    """
    if not core.STATE.enabled:
        return None
    if _SLOT.journal is None:
        return None
    return RouterTrail(client_request_id, tenant, prompt_tokens,
                       key_hash, prompt_heavy, traceparent)


def record(trail: Optional[RouterTrail], outcome: str,
           result: Optional[Dict[str, Any]] = None) -> None:
    """Append the trail's record (no-op for a None trail)."""
    if trail is None:
        return
    journal = _SLOT.journal
    if journal is None:
        return
    fields = trail.finish(outcome, result)
    with core.trace_context(trail.traceparent):
        _SLOT.guarded_append(journal, RECORD_NAME, fields)


# --------------------------------------------------------------- readers --

def journal_files(path: Optional[str] = None) -> List[str]:
    """Existing ledger files for `path` (default: the installed
    journal's path, else default_path()), oldest first."""
    return _SLOT.files(path)


def read_routes(path: Optional[str] = None) -> List[Dict[str, Any]]:
    """All router records (rotated generation first — append order for
    a single writer), torn lines skipped."""
    out: List[Dict[str, Any]] = []
    for p in journal_files(path):
        records, _skipped = read_file(p)
        out.extend(r for r in records if r.get("name") == RECORD_NAME)
    return out
