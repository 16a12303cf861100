"""Request-lifecycle ledger: one durable JSONL record per serve request.

Histograms answer "how slow is serving right now"; the request ledger
answers "what happened to request 714" and "what were the REAL p99s over
the last hour" — per-request records survive the process, so offline
percentiles and availability are computed from the actual population
instead of fixed histogram buckets.  `DecodeEngine._finish_request`
appends one record per completed request:

    {ts, seq, name: "request", traceparent?, request_id, finish,
     bucket, replica, version                     (which engine, which
                                                   deployment version),
     prompt_tokens, output_tokens,
     kv_blocks, prefix_blocks, prefix_tokens, prefill_chunks,
     preemptions                                  (paged KV cache),
     migrations, migrated_tokens,
     migrated_from, path                          (KV-block migration:
                                                   the prefill-side
                                                   origin id + the
                                                   fabric path taken),
     draft_tokens, accepted_tokens, spec_steps    (speculative decode),
     arrival_ts/admitted_ts/first_token_ts/done_ts           (epoch),
     arrival_mono/admitted_mono/first_token_mono/done_mono   (monotonic),
     queue_wait_s, ttft_s, tpot_s,
     router_wait_s/prefill_s/handoff_wire_s/decode_first_s/decode_rest_s
                                    (per-phase TTFT decomposition)}

``RECORD_FIELDS`` is the authoritative record schema:
`tools/check_telemetry_names.py` verifies that every field
docs/observability.md's ledger table names exists here, and vice versa
— the ledger docs stay honest as fields are added.

``finish`` is one of ``done | cancelled | rejected | error | drained |
migrated`` (drained = the engine shut down with the request still in
flight; rejected = refused at submit — empty or over-length prompt;
migrated = the prompt-owning engine exported the KV and the request
lives on at the decode replica, whose record joins back through
``migrated_from``).
Durability is
the flight recorder's (telemetry/events.py): explicit flush per append,
size-capped rotation to ``<path>.1`` keeping the newest records, a torn
final line skipped on read — drilled through the ``serve.reqlog.append``
fault seam.  ``tik serve requests [--tail|--stats|--since|--finish]``
replays the ledger and computes offline p50/p95/p99 + availability.

Emit discipline: ``reqlog.record(...)`` with ``TIK_TELEMETRY=off`` or no
journal installed is attribute checks only.  The serving daemon installs
the journal at boot (serve/server.py main); libraries never install.
``TIK_REQLOG_PATH`` / ``TIK_REQLOG_MAX_BYTES`` override the defaults.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.faults import seams
from cloudtik_tpu_torch.telemetry import core, events
from cloudtik_tpu_torch.telemetry.events import EventJournal, read_file

RECORD_NAME = "request"

# Every field a request record may carry (the journal adds the envelope
# ts/seq/name/traceparent).  Keep docs/observability.md's "Record
# fields" table in sync — tools/check_telemetry_names.py enforces it.
RECORD_FIELDS = (
    "request_id", "finish", "tenant", "adapter_id", "bucket",
    "replica", "version",
    "prompt_tokens", "output_tokens",
    "kv_blocks", "prefix_blocks", "prefix_tokens", "prefill_chunks",
    "preemptions",
    "migrations", "migrated_tokens", "migrated_from", "path",
    "draft_tokens", "accepted_tokens", "spec_steps",
    "arrival_ts", "admitted_ts", "first_token_ts", "done_ts",
    "arrival_mono", "admitted_mono", "first_token_mono", "done_mono",
    "queue_wait_s", "ttft_s", "tpot_s",
    "router_wait_s", "prefill_s", "handoff_wire_s",
    "decode_first_s", "decode_rest_s",
)

# the five lifecycle phases every finishing record decomposes its wall
# into (tik_serve_phase_seconds is the fleet histogram twin; `tik serve
# explain` renders them per request).  They telescope: the non-None
# phases sum to the record's wall (done - arrival) up to clock skew on
# cross-host handoffs.
PHASE_FIELDS = ("router_wait_s", "prefill_s", "handoff_wire_s",
                "decode_first_s", "decode_rest_s")

FINISH_DONE = "done"
FINISH_CANCELLED = "cancelled"
FINISH_REJECTED = "rejected"
FINISH_ERROR = "error"
FINISH_DRAINED = "drained"
# the prompt-owning engine exported the KV and the request lives on at
# the decode replica — a lifecycle milestone, not a terminal outcome,
# so it spends no availability budget (not in the denominator below)
FINISH_MIGRATED = "migrated"
FINISH_REASONS = (FINISH_DONE, FINISH_CANCELLED, FINISH_REJECTED,
                  FINISH_ERROR, FINISH_DRAINED, FINISH_MIGRATED)


def default_path() -> str:
    """`~/.tik/logs/serve-requests.jsonl` (inside the shipped log dirs
    so the log agent and cluster dumps pick it up); TIK_REQLOG_PATH
    overrides."""
    override = os.environ.get("TIK_REQLOG_PATH")
    if override:
        return os.path.expanduser(override)
    from cloudtik_tpu_torch.utils.constants import tik_home
    return os.path.join(tik_home(), "logs", "serve-requests.jsonl")


class RequestJournal(EventJournal):
    """The flight recorder's rotation/torn-line discipline, under the
    request ledger's own fault seam."""

    def _fire_seam(self, name: str) -> Optional[str]:
        return seams.fire("serve.reqlog.append", name=name,
                          path=self.path)


# ------------------------------------------------------------- module api --

# the install/uninstall/file-listing/warn-once discipline lives once, in
# events.JournalSlot — this module only owns its journal class, env
# knobs, and the per-request record shape
_SLOT = events.JournalSlot(RequestJournal, default_path,
                           "TIK_REQLOG_MAX_BYTES", "request ledger")


def install(path: Optional[str] = None,
            max_bytes: Optional[int] = None) -> RequestJournal:
    """Install the process request journal (serving daemons, benches)."""
    return _SLOT.install(path, max_bytes)


def installed() -> Optional[RequestJournal]:
    return _SLOT.journal


def uninstall() -> None:
    _SLOT.uninstall()


def record(req, finish: str) -> None:
    """Append one request-lifecycle record for a finished Request.

    Fast path (telemetry off, or no journal installed) is attribute
    checks only — no field derivation, no serialization, no I/O.
    """
    if not core.STATE.enabled:
        return
    journal = _SLOT.journal
    if journal is None:
        return
    engine = getattr(req, "_engine", None)
    fields: Dict[str, Any] = {
        "request_id": req.request_id,
        "finish": finish,
        # multi-tenant serving: which product the request belongs to
        # and which LoRA adapter decoded it (None = base model) —
        # `tik serve requests --stats --by tenant` groups on these
        "tenant": getattr(req, "tenant", "default"),
        "adapter_id": getattr(req, "adapter_id", None),
        "bucket": getattr(req, "bucket", None),
        # which engine finished the request, and which deployment
        # version it ran — `tik serve requests --fleet` merges many
        # replicas' ledgers, so the record must say whose it is
        "replica": getattr(engine, "replica_id", None),
        "version": getattr(engine, "version", None),
        "prompt_tokens": len(req.prompt),
        "output_tokens": len(req.tokens),
        # paged KV cache accounting (serve/kvcache.py)
        "kv_blocks": getattr(req, "kv_blocks", None),
        "prefix_blocks": getattr(req, "prefix_blocks", None),
        "prefix_tokens": getattr(req, "prefix_tokens", None),
        "prefill_chunks": getattr(req, "prefill_chunks", None),
        "preemptions": getattr(req, "preemptions", None),
        # KV-block migration (serve/migration.py — disaggregated
        # prefill/decode: tokens whose KV was imported, not recomputed)
        "migrations": getattr(req, "migrations", None),
        "migrated_tokens": getattr(req, "migrated_tokens", None),
        # cross-process join key: the prefill-side request id this one
        # continued from (None = never migrated) — `tik serve explain`
        # stitches the prefill replica's "migrated" record through it
        "migrated_from": getattr(req, "migrated_from", None),
        # which fabric path finished it: migrated | fallback | None
        # (plain/monolithic) — the replica-side echo of the router
        # ledger's decision path
        "path": getattr(req, "fabric_path", None),
        # speculative decoding (EngineConfig.spec draft/verify loop)
        "draft_tokens": getattr(req, "draft_tokens", None),
        "accepted_tokens": getattr(req, "accepted_tokens", None),
        "spec_steps": getattr(req, "spec_steps", None),
        "arrival_ts": req.created,
        "admitted_ts": req.admitted,
        "first_token_ts": req.first_token_time,
        "done_ts": req.done_time,
        "arrival_mono": getattr(req, "created_mono", None),
        "admitted_mono": getattr(req, "admitted_mono", None),
        "first_token_mono": getattr(req, "first_token_mono", None),
        "done_mono": getattr(req, "done_mono", None),
    }
    fields.update(derive_latencies(fields))
    fields.update(derive_phases(req))
    # the record carries the REQUEST's trace (the submit-side span),
    # not whatever ambient context the finishing thread happens to
    # hold — `tik serve requests` joins `tik cluster trace export`
    # through it
    with core.trace_context(getattr(req, "traceparent", None)):
        _SLOT.guarded_append(journal, RECORD_NAME, fields)


def derive_latencies(fields: Dict[str, Any]) -> Dict[str, Any]:
    """queue_wait/TTFT/TPOT from the monotonic lifecycle stamps."""
    arrival = fields.get("arrival_mono")
    admitted = fields.get("admitted_mono")
    first = fields.get("first_token_mono")
    done = fields.get("done_mono")
    out_tokens = fields.get("output_tokens") or 0
    out: Dict[str, Any] = {
        "queue_wait_s": None, "ttft_s": None, "tpot_s": None}
    if arrival is not None and admitted is not None:
        out["queue_wait_s"] = max(admitted - arrival, 0.0)
    if arrival is not None and first is not None:
        out["ttft_s"] = max(first - arrival, 0.0)
    if first is not None and done is not None and out_tokens > 1:
        out["tpot_s"] = max(done - first, 0.0) / (out_tokens - 1)
    return out


def derive_phases(req) -> Dict[str, Any]:
    """The five-phase TTFT decomposition from the request's stamps.

    Telescoping by construction, so the non-None phases sum to the
    record's wall.  Two shapes:

    * plain / monolithic (no ``import_mono``): router_wait = submit ->
      slot admission, prefill = admission -> first token (or -> KV
      export start for a prefill-side "migrated" record), decode_rest =
      first token -> done — all from the local monotonic stamps.
    * migrated-in decode side (``import_mono`` present): the prefill
      half rides the migration header's WALL stamps (prefill_admitted /
      export_started — the same skew-bounded cross-host discipline as
      `request_from_header`'s created back-dating, exact in-process),
      handoff_wire = export start -> import arrival, and the decode
      half (decode_first/decode_rest) is local monotonic again.

    A fabric-fallback request has its admission stamps reset at the
    tear and re-stamped by the decode engine, so it takes the plain
    shape — the torn prefill attempt books into router_wait (`tik serve
    explain` names the tear from the router ledger instead).
    """
    out: Dict[str, Any] = {f: None for f in PHASE_FIELDS}
    first = getattr(req, "first_token_mono", None)
    done = getattr(req, "done_mono", None)
    import_mono = getattr(req, "import_mono", None)
    if import_mono is not None:
        arrival_ts = getattr(req, "created", None)
        admitted_ts = getattr(req, "prefill_admitted_ts", None)
        export_ts = getattr(req, "export_started_ts", None)
        import_ts = getattr(req, "import_ts", None)
        if arrival_ts is not None and admitted_ts is not None:
            out["router_wait_s"] = max(admitted_ts - arrival_ts, 0.0)
        if admitted_ts is not None and export_ts is not None:
            out["prefill_s"] = max(export_ts - admitted_ts, 0.0)
        if export_ts is not None and import_ts is not None:
            out["handoff_wire_s"] = max(import_ts - export_ts, 0.0)
        if first is not None:
            out["decode_first_s"] = max(first - import_mono, 0.0)
    else:
        arrival = getattr(req, "created_mono", None)
        admitted = getattr(req, "admitted_mono", None)
        # a prefill-side "migrated" record never decodes: its prefill
        # phase ends where the KV export began
        prefill_end = first if first is not None \
            else getattr(req, "export_mono", None)
        if arrival is not None and admitted is not None:
            out["router_wait_s"] = max(admitted - arrival, 0.0)
        if admitted is not None and prefill_end is not None:
            out["prefill_s"] = max(prefill_end - admitted, 0.0)
    if first is not None and done is not None:
        out["decode_rest_s"] = max(done - first, 0.0)
    return out


# --------------------------------------------------------------- readers --

def journal_files(path: Optional[str] = None) -> List[str]:
    """Existing ledger files for `path` (default: the installed
    journal's path, else default_path()), oldest first."""
    return _SLOT.files(path)


def read_requests(path: Optional[str] = None) -> List[Dict[str, Any]]:
    """All ledger records (rotated generation first — append order for a
    single writer), torn lines skipped."""
    out: List[Dict[str, Any]] = []
    for p in journal_files(path):
        records, _skipped = read_file(p)
        out.extend(r for r in records if r.get("name") == RECORD_NAME)
    return out


# ------------------------------------------------------- offline stats --

def percentile(values: List[float], q: float) -> Optional[float]:
    """Linear-interpolated percentile of the actual population (not
    bucket bounds — the ledger holds every request)."""
    if not values:
        return None
    vs = sorted(values)
    rank = (len(vs) - 1) * q
    lo = math.floor(rank)
    hi = math.ceil(rank)
    if lo == hi:
        return vs[lo]
    frac = rank - lo
    return vs[lo] * (1.0 - frac) + vs[hi] * frac


def compute_stats(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Offline p50/p95/p99 and availability over ledger records.

    Availability = done / (done + error + drained): cancellations and
    submit-time rejections are client-caused, so they consume no error
    budget — the same exclusion the `serve-availability` SLO applies
    to the `result` counter labels (telemetry/slo.py).  A "migrated"
    record is a lifecycle milestone (the request finished elsewhere),
    so it spends nothing either.
    """
    finish: Dict[str, int] = {}
    for rec in records:
        reason = rec.get("finish", "unknown")
        finish[reason] = finish.get(reason, 0) + 1
    served = finish.get(FINISH_DONE, 0)
    denominator = served + finish.get(FINISH_ERROR, 0) \
        + finish.get(FINISH_DRAINED, 0)
    stats: Dict[str, Any] = {
        "count": len(records),
        "finish": dict(sorted(finish.items())),
        "availability": served / denominator if denominator else None,
    }
    for field in ("ttft_s", "queue_wait_s", "tpot_s") + PHASE_FIELDS:
        values = [float(rec[field]) for rec in records
                  if isinstance(rec.get(field), (int, float))]
        stats[field] = {
            "count": len(values),
            "p50": percentile(values, 0.50),
            "p95": percentile(values, 0.95),
            "p99": percentile(values, 0.99),
        }
    # paged-KV aggregates: how much prompt work the prefix cache saved,
    # how many chunks prefill took, and how much preemption churn the
    # population survived (zeros when the records predate the fields)
    for field in ("prompt_tokens", "prefix_tokens", "prefill_chunks",
                  "preemptions", "migrations", "migrated_tokens",
                  "draft_tokens", "accepted_tokens",
                  "spec_steps"):
        stats[field] = sum(
            rec[field] for rec in records
            if isinstance(rec.get(field), (int, float)))
    # speculative decoding: how often the draft's proposals survived
    # the target verify, and how many tokens each verify round emitted
    # (accepted + the target's mismatch/bonus token)
    draft = stats["draft_tokens"]
    steps = stats["spec_steps"]
    stats["spec_acceptance_rate"] = \
        stats["accepted_tokens"] / draft if draft else None
    stats["spec_tokens_per_verify"] = \
        (stats["accepted_tokens"] + steps) / steps if steps else None
    return stats


def group_stats(records: List[Dict[str, Any]], by: str = "tenant"
                ) -> Dict[str, Dict[str, Any]]:
    """Per-group offline stats (`tik serve requests --stats --by
    tenant`): records grouped on field `by`, compute_stats each.
    Records predating the field land under "default" for tenant
    grouping (every request has a tenant, "default" included) and
    under "-" otherwise."""
    groups: Dict[str, List[Dict[str, Any]]] = {}
    for rec in records:
        key = rec.get(by)
        if key is None:
            key = "default" if by == "tenant" else "-"
        groups.setdefault(str(key), []).append(rec)
    return {key: compute_stats(recs)
            for key, recs in sorted(groups.items())}
