"""Request forensics: stitch one request's story across the fleet.

A routed request leaves up to three durable trails — the router's
decision ledger (serve/routerlog.py: which replica and WHY, per hop),
the prefill replica's request ledger record (finish="migrated") and
the finishing replica's record with the five-phase TTFT decomposition
(serve/reqlog.py).  This module joins them into ONE timeline:

  * find the router record by the id the caller knows (the replica-side
    id the result carried, or the client-side id the submitter stamped);
  * join every replica's request-ledger records transitively —
    ``request_id`` matches the router record's id, and the decode
    record's ``migrated_from`` walks back to the prefill replica's
    "migrated" record — disambiguated by trace id when per-process id
    counters collide across replicas;
  * render the phases in wall order (they telescope from the finishing
    record's arrival), flag the critical-path phase, and show the
    router's WHY sentence for every hop, failed ones included.

``tik serve explain <request-id>`` is the operator surface;
``fleet_requests`` backs ``tik serve requests --fleet`` (N reqlog
sources merged into one population).  Everything here is a reader —
no journal is ever installed or written by this module.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from cloudtik_tpu_torch.serve import reqlog, routerlog

# terminal finishes — the record that carries the phase decomposition
# (a "migrated" record is a milestone on the prefill side, not an end)
_TERMINAL = (reqlog.FINISH_DONE, reqlog.FINISH_CANCELLED,
             reqlog.FINISH_REJECTED, reqlog.FINISH_ERROR,
             reqlog.FINISH_DRAINED)


def trace_id(traceparent: Optional[str]) -> Optional[str]:
    """The 32-hex trace id out of a W3C traceparent, or None."""
    if not traceparent:
        return None
    parts = traceparent.split("-")
    return parts[1] if len(parts) >= 2 else None


def _same_id(a: Any, b: Any) -> bool:
    """Request ids compare as strings: the CLI hands us text, the
    ledgers hold ints."""
    return a is not None and b is not None and str(a) == str(b)


def _trace_compatible(rec: Dict[str, Any],
                      tid: Optional[str]) -> bool:
    """A record joins only if its trace agrees (or either side has
    none): per-process id counters WILL collide across replicas, and
    the traceparent every record is stamped with is the tiebreak."""
    if tid is None:
        return True
    rec_tid = trace_id(rec.get("traceparent"))
    return rec_tid is None or rec_tid == tid


def find_route(routes: Sequence[Dict[str, Any]],
               request_id: Any) -> Optional[Dict[str, Any]]:
    """The router record for `request_id` — matched against the
    replica-side id the result carried OR the client-side id the
    submitter stamped (a failed request never produced a result, so
    the client id is the only handle the caller has).  Newest wins
    (ids recycle across restarts; the operator is asking about the
    recent one)."""
    for rec in reversed(list(routes)):
        if _same_id(rec.get("request_id"), request_id) \
                or _same_id(rec.get("client_request_id"), request_id):
            return rec
    return None


def find_requests(records: Sequence[Dict[str, Any]], request_id: Any,
                  tid: Optional[str] = None) -> List[Dict[str, Any]]:
    """Every request-ledger record in `request_id`'s story, prefill
    first: records whose own id or ``migrated_from`` matches, plus the
    transitive walk decode-record -> ``migrated_from`` -> the prefill
    replica's "migrated" record."""
    ids = {str(request_id)}
    # transitive closure: a decode record joined by request_id names
    # its prefill origin in migrated_from; a prefill record joined by
    # origin id is already terminal in the walk
    for _ in range(4):               # fabric chains are short
        grew = False
        for rec in records:
            if not _trace_compatible(rec, tid):
                continue
            rid = rec.get("request_id")
            origin = rec.get("migrated_from")
            if rid is not None and str(rid) in ids \
                    and origin is not None and str(origin) not in ids:
                ids.add(str(origin))
                grew = True
            if origin is not None and str(origin) in ids \
                    and rid is not None and str(rid) not in ids:
                ids.add(str(rid))
                grew = True
        if not grew:
            break
    hits = [rec for rec in records
            if _trace_compatible(rec, tid)
            and (str(rec.get("request_id")) in ids
                 or (rec.get("migrated_from") is not None
                     and str(rec.get("migrated_from")) in ids))]
    # prefill-side milestones first, the finishing record last, stable
    # on the journal's wall stamp otherwise
    hits.sort(key=lambda r: (r.get("finish") in _TERMINAL,
                             r.get("ts") or 0.0))
    return hits


def finishing_record(records: Sequence[Dict[str, Any]]
                     ) -> Optional[Dict[str, Any]]:
    """The record that actually finished the request (carries the
    phase decomposition); None when only milestones survived."""
    for rec in reversed(list(records)):
        if rec.get("finish") in _TERMINAL:
            return rec
    return None


def build(request_id: Any,
          routes: Sequence[Dict[str, Any]],
          requests: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Join the ledgers into one explain structure (the CLI renders
    it; tests assert on it directly).

    Returns {request_id, route, records, finishing, phases, timeline,
    critical_phase, wall_s, phase_sum_s, phase_coverage} — `timeline`
    is [(phase, start_s, end_s, seconds)] cumulative from the
    finishing record's arrival, in wall order; `phase_coverage` is
    phase_sum/wall (1.0 = the decomposition accounts for the whole
    request)."""
    route = find_route(routes, request_id)
    tid = trace_id(route.get("traceparent")) if route else None
    join_id = request_id
    if route is not None and route.get("request_id") is not None:
        join_id = route["request_id"]
    recs = find_requests(requests, join_id, tid)
    if not recs and route is not None \
            and route.get("client_request_id") is not None:
        recs = find_requests(requests, route["client_request_id"], tid)
    finishing = finishing_record(recs)

    phases: Dict[str, Optional[float]] = {
        f: None for f in reqlog.PHASE_FIELDS}
    timeline: List[Tuple[str, float, float, float]] = []
    critical: Optional[str] = None
    phase_sum = 0.0
    wall: Optional[float] = None
    if finishing is not None:
        arrival = finishing.get("arrival_mono")
        done = finishing.get("done_mono")
        if arrival is not None and done is not None:
            wall = max(float(done) - float(arrival), 0.0)
        cursor = 0.0
        for field in reqlog.PHASE_FIELDS:
            value = finishing.get(field)
            if not isinstance(value, (int, float)):
                continue
            value = float(value)
            phases[field] = value
            timeline.append((field, cursor, cursor + value, value))
            cursor += value
            phase_sum += value
        if timeline:
            critical = max(timeline, key=lambda t: t[3])[0]
    if wall is None and route is not None:
        wall = route.get("wall_s")
    coverage = (phase_sum / wall) if wall else None
    return {
        "request_id": request_id,
        "route": route,
        "records": recs,
        "finishing": finishing,
        "phases": phases,
        "timeline": timeline,
        "critical_phase": critical,
        "wall_s": wall,
        "phase_sum_s": phase_sum,
        "phase_coverage": coverage,
    }


def render(explain: Dict[str, Any]) -> str:
    """The operator view: hops with their WHY, then the phase
    timeline with the critical path flagged."""
    lines: List[str] = []
    route = explain.get("route")
    finishing = explain.get("finishing")
    rid = explain.get("request_id")
    if route is None and not explain.get("records"):
        return (f"request {rid}: no router record and no ledger "
                "records found — wrong --path/--reqlog, or the "
                "journals rotated past it")

    head = [f"request {rid}"]
    if route is not None:
        head.append(f"path={route.get('path')}")
        head.append(f"outcome={route.get('outcome')}")
        if route.get("wall_s") is not None:
            head.append(f"router wall {route['wall_s'] * 1e3:.1f}ms")
    elif finishing is not None:
        head.append(f"finish={finishing.get('finish')}")
    lines.append("  ".join(head))

    if route is not None:
        lines.append(f"  why: {route.get('why')}")
        primary = route.get("primary")
        served = route.get("replica")
        ring = f"  ring primary {primary}" if primary else "  no ring"
        if served and served != primary:
            ring += f" -> served by {served}"
        elif served:
            ring += " (served there)"
        if route.get("prefill_replica"):
            ring += f", prefill on {route['prefill_replica']}"
        if route.get("version") is not None:
            ring += f", version {route['version']}"
        lines.append(ring)
        if route.get("excluded"):
            lines.append(f"  excluded after failures: "
                         f"{', '.join(route['excluded'])} "
                         f"({route.get('retries', 0)} retried "
                         f"hop(s))")
        for i, hop in enumerate(route.get("hops") or [], 1):
            target = hop.get("replica")
            if hop.get("prefill_replica"):
                target = f"{hop['prefill_replica']} -> {target}"
            start = hop.get("start_mono")
            end = hop.get("end_mono")
            took = (f" [{(end - start) * 1e3:.1f}ms]"
                    if isinstance(start, (int, float))
                    and isinstance(end, (int, float)) else "")
            if hop.get("error"):
                outcome = (f"FAILED ({hop.get('kind')}, excluded "
                           f"{hop.get('excluded')}): {hop['error']}")
            elif hop.get("fabric"):
                outcome = f"served via {hop['fabric']}"
            else:
                outcome = "served"
            lines.append(f"  hop {i}: {target} — {outcome}{took}")
            if hop.get("why"):
                lines.append(f"         why: {hop['why']}")

    for rec in explain.get("records") or []:
        tag = ("milestone" if rec.get("finish")
               == reqlog.FINISH_MIGRATED else "finishing")
        lines.append(
            f"  record: replica={rec.get('replica') or '-'} "
            f"request_id={rec.get('request_id')} "
            f"finish={rec.get('finish')} ({tag})"
            + (f" migrated_from={rec['migrated_from']}"
               if rec.get("migrated_from") is not None else ""))

    if explain.get("timeline"):
        lines.append("  phases (wall order, cumulative from arrival):")
        for phase, start, end, seconds in explain["timeline"]:
            flag = ("   <- critical path"
                    if phase == explain.get("critical_phase") else "")
            lines.append(f"    {phase:<15} {start * 1e3:9.1f}ms -> "
                         f"{end * 1e3:9.1f}ms  {seconds * 1e3:9.1f}ms"
                         f"{flag}")
        wall = explain.get("wall_s")
        cov = explain.get("phase_coverage")
        if wall is not None and cov is not None:
            lines.append(
                f"  phases sum {explain['phase_sum_s'] * 1e3:.1f}ms = "
                f"{cov * 100.0:.1f}% of the finishing record's wall "
                f"({wall * 1e3:.1f}ms)")
    elif finishing is None:
        lines.append("  no finishing record found (request still in "
                     "flight, or its replica's ledger was not given "
                     "via --reqlog)")
    return "\n".join(lines)


def filter_trace(trace: Dict[str, Any],
                 traceparent: Optional[str]) -> Dict[str, Any]:
    """A Chrome-trace export (telemetry/export.chrome_trace shape)
    narrowed to one request's trace id — spans that never recorded a
    trace id are dropped too (they cannot belong to this request's
    stitched story)."""
    tid = trace_id(traceparent)
    events = [
        e for e in trace.get("traceEvents", [])
        if (e.get("args") or {}).get("trace_id") == tid
    ] if tid else []
    return {"traceEvents": events,
            "displayTimeUnit": trace.get("displayTimeUnit", "ms")}


# ------------------------------------------------------------ fleet view --

def fleet_requests(paths: Sequence[str]) -> List[Dict[str, Any]]:
    """Merge N replicas' request ledgers into one population (`tik
    serve requests --fleet`), ordered by wall stamp so tails interleave
    the way the fleet actually served them."""
    records: List[Dict[str, Any]] = []
    for path in paths:
        records.extend(reqlog.read_requests(path))
    records.sort(key=lambda r: r.get("ts") or 0.0)
    return records


def load(router_path: Optional[str] = None,
         reqlog_paths: Sequence[str] = ()
         ) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """(router records, request records) from the given sources —
    defaults to each ledger family's installed/default path."""
    routes = routerlog.read_routes(router_path)
    paths = list(reqlog_paths) or [None]
    requests: List[Dict[str, Any]] = []
    for path in paths:
        requests.extend(reqlog.read_requests(path))
    requests.sort(key=lambda r: r.get("ts") or 0.0)
    return routes, requests
