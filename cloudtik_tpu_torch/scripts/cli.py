"""`tik` — the CLI, on a host without JAX.

Port of `cloudtik_tpu/scripts/cli.py`'s operator commands over the port's
own records, run as `python -m cloudtik_tpu_torch.scripts.cli`: the root
group, `cluster trace export|summary` (the port's trace collector, which
also scrapes the serving process's `serving-telemetry` job), `events
dump|tail` (the flight recorder; `--path` reads the port's
`events-torch.jsonl`) and `serve requests|replicas|explain` (the request
and router ledgers, the router's HTTP views).  Every option, output format
and exit code is the reference's.  It imports nothing of JAX, so it runs
where the card runs; the reference's commands that need the control plane
(`start`, `up`, `chaos`, ...) stay in the reference's CLI.
"""

from __future__ import annotations

import json
import os
import sys

import click

import cloudtik_tpu_torch
from cloudtik_tpu_torch.utils.cli_logger import cli_logger


@click.group()
@click.version_option(cloudtik_tpu_torch.__version__, prog_name="tik")
@click.option("-v", "--verbose", count=True, help="Increase verbosity.")
def cli(verbose: int):
    cli_logger.verbosity = verbose


# ---------------------------------------------------------------- cluster --

@cli.group()
def cluster():
    """Cluster-wide observability aggregated on the head
    (docs/observability.md)."""


@cluster.group(name="trace")
def cluster_trace():
    """Cross-node traces: scrape every node's /trace endpoint
    (discovered from the prometheus runtime's file-SD targets) and
    stitch the spans by trace_id into one Chrome-trace with a process
    lane per node."""


def _trace_collector(conf_dir):
    from cloudtik_tpu_torch.runtimes.prometheus.trace_collector import (
        TraceCollector)
    if conf_dir is None:
        from cloudtik_tpu_torch.utils.constants import tik_home
        conf_dir = os.path.join(tik_home(), "prometheus")
    return TraceCollector(conf_dir)


_conf_dir_opt = click.option(
    "--conf-dir", default=None,
    help="Prometheus file-SD config dir holding targets.json "
         "(default: <tik home>/prometheus).")


@cluster_trace.command(name="export")
@_conf_dir_opt
@click.option("--trace-id", default=None,
              help="Only spans of this trace.")
@click.option("--output", "-o", default=None,
              help="Write the stitched Chrome-trace here "
                   "(default: stdout).")
def cluster_trace_export(conf_dir, trace_id, output):
    """Export one stitched Chrome-trace across all nodes."""
    collector = _trace_collector(conf_dir)
    trace, sources = collector.export(trace_id=trace_id)
    if not sources:
        raise click.ClickException(
            "no trace targets discovered (is targets.json rendered? "
            "see docs/observability.md)")
    for source in sources:
        if source["error"]:
            cli_logger.warning("target {} unreachable: {}",
                               source["address"], source["error"])
    if output:
        with open(output, "w") as f:
            json.dump(trace, f, indent=1)
        cli_logger.success(
            "Wrote {} events from {} node(s) to {}.",
            len(trace["traceEvents"]),
            sum(1 for s in sources if s["events"]), output)
    else:
        click.echo(json.dumps(trace, indent=1))


@cluster_trace.command(name="summary")
@_conf_dir_opt
@click.option("--trace-id", default=None,
              help="Only this trace.")
def cluster_trace_summary(conf_dir, trace_id):
    """Per-trace span counts, node lanes, and wall extents."""
    collector = _trace_collector(conf_dir)
    rows = collector.summary()
    if trace_id:
        rows = [r for r in rows if r["trace_id"] == trace_id]
    if not rows:
        cli_logger.info("No traces collected.")
        return
    click.echo(f"{'trace':<34}  {'spans':>5}  {'nodes':>5}  "
               f"{'duration':>10}  root")
    for row in rows:
        click.echo(
            f"{row['trace_id']:<34}  {row['spans']:>5}  "
            f"{len(row['nodes']):>5}  "
            f"{row['duration_s'] * 1e3:>8.2f}ms  {row['root']}")


# ----------------------------------------------------------------- events --

@cli.group(name="events")
def events_group():
    """Flight recorder: the durable JSONL journal of control-plane
    decisions (docs/observability.md).  Each record carries the
    traceparent active when it was written, linking the WHY to the
    distributed trace of the operation."""


_events_path_opt = click.option(
    "--path", default=None,
    help="Journal path (default: <tik home>/logs/events.jsonl).")


def _format_event(record):
    import datetime as _dt
    ts = _dt.datetime.fromtimestamp(record.get("ts", 0)).strftime(
        "%Y-%m-%d %H:%M:%S.%f")[:-3]
    name = record.get("name", "?")
    extras = " ".join(
        f"{k}={v}" for k, v in record.items()
        if k not in ("ts", "seq", "name"))
    return f"{ts}  {name}  {extras}".rstrip()


@events_group.command(name="dump")
@_events_path_opt
@click.option("--json", "as_json", is_flag=True,
              help="Emit raw records as a JSON array.")
@click.option("--trace-id", default=None,
              help="Only events stamped with this trace.")
def events_dump(path, as_json, trace_id):
    """Replay the journal, causally ordered (torn lines skipped)."""
    from cloudtik_tpu_torch.telemetry import events as tevents
    records = tevents.read_events(path)
    if trace_id:
        records = [r for r in records
                   if trace_id in r.get("traceparent", "")]
    records.sort(key=lambda r: r.get("ts", 0))
    if as_json:
        click.echo(json.dumps(records, indent=1, default=str))
        return
    if not records:
        cli_logger.info("No events recorded.")
        return
    for record in records:
        click.echo(_format_event(record))


@events_group.command(name="tail")
@_events_path_opt
@click.option("--lines", "-n", default=10, show_default=True)
@click.option("--follow", "-f", is_flag=True,
              help="Keep streaming appended events.")
def events_tail(path, lines, follow):
    """Show the newest journal events; -f follows appends."""
    import time as _time

    from cloudtik_tpu_torch.telemetry import events as tevents
    records = tevents.read_events(path)
    for record in records[-lines:]:
        click.echo(_format_event(record))
    if not follow:
        return
    files = tevents.journal_files(path)
    offset = os.path.getsize(files[-1]) if files else 0
    try:
        while True:
            _time.sleep(0.5)
            files = tevents.journal_files(path)
            if not files:
                continue
            current = files[-1]
            size = os.path.getsize(current)
            if size < offset:        # rotated under us
                offset = 0
            if size == offset:
                continue
            with open(current, "rb") as f:
                f.seek(offset)
                chunk = f.read()
            # only complete lines: the tail may be mid-append
            complete, _, _rest = chunk.rpartition(b"\n")
            offset += len(complete) + 1 if complete else 0
            for line in complete.splitlines():
                try:
                    click.echo(_format_event(json.loads(line)))
                except ValueError:
                    continue
    except KeyboardInterrupt:
        pass


# ------------------------------------------------------------------ serve --

@cli.group(name="serve")
def serve_group():
    """Serving observability: the request-lifecycle ledger and the
    router decision ledger (docs/observability.md "Request ledger" /
    "Request forensics").  Engines append one durable JSONL record per
    finished request, the router one per routed request; these verbs
    replay them — offline percentiles/availability (`requests`),
    fleet membership (`replicas`), and one request's stitched
    cross-replica story (`explain`)."""


@serve_group.command(name="requests")
@click.option("--path", "paths", multiple=True,
              help="Ledger path (default: <tik home>/logs/"
                   "serve-requests.jsonl; TIK_REQLOG_PATH overrides). "
                   "Repeat for multiple replicas' ledgers — the "
                   "populations merge into one fleet view.")
@click.option("--fleet", "as_fleet", is_flag=True,
              help="With --stats: add a per-replica breakdown after "
                   "the merged population (shorthand for running "
                   "--by replica alongside the overall stats).")
@click.option("--tail", "tail_n", type=int, default=None,
              help="Only the newest N records.")
@click.option("--since", "since_s", type=float, default=None,
              help="Only records finished in the last N seconds.")
@click.option("--finish", "finish_filter", default=None,
              type=click.Choice(["done", "cancelled", "rejected",
                                 "error", "drained", "migrated"]),
              help="Only records with this finish reason.")
@click.option("--stats", "as_stats", is_flag=True,
              help="Offline p50/p95/p99 (TTFT/TPOT/queue wait + the "
                   "five lifecycle phases) and availability over the "
                   "selected records.")
@click.option("--by", "group_by", default=None,
              type=click.Choice(["tenant", "adapter_id", "path",
                                 "replica"]),
              help="With --stats: one stats block per group — "
                   "per-tenant (who burns whose budget), per fabric "
                   "path (is the migrated path earning its wire "
                   "cost), or per replica (is one replica dragging "
                   "the fleet tail).")
@click.option("--json", "as_json", is_flag=True,
              help="Emit raw records (or the stats dict) as JSON.")
def serve_requests(paths, as_fleet, tail_n, since_s, finish_filter,
                   as_stats, group_by, as_json):
    """Replay the request ledger (torn final line skipped)."""
    import time as _time

    from cloudtik_tpu_torch.serve import explain as sexplain
    from cloudtik_tpu_torch.serve import reqlog
    if paths:
        records = sexplain.fleet_requests(paths)
    else:
        records = reqlog.read_requests(None)
    if finish_filter:
        records = [r for r in records
                   if r.get("finish") == finish_filter]
    if since_s is not None:
        cutoff = _time.time() - since_s
        records = [r for r in records
                   if (r.get("done_ts") or r.get("ts") or 0) >= cutoff]
    records.sort(key=lambda r: r.get("done_ts") or r.get("ts") or 0)
    if tail_n is not None:
        records = records[-tail_n:]
    if group_by and not as_stats:
        raise click.UsageError("--by requires --stats")

    def _print_stats(stats):
        availability = stats["availability"]
        avail_s = f"{availability * 100:.2f}%" \
            if availability is not None else "-"
        click.echo(f"requests: {stats['count']}   "
                   f"availability: {avail_s}")
        for reason, count in stats["finish"].items():
            click.echo(f"  {reason:<12} {count}")
        click.echo(f"{'latency':<12} {'count':>7} {'p50':>10} "
                   f"{'p95':>10} {'p99':>10}")
        def _ms(v):
            return f"{v * 1e3:>8.2f}ms" if v is not None else \
                f"{'-':>10}"

        for field, label in (("ttft_s", "ttft"),
                             ("queue_wait_s", "queue_wait"),
                             ("tpot_s", "tpot")):
            entry = stats[field]
            click.echo(f"{label:<12} {entry['count']:>7} "
                       f"{_ms(entry['p50'])} {_ms(entry['p95'])} "
                       f"{_ms(entry['p99'])}")
        # the five-phase TTFT decomposition (rows appear once any
        # record in the population carried the phase — fabric-only
        # phases stay hidden on a monolithic fleet)
        for field in reqlog.PHASE_FIELDS:
            entry = stats.get(field)
            if not entry or not entry["count"]:
                continue
            label = "ph:" + field[: -len("_s")]
            click.echo(f"{label:<12} {entry['count']:>7} "
                       f"{_ms(entry['p50'])} {_ms(entry['p95'])} "
                       f"{_ms(entry['p99'])}")
        if stats.get("migrations"):
            click.echo(
                f"migration: imports {stats['migrations']}  "
                f"tokens {stats['migrated_tokens']}  "
                f"(KV moved between engines instead of recomputed)")
        if stats.get("spec_steps"):
            rate = stats.get("spec_acceptance_rate")
            rate_s = f"{rate * 100:.1f}%" if rate is not None else "-"
            tpv = stats.get("spec_tokens_per_verify")
            tpv_s = f"{tpv:.2f}" if tpv is not None else "-"
            click.echo(
                f"spec: verify_steps {stats['spec_steps']}  "
                f"draft {stats['draft_tokens']}  "
                f"accepted {stats['accepted_tokens']}  "
                f"acceptance {rate_s}  tokens/verify {tpv_s}")

    if as_stats:
        if group_by:
            grouped = reqlog.group_stats(records, by=group_by)
            if as_json:
                click.echo(json.dumps(grouped, indent=1))
                return
            for key, stats in grouped.items():
                click.echo(f"--- {group_by}: {key} ---")
                _print_stats(stats)
            return
        stats = reqlog.compute_stats(records)
        if as_fleet:
            per_replica = reqlog.group_stats(records, by="replica")
            if as_json:
                click.echo(json.dumps(
                    {"fleet": stats, "replicas": per_replica},
                    indent=1))
                return
            click.echo(f"--- fleet ({len(paths) or 1} source"
                       f"{'s' if len(paths) != 1 else ''}) ---")
            _print_stats(stats)
            for key, rstats in per_replica.items():
                click.echo(f"--- replica: {key} ---")
                _print_stats(rstats)
            return
        if as_json:
            click.echo(json.dumps(stats, indent=1))
            return
        _print_stats(stats)
        return
    if as_json:
        click.echo(json.dumps(records, indent=1, default=str))
        return
    if not records:
        cli_logger.info("No request records (is a serving daemon "
                        "running with the ledger installed?).")
        return
    import datetime as _dt
    for record in records:
        ts = _dt.datetime.fromtimestamp(
            record.get("done_ts") or record.get("ts") or 0).strftime(
            "%Y-%m-%d %H:%M:%S.%f")[:-3]

        def _fmt_ms(key):
            value = record.get(key)
            return f"{value * 1e3:.1f}ms" \
                if isinstance(value, (int, float)) else "-"

        replica = record.get("replica")
        where = f"{replica}#" if replica else "#"
        click.echo(
            f"{ts}  {where}{record.get('request_id', '?'):<6} "
            f"{record.get('finish', '?'):<10} "
            f"prompt={record.get('prompt_tokens', '?'):<4} "
            f"out={record.get('output_tokens', '?'):<4} "
            f"queue={_fmt_ms('queue_wait_s')} "
            f"ttft={_fmt_ms('ttft_s')} tpot={_fmt_ms('tpot_s')}")


@serve_group.command(name="replicas")
@click.option("--url", required=True,
              help="Router base URL (e.g. http://head:8210) — reads "
                   "GET /v1/replicas.")
@click.option("--json", "as_json", is_flag=True,
              help="Emit the raw registry view as JSON.")
def serve_replicas(url, as_json):
    """The serving fabric's replica registry + live router load:
    who is routable, who is draining/condemned, per-replica in-flight
    counts, and the autoscaler's current target."""
    import urllib.request
    with urllib.request.urlopen(
            url.rstrip("/") + "/v1/replicas", timeout=10) as resp:
        view = json.loads(resp.read().decode())
    if as_json:
        click.echo(json.dumps(view, indent=1))
        return
    target = view.get("target_replicas")
    click.echo(f"policy: {view.get('policy', '?')}"
               + (f"   target replicas: {target}"
                  if target is not None else ""))
    click.echo(f"{'replica':<14} {'role':<8} {'version':<8} "
               f"{'state':<22} {'beat age':>9} {'inflight':>9} "
               f"{'queue':>6} {'slots':>6}")
    for rep in view.get("replicas", []):
        if rep.get("condemned"):
            state = f"condemned:{rep['condemned']}"
        elif rep.get("draining"):
            state = "draining"
        elif rep.get("routable"):
            state = "routable"
        else:
            state = "dead (beat aged out)"
        stats = rep.get("stats") or {}
        click.echo(
            f"{rep.get('replica_id', '?'):<14} "
            f"{rep.get('role', '?'):<8} "
            f"{rep.get('version', '0'):<8} {state:<22} "
            f"{rep.get('beat_age_s', '?'):>8}s "
            f"{rep.get('inflight', 0):>9} "
            f"{stats.get('queue_depth', '-'):>6} "
            f"{rep.get('slots', '-'):>6}")


@serve_group.command(name="explain")
@click.argument("request_id")
@click.option("--path", "router_path", default=None,
              help="Router decision ledger path (default: <tik home>/"
                   "logs/serve-router.jsonl; TIK_ROUTER_LOG_PATH "
                   "overrides).")
@click.option("--reqlog", "reqlog_paths", multiple=True,
              help="Replica request-ledger path(s) to stitch in "
                   "(repeat per replica; default: the local default "
                   "ledger).")
@click.option("--url", default=None,
              help="Ask a running router instead of reading local "
                   "files (GET /v1/explain — router-ledger view only; "
                   "replica phase records need --reqlog files).")
@click.option("--trace", "trace_file", default=None,
              type=click.Path(exists=True),
              help="A Chrome-trace export (tik cluster trace export) "
                   "to narrow to this request's trace id.")
@click.option("--trace-out", default=None,
              help="Write the narrowed Chrome trace here (default: "
                   "explain-<request_id>.trace.json).")
@click.option("--json", "as_json", is_flag=True,
              help="Emit the stitched structure as JSON.")
def serve_explain(request_id, router_path, reqlog_paths, url,
                  trace_file, trace_out, as_json):
    """Why did request N behave the way it did?

    One timeline from the router's decision ledger (which replica and
    WHY, hop by hop) joined with every replica's request ledger
    (phases: router_wait -> prefill -> handoff_wire -> decode_first ->
    decode_rest, critical path flagged) — the forensics half of
    `tik slo status` (docs/observability.md "Request forensics")."""
    from cloudtik_tpu_torch.serve import explain as sexplain
    if url:
        import urllib.request
        with urllib.request.urlopen(
                url.rstrip("/") + "/v1/explain?request_id="
                + str(request_id), timeout=10) as resp:
            result = json.loads(resp.read().decode())
    else:
        routes, requests = sexplain.load(router_path, reqlog_paths)
        result = sexplain.build(request_id, routes, requests)
    if as_json:
        click.echo(json.dumps(result, indent=1, default=str))
    else:
        click.echo(sexplain.render(result))
    if trace_file:
        traceparent = None
        if result.get("route"):
            traceparent = result["route"].get("traceparent")
        if traceparent is None:
            for rec in result.get("records") or []:
                if rec.get("traceparent"):
                    traceparent = rec["traceparent"]
                    break
        with open(trace_file) as f:
            trace = json.load(f)
        narrowed = sexplain.filter_trace(trace, traceparent)
        out_path = trace_out or f"explain-{request_id}.trace.json"
        with open(out_path, "w") as f:
            json.dump(narrowed, f)
        cli_logger.info(
            "Wrote {} span(s) on this request's trace to {}",
            len(narrowed["traceEvents"]), out_path)


def main():
    from cloudtik_tpu_torch.control.executor.base import CommandError
    try:
        return cli(standalone_mode=True)
    except CommandError as e:
        cli_logger.error("Command failed (exit {}).", e.returncode)
        sys.exit(e.returncode or 1)
    except (RuntimeError, ValueError, KeyError, TimeoutError) as e:
        cli_logger.error("Error: {}", e)
        sys.exit(1)


if __name__ == "__main__":
    main()
