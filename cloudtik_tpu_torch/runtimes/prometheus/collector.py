"""Built-in metrics collector: a Prometheus-compatible scrape server.

Reference parity: runtime/prometheus (SURVEY.md §2.3) ran the stock
prometheus binary with file-SD targets.  Zero-egress TPU images often have
no binary to install, so this build ships its own collector speaking the
core Prometheus HTTP surface:

  * file-SD: watches the targets.json the runtime renders from discovery
  * scrapes each target's /metrics on an interval (stdlib urllib)
  * serves /metrics (aggregated + `up` series), /-/healthy, /-/ready,
    /api/v1/targets, and /api/v1/query (exact metric-name instant lookup)

When a real prometheus binary is present the runtime prefers it; this
module is the fallback and the dev/test path.  Run:
`python -m cloudtik_tpu_torch.runtimes.prometheus.collector --port 9090
 --conf-dir ~/.tik/prometheus`.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from cloudtik_tpu_torch.utils.constants import env_integer

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+([^\s]+)")
_QUERY_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')
# query-side matchers support the promql operator set: = != =~ !~
_MATCHER_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)\s*(=~|!~|!=|=)\s*"([^"]*)"')


def _matcher_ok(value: str, op: str, operand: str) -> bool:
    """One label matcher against a (possibly absent -> "") value.
    Regex matchers are fully anchored, as in promql."""
    if op == "=":
        return value == operand
    if op == "!=":
        return value != operand
    try:
        matched = re.fullmatch(operand, value) is not None
    except re.error:
        return False
    return matched if op == "=~" else not matched


def load_file_sd_targets(conf_dir: str,
                         jobs=None) -> List[Dict[str, Any]]:
    """Parse prometheus file-SD targets.json under `conf_dir` into
    [{address, labels}] — the shared discovery input of the metrics
    collector and the trace collector.  `jobs` (when given) keeps only
    groups whose `job` label is in it."""
    path = os.path.join(os.path.expanduser(conf_dir), "targets.json")
    try:
        with open(path) as f:
            groups = json.load(f)
    except (OSError, ValueError):
        return []
    out = []
    for group in groups:
        labels = dict(group.get("labels", {}))
        if jobs is not None and labels.get("job") not in jobs:
            continue
        for address in group.get("targets", []):
            out.append({"address": address, "labels": labels})
    return out


class ScrapeState:
    """Latest scrape results per target."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.targets: Dict[str, Dict[str, Any]] = {}

    def update(self, address: str, labels: Dict[str, str],
               text: Optional[str], error: Optional[str],
               duration_s: float = 0.0) -> None:
        with self.lock:
            self.targets[address] = {
                "address": address,
                "labels": labels,
                "up": error is None,
                "last_scrape": time.time(),
                "scrape_duration_s": duration_s,
                "error": error,
                "text": text or "",
            }

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self.lock:
            return {k: dict(v) for k, v in self.targets.items()}


class Collector:
    def __init__(self, conf_dir: str, scrape_interval_s: float = 5.0,
                 alert_rules=None, slos=None,
                 window_cycles: Optional[int] = None):
        from cloudtik_tpu_torch.runtimes.prometheus.alerts import AlertEngine
        from cloudtik_tpu_torch.runtimes.prometheus.windows import WindowStore
        from cloudtik_tpu_torch.telemetry.slo import SloEngine
        self.conf_dir = os.path.expanduser(conf_dir)
        self.scrape_interval_s = scrape_interval_s
        self.state = ScrapeState()
        self.started_at = time.time()
        # ONE window store shared by the alert engine's quantile rules,
        # the SLO burn-rate engine, and /api/v1/query_range — ingested
        # exactly once per scrape cycle (evaluate_alerts)
        if window_cycles is None:
            # malformed env falls back to the default — a bad knob must
            # never take the collector (and with it alerting + SLOs) down
            window_cycles = env_integer("TIK_COLLECTOR_WINDOW_CYCLES", 60)
        self.windows = WindowStore(cycles=window_cycles)
        self.alerts = AlertEngine(alert_rules, windows=self.windows)
        if slos is None:
            # defaults + per-tenant SLOs for TIK_SLO_TENANTS (the
            # multi-tenant burn-rate gauges, enabled by env)
            from cloudtik_tpu_torch.telemetry.slo import catalog_from_env
            slos = catalog_from_env()
        self.slos = SloEngine(slos)
        self._slo_state: List[Dict[str, Any]] = self.slos.state()
        self._stop = threading.Event()

    # -- target discovery (file-SD) ---------------------------------------
    def load_targets(self) -> List[Dict[str, Any]]:
        return load_file_sd_targets(self.conf_dir)

    # -- scraping ----------------------------------------------------------
    def scrape_once(self) -> None:
        for target in self.load_targets():
            address = target["address"]
            url = f"http://{address}/metrics"
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(url, timeout=3) as resp:
                    text = resp.read().decode(errors="replace")
                self.state.update(address, target["labels"], text, None,
                                  time.perf_counter() - t0)
            except Exception as e:
                self.state.update(address, target["labels"], None,
                                  str(e), time.perf_counter() - t0)

    def run_scraper(self) -> None:
        while not self._stop.is_set():
            self.scrape_once()
            self.evaluate_alerts()
            self._stop.wait(self.scrape_interval_s)

    # -- alerting ----------------------------------------------------------
    def alert_samples(self) -> List[Dict[str, Any]]:
        """The sample stream the alert engine sees: every up target's
        exposition parsed, target labels + instance merged in."""
        from cloudtik_tpu_torch.runtimes.prometheus.alerts import (
            samples_from_exposition)
        samples: List[Dict[str, Any]] = []
        for target in self.state.snapshot().values():
            if not target["up"]:
                continue
            samples.extend(samples_from_exposition(
                target["text"],
                {**target["labels"], "instance": target["address"]}))
        return samples

    def evaluate_alerts(self) -> List[Dict[str, Any]]:
        """One alert + SLO engine cycle over the latest scrapes (called
        after every scrape pass): ingest the cycle into the shared
        window store, then evaluate both engines against it."""
        samples = self.alert_samples()
        now = time.time()
        self.windows.ingest(samples, now)
        state = self.alerts.evaluate(samples, now)
        self._slo_state = self.slos.evaluate(self.windows, now)
        return state

    def slo_state(self) -> List[Dict[str, Any]]:
        return list(self._slo_state)

    # -- query -------------------------------------------------------------
    def instant_query(self, query: str) -> List[Dict[str, Any]]:
        """Instant lookup: an exact metric name, optionally narrowed by
        label matchers — `name{l="v",l2!="w",l3=~"re.*"}` (`=`, `!=`,
        `=~`, `!~`; regexes fully anchored).  Matchers resolve against
        the union of the sample's own labels, the target's file-SD
        labels, and `instance`; an absent label matches as ""."""
        q = _QUERY_RE.match(query.strip())
        if not q:
            return []
        metric = q.group(1)
        matchers = _MATCHER_RE.findall(q.group(2) or "")
        results = []
        for target in self.state.snapshot().values():
            if not target["up"]:
                continue
            for line in target["text"].splitlines():
                if line.startswith("#"):
                    continue
                m = _SAMPLE_RE.match(line)
                if not (m and m.group(1) == metric):
                    continue
                labels = {
                    **target["labels"],
                    **dict(_LABEL_RE.findall(m.group(2) or "")),
                    "instance": target["address"],
                }
                if any(not _matcher_ok(labels.get(k, ""), op, v)
                       for k, op, v in matchers):
                    continue
                results.append({
                    "metric": {"__name__": metric, **labels},
                    "value": [time.time(), m.group(3)],
                })
        return results

    def range_query(self, query: str,
                    window: Optional[int] = None) -> List[Dict[str, Any]]:
        """Windowed lookup over the retained scrape cycles: an exact
        metric name with the same matcher set as /api/v1/query
        (`=`, `!=`, `=~`, `!~`; regexes fully anchored), returned
        prometheus-matrix-style ([{metric, values}])."""
        q = _QUERY_RE.match(query.strip())
        if not q:
            return []
        metric = q.group(1)
        matchers = _MATCHER_RE.findall(q.group(2) or "")
        out = []
        for series in self.windows.query_range(metric, (),
                                               window=window):
            labels = series["labels"]
            if any(not _matcher_ok(labels.get(k, ""), op, v)
                   for k, op, v in matchers):
                continue
            out.append({
                "metric": {"__name__": metric, **labels},
                "values": [[ts, str(value)]
                           for ts, value in series["points"]],
            })
        return out

    def render_metrics(self) -> str:
        """Aggregate scrapes into one valid exposition: every sample gets an
        instance="<address>" label so identical metric names from multiple
        targets (nodex on every node) stay distinct series, and HELP/TYPE
        headers are emitted once per metric name."""
        lines = [
            "# HELP tik_collector_uptime_seconds Collector uptime.",
            "# TYPE tik_collector_uptime_seconds gauge",
            f"tik_collector_uptime_seconds {time.time() - self.started_at}",
            "# HELP scrape_duration_seconds Wall time of the last "
            "scrape of each target.",
            "# TYPE scrape_duration_seconds gauge",
            "# HELP tik_alerts_firing 1 per firing alert rule, 0 "
            "otherwise.",
            "# TYPE tik_alerts_firing gauge",
        ]
        for alert in self.alerts.state():
            lines.append(
                f'tik_alerts_firing{{rule="{alert["name"]}"}} '
                f'{1 if alert["state"] == "firing" else 0}')
        slo_rows = self.slo_state()
        if any(s["budget_remaining"] is not None for s in slo_rows):
            lines.append("# HELP tik_slo_error_budget_remaining "
                         "Fraction of the SLO error budget left.")
            lines.append("# TYPE tik_slo_error_budget_remaining gauge")
        if any(s["burn_fast"] is not None or s["burn_slow"] is not None
               for s in slo_rows):
            lines.append("# HELP tik_slo_burn_rate Error-budget burn "
                         "rate over the fast/slow window.")
            lines.append("# TYPE tik_slo_burn_rate gauge")
        for slo in slo_rows:
            if slo["budget_remaining"] is not None:
                lines.append(
                    f'tik_slo_error_budget_remaining'
                    f'{{slo="{slo["name"]}"}} '
                    f'{slo["budget_remaining"]:.6f}')
            for window_name, value in (("fast", slo["burn_fast"]),
                                       ("slow", slo["burn_slow"])):
                if value is not None:
                    lines.append(
                        f'tik_slo_burn_rate{{slo="{slo["name"]}",'
                        f'window="{window_name}"}} {value:.6f}')
        seen_headers: set = set()
        for target in self.state.snapshot().values():
            labels = "".join(
                f',{k}="{v}"' for k, v in sorted(target["labels"].items()))
            lines.append(
                f'up{{instance="{target["address"]}"{labels}}} '
                f'{1 if target["up"] else 0}')
            lines.append(
                f'scrape_duration_seconds'
                f'{{instance="{target["address"]}"{labels}}} '
                f'{target.get("scrape_duration_s", 0.0):.6f}')
            if not target["up"]:
                continue
            for raw in target["text"].splitlines():
                line = raw.rstrip()
                if not line:
                    continue
                if line.startswith("#"):
                    parts = line.split(None, 3)
                    if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                        key = (parts[1], parts[2])
                        if key in seen_headers:
                            continue
                        seen_headers.add(key)
                    lines.append(line)
                    continue
                m = _SAMPLE_RE.match(line)
                if not m:
                    continue
                name, label_blob = m.group(1), m.group(2)
                inner = (label_blob or "{}")[1:-1]
                inst = f'instance="{target["address"]}"'
                merged = f"{inner},{inst}" if inner else inst
                value_part = line[m.start(3):]
                lines.append(f"{name}{{{merged}}} {value_part}")
        return "\n".join(lines) + "\n"

    def stop(self) -> None:
        self._stop.set()


def make_handler(collector: Collector):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code: int, body: str,
                  content_type: str = "text/plain; charset=utf-8"):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            parsed = urlparse(self.path)
            if parsed.path in ("/-/healthy", "/-/ready"):
                self._send(200, "OK")
            elif parsed.path == "/metrics":
                self._send(200, collector.render_metrics())
            elif parsed.path == "/api/v1/targets":
                active = [{
                    "scrapeUrl": f"http://{t['address']}/metrics",
                    "labels": t["labels"],
                    "health": "up" if t["up"] else "down",
                    "lastError": t["error"] or "",
                } for t in collector.state.snapshot().values()]
                self._send(200, json.dumps({
                    "status": "success",
                    "data": {"activeTargets": active}}),
                    "application/json")
            elif parsed.path == "/api/v1/alerts":
                self._send(200, json.dumps({
                    "status": "success",
                    "data": {"alerts": collector.alerts.state()}}),
                    "application/json")
            elif parsed.path == "/api/v1/query":
                query = parse_qs(parsed.query).get("query", [""])[0]
                self._send(200, json.dumps({
                    "status": "success",
                    "data": {"resultType": "vector",
                             "result": collector.instant_query(query)}}),
                    "application/json")
            elif parsed.path == "/api/v1/query_range":
                params = parse_qs(parsed.query)
                query = params.get("query", [""])[0]
                try:
                    window = int(params.get("window", ["0"])[0]) or None
                except ValueError:
                    window = None
                self._send(200, json.dumps({
                    "status": "success",
                    "data": {
                        "resultType": "matrix",
                        "result": collector.range_query(query,
                                                        window)}}),
                    "application/json")
            elif parsed.path == "/api/v1/slos":
                self._send(200, json.dumps({
                    "status": "success",
                    "data": {"slos": collector.slo_state()}}),
                    "application/json")
            else:
                self._send(404, "not found")

    return Handler


def serve(port: int, conf_dir: str,
          scrape_interval_s: float = 5.0) -> None:
    # daemon boot: install the flight recorder so alert fired/resolved
    # transitions are journaled durably (library imports never install)
    from cloudtik_tpu_torch.telemetry import events
    try:
        events.install()
    except OSError:
        pass
    collector = Collector(conf_dir, scrape_interval_s)
    threading.Thread(target=collector.run_scraper, daemon=True,
                     name="tik-prom-scraper").start()
    server = ThreadingHTTPServer(("0.0.0.0", port), make_handler(collector))
    try:
        server.serve_forever()
    finally:
        collector.stop()


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=9090)
    parser.add_argument("--conf-dir", default="~/.tik/prometheus")
    parser.add_argument("--scrape-interval", type=float, default=5.0)
    args = parser.parse_args()
    serve(args.port, args.conf_dir, args.scrape_interval)


if __name__ == "__main__":
    main()
