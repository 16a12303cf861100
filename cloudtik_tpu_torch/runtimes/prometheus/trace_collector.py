"""Head-side trace collector: scrape every node's /trace, stitch by trace.

Sibling of collector.py, driven by the same discovery output (the
prometheus runtime's file-SD ``targets.json``).  Every telemetry HTTP
endpoint — the head's telemetry port, each node's nodex exporter —
serves its process-local span ring at ``/trace``; this collector fetches
them all and merges the events into ONE Chrome-trace in which each
source process is a lane (``pid`` 1..N plus ``process_name`` metadata
events), so a cross-node operation — spans sharing one ``trace_id`` via
TIK_TRACEPARENT propagation — reads as a single timeline in
chrome://tracing / Perfetto.

``tik cluster trace export|summary [--trace-id]`` is the CLI surface.
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from cloudtik_tpu_torch.runtimes.prometheus.collector import (
    load_file_sd_targets)

# only these file-SD jobs serve the telemetry HTTP surface (/trace);
# scraping e.g. a haproxy stats port for traces would just error
TRACE_JOBS = ("telemetry", "nodex")


class TraceCollector:
    """Fetch + stitch the span rings of every discovered tik endpoint."""

    def __init__(self, conf_dir: str,
                 jobs: Optional[Tuple[str, ...]] = TRACE_JOBS,
                 timeout_s: float = 5.0):
        self.conf_dir = os.path.expanduser(conf_dir)
        self.jobs = jobs
        self.timeout_s = timeout_s

    # -- target discovery (file-SD, same file the metrics collector reads)
    def load_targets(self) -> List[Dict[str, Any]]:
        return load_file_sd_targets(self.conf_dir, jobs=self.jobs)

    # -- collection --------------------------------------------------------
    def collect_once(self) -> List[Dict[str, Any]]:
        """One source dict per target: {address, labels, events, error}."""
        sources = []
        for target in self.load_targets():
            address = target["address"]
            url = f"http://{address}/trace"
            events: List[Dict[str, Any]] = []
            error = None
            try:
                with urllib.request.urlopen(
                        url, timeout=self.timeout_s) as resp:
                    trace = json.loads(resp.read().decode(
                        errors="replace"))
                events = list(trace.get("traceEvents", []))
            except Exception as e:
                error = str(e)
            sources.append({"address": address,
                            "labels": target["labels"],
                            "events": events, "error": error})
        return sources

    # -- stitching ---------------------------------------------------------
    @staticmethod
    def lane_name(source: Dict[str, Any]) -> str:
        labels = source.get("labels", {})
        node = labels.get("node") or labels.get("job") or ""
        return f"{node} ({source['address']})" if node \
            else source["address"]

    @staticmethod
    def stitch(sources: List[Dict[str, Any]],
               trace_id: Optional[str] = None) -> Dict[str, Any]:
        """Merge per-process exports into one Chrome-trace: lane `pid`
        per source plus process_name metadata, optionally filtered to a
        single trace_id."""
        merged: List[Dict[str, Any]] = []
        for lane, source in enumerate(sources, start=1):
            if not source["events"]:
                continue
            merged.append({
                "name": "process_name", "ph": "M", "pid": lane,
                "tid": 0,
                "args": {"name": TraceCollector.lane_name(source)},
            })
            for event in source["events"]:
                if trace_id is not None and \
                        (event.get("args") or {}).get("trace_id") \
                        != trace_id:
                    continue
                event = dict(event)
                event["pid"] = lane
                merged.append(event)
        return {"traceEvents": merged, "displayTimeUnit": "ms"}

    def export(self, trace_id: Optional[str] = None
               ) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
        """(stitched chrome-trace, per-source fetch status)."""
        sources = self.collect_once()
        return self.stitch(sources, trace_id), sources

    # -- summary -----------------------------------------------------------
    def summary(self) -> List[Dict[str, Any]]:
        """Per-trace aggregate over every source, newest trace first:
        span count, the lanes (processes) it crosses, its root span, and
        its wall extent."""
        sources = self.collect_once()
        traces: Dict[str, Dict[str, Any]] = {}
        for source in sources:
            lane = self.lane_name(source)
            for event in source["events"]:
                if event.get("ph") != "X":
                    continue
                args = event.get("args") or {}
                tid = args.get("trace_id")
                if not tid:
                    continue
                entry = traces.setdefault(tid, {
                    "trace_id": tid, "spans": 0, "nodes": set(),
                    "names": set(), "start_us": float("inf"),
                    "end_us": 0.0, "root": None,
                    "root_start_us": float("inf"),
                })
                entry["spans"] += 1
                entry["nodes"].add(lane)
                entry["names"].add(event.get("name", ""))
                ts = float(event.get("ts", 0.0))
                dur = float(event.get("dur", 0.0))
                entry["start_us"] = min(entry["start_us"], ts)
                entry["end_us"] = max(entry["end_us"], ts + dur)
                # the earliest parentless span names the operation
                if args.get("parent_id") is None and \
                        ts < entry["root_start_us"]:
                    entry["root_start_us"] = ts
                    entry["root"] = event.get("name", "")
        out = []
        for entry in sorted(traces.values(),
                            key=lambda e: -e["start_us"]):
            out.append({
                "trace_id": entry["trace_id"],
                "spans": entry["spans"],
                "nodes": sorted(entry["nodes"]),
                "root": entry["root"] or sorted(entry["names"])[0],
                "start_s": entry["start_us"] / 1e6,
                "duration_s": max(
                    entry["end_us"] - entry["start_us"], 0.0) / 1e6,
            })
        return out
