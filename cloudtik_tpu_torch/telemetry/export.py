"""Telemetry exposition: Prometheus text, Chrome trace JSON, summaries.

Three export surfaces over the same in-process state:

  * ``render_prometheus()`` — Prometheus exposition text of the metrics
    registry (scraped by the nodex exporter port and the head telemetry
    endpoint; aggregated by runtimes/prometheus/collector.py).
  * ``chrome_trace()`` — the span ring as Chrome-trace JSON ("X"
    complete events), loadable in chrome://tracing / Perfetto.
  * ``trace_summary()`` — per-span-name count/total/mean/max, the
    `tik trace summary` surface.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.telemetry import core


def _fmt(value: float) -> str:
    # integral values print as ints: prometheus-friendly and stable
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


def _escape_label(value: str) -> str:
    # exposition-format escapes: a raw quote/backslash/newline in a
    # label value would corrupt the whole scrape, not just one series
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels_blob(items) -> str:
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in items)
    return "{" + inner + "}"


def render_prometheus(registry: Optional[core.Registry] = None) -> str:
    """Prometheus text exposition of every series with samples."""
    registry = registry or core.REGISTRY
    lines: List[str] = []
    for instrument in registry.instruments():
        samples = instrument.samples()
        if not samples:
            continue
        lines.append(f"# HELP {instrument.name} {instrument.help}")
        lines.append(f"# TYPE {instrument.name} {instrument.kind}")
        if instrument.kind in ("counter", "gauge"):
            for key, value in samples:
                lines.append(
                    f"{instrument.name}{_labels_blob(key)} {_fmt(value)}")
        else:  # histogram
            for key, snap in samples:
                cumulative = 0
                bounds = list(instrument.buckets) + [float("inf")]
                for bound, count in zip(bounds, snap["counts"]):
                    cumulative += count
                    le = "+Inf" if bound == float("inf") else _fmt(bound)
                    blob = _labels_blob(list(key) + [("le", le)])
                    lines.append(
                        f"{instrument.name}_bucket{blob} {cumulative}")
                blob = _labels_blob(key)
                lines.append(
                    f"{instrument.name}_sum{blob} {_fmt(snap['sum'])}")
                lines.append(
                    f"{instrument.name}_count{blob} {snap['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


_PROM_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+([^\s]+)")
_PROM_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def parse_prometheus(text: str) -> List[Dict[str, Any]]:
    """Prometheus text -> [{name, labels, value}] (for --json dumps)."""
    out: List[Dict[str, Any]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _PROM_SAMPLE_RE.match(line)
        if not m:
            continue
        labels = dict(_PROM_LABEL_RE.findall(m.group(2) or ""))
        try:
            value: Any = float(m.group(3))
        except ValueError:
            value = m.group(3)
        out.append({"name": m.group(1), "labels": labels, "value": value})
    return out


def chrome_trace(spans: Optional[List[dict]] = None) -> Dict[str, Any]:
    """Span records -> Chrome-trace JSON (chrome://tracing / Perfetto).

    Each finished span becomes one "X" (complete) event; ts/dur are in
    microseconds as the format requires.  Span ids/parents ride in args
    so request flows can be reassembled from the export alone.
    """
    spans = core.spans() if spans is None else spans
    pid = os.getpid()
    events = []
    for record in spans:
        args = dict(record.get("attrs") or {})
        args["span_id"] = record["id"]
        if record.get("parent") is not None:
            args["parent_id"] = record["parent"]
        if record.get("trace") is not None:
            # the cross-node join key: the trace collector stitches
            # every node's export into one timeline by this id
            args["trace_id"] = record["trace"]
        events.append({
            "name": record["name"],
            "cat": "tik",
            "ph": "X",
            "ts": record["ts"] * 1e6,
            "dur": max(record["dur"], 0.0) * 1e6,
            "pid": pid,
            "tid": record.get("tid", 0),
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def trace_summary(spans: Optional[List[dict]] = None) -> Dict[str, Any]:
    """Per-name aggregate over the span ring."""
    spans = core.spans() if spans is None else spans
    agg: Dict[str, Dict[str, float]] = {}
    for record in spans:
        entry = agg.setdefault(record["name"],
                               {"count": 0, "total_s": 0.0, "max_s": 0.0})
        entry["count"] += 1
        entry["total_s"] += record["dur"]
        entry["max_s"] = max(entry["max_s"], record["dur"])
    for entry in agg.values():
        entry["mean_s"] = entry["total_s"] / entry["count"]
    return dict(sorted(agg.items()))
