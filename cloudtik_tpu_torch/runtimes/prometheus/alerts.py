"""Alert rules: declarative thresholds the head collector evaluates.

Two layers:

  * :func:`default_rules` — classic Prometheus rule-file YAML for
    clusters running the real prometheus binary (reference parity:
    runtime/prometheus conf provisions alerting).
  * the **alert engine** — :class:`AlertRule` + :class:`AlertEngine`,
    evaluated by the *built-in* collector every scrape cycle, so
    zero-egress TPU images get alerting without a prometheus binary.
    Rule kinds: ``threshold`` (value vs a bound, optionally a
    histogram quantile computed from ``_bucket`` deltas over the last
    ``quantile_window`` scrape cycles of the shared
    :class:`~cloudtik_tpu_torch.runtimes.prometheus.windows.WindowStore`),
    ``absence`` (no series for a metric — a vanished
    heartbeat source), and ``regression`` (current value vs a rolling
    baseline of its own history — step-time p95 creep).  Rules fire
    after `for_cycles` consecutive breaches, journal
    ``tik_alert_fired`` / ``tik_alert_resolved`` to the flight
    recorder, surface at ``/api/v1/alerts``, and export a
    ``tik_alerts_firing`` gauge per rule.

The default catalog (:func:`default_alert_rules`) watches the goodput
fraction, train step-time regression, heartbeat absence, and serve
TTFT — `tools/check_telemetry_names.py` verifies every referenced
metric resolves against telemetry/names.py and every rule is
documented in docs/observability.md.  `tik alerts list|eval` is the
operator surface.
"""

from __future__ import annotations

import dataclasses
import statistics
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import yaml

from cloudtik_tpu_torch.runtimes.prometheus.windows import WindowStore
from cloudtik_tpu_torch.telemetry import events


def default_rules(cpu_threshold: float = 95.0,
                  memory_threshold: float = 90.0,
                  disk_threshold: float = 85.0) -> Dict[str, Any]:
    return {
        "groups": [{
            "name": "tik-cluster",
            "rules": [
                {
                    "alert": "NodeCpuSaturated",
                    "expr": f"tik_node_cpu_percent > {cpu_threshold}",
                    "for": "10m",
                    "labels": {"severity": "warning"},
                    "annotations": {"summary":
                                    "{{ $labels.instance }} CPU "
                                    f"> {cpu_threshold}% for 10m"},
                },
                {
                    "alert": "NodeMemoryPressure",
                    "expr": f"tik_node_memory_percent"
                            f" > {memory_threshold}",
                    "for": "5m",
                    "labels": {"severity": "warning"},
                    "annotations": {"summary":
                                    "{{ $labels.instance }} memory "
                                    f"> {memory_threshold}%"},
                },
                {
                    "alert": "NodeDiskFull",
                    "expr": f"tik_node_disk_percent > {disk_threshold}",
                    "for": "5m",
                    "labels": {"severity": "critical"},
                    "annotations": {"summary":
                                    "{{ $labels.instance }} disk "
                                    f"> {disk_threshold}%"},
                },
                {
                    "alert": "NodeExporterDown",
                    "expr": 'up == 0',
                    "for": "2m",
                    "labels": {"severity": "critical"},
                    "annotations": {"summary":
                                    "{{ $labels.instance }} stopped "
                                    "reporting metrics"},
                },
                {
                    "alert": "LaunchesStuck",
                    "expr": "tik_pending_launches > 0",
                    "for": "30m",
                    "labels": {"severity": "warning"},
                    "annotations": {"summary":
                                    "node launches pending > 30m "
                                    "(capacity or quota?)"},
                },
            ],
        }],
    }


def write_rules(conf_dir: str, **thresholds) -> str:
    import os
    path = os.path.join(conf_dir, "alerts.yml")
    with open(path, "w") as f:
        yaml.safe_dump(default_rules(**thresholds), f, sort_keys=False)
    return path


# ===================================================== alert engine ==

STATE_OK = "ok"
STATE_PENDING = "pending"
STATE_FIRING = "firing"

KIND_THRESHOLD = "threshold"
KIND_ABSENCE = "absence"
KIND_REGRESSION = "regression"

_OPS = {
    ">": lambda a, b: a > b,
    "<": lambda a, b: a < b,
    ">=": lambda a, b: a >= b,
    "<=": lambda a, b: a <= b,
}


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative rule over the scraped sample stream."""

    name: str
    kind: str                       # threshold | absence | regression
    metric: str                     # catalog name (base for quantiles)
    summary: str
    severity: str = "warning"
    labels: Tuple[Tuple[str, str], ...] = ()    # equality matchers
    op: str = ">"                   # threshold comparison
    threshold: float = 0.0
    quantile: Optional[float] = None  # compute from _bucket deltas
    quantile_window: int = 1        # scrape cycles the quantile spans
    aggregate: str = "max"          # across matching series
    for_cycles: int = 1             # consecutive breaches to fire
    window: int = 20                # regression: baseline history size
    min_samples: int = 5            # regression: baseline size to arm
    pct: float = 0.25               # regression: tolerated increase

    def __post_init__(self):
        if self.kind not in (KIND_THRESHOLD, KIND_ABSENCE,
                             KIND_REGRESSION):
            raise ValueError(f"{self.name}: unknown kind {self.kind!r}")
        if self.op not in _OPS:
            raise ValueError(f"{self.name}: unknown op {self.op!r}")


def default_alert_rules() -> List[AlertRule]:
    """The built-in catalog the head collector evaluates."""
    return [
        AlertRule(
            name="GoodputLow", kind=KIND_THRESHOLD,
            metric="tik_goodput_fraction",
            labels=(("job", "train"),), aggregate="min",
            op="<", threshold=0.5, for_cycles=2, severity="warning",
            summary="training goodput fraction below 50% — run "
                    "`tik goodput` for the bucket breakdown"),
        AlertRule(
            name="StepTimeRegression", kind=KIND_REGRESSION,
            metric="tik_train_step_seconds", quantile=0.95,
            pct=0.25, window=20, min_samples=5, for_cycles=2,
            severity="warning",
            summary="train step p95 regressed >25% vs its rolling "
                    "baseline — capture an xprof window "
                    "(`tik profile capture`)"),
        AlertRule(
            name="HeartbeatAbsent", kind=KIND_ABSENCE,
            metric="tik_heartbeats_published_total",
            for_cycles=3, severity="critical",
            summary="no node-agent heartbeat series scraped — agents "
                    "down or the telemetry endpoint unreachable"),
        AlertRule(
            name="ServeTTFTHigh", kind=KIND_THRESHOLD,
            metric="tik_serve_ttft_seconds", quantile=0.95,
            op=">", threshold=2.0, for_cycles=3, severity="warning",
            summary="serve time-to-first-token p95 above 2s"),
        AlertRule(
            name="ServePoolSaturated", kind=KIND_THRESHOLD,
            metric="tik_serve_kv_pool_utilization",
            op=">", threshold=0.9, for_cycles=3, severity="warning",
            summary="serve KV block pool >90% held by requests — "
                    "admissions will queue and preemptions start; "
                    "tune block_size / num_blocks (docs/operations.md "
                    "runbook)"),
        AlertRule(
            name="SpecAcceptanceLow", kind=KIND_THRESHOLD,
            metric="tik_serve_spec_acceptance_rate",
            op="<", threshold=0.3, for_cycles=3, severity="warning",
            summary="speculative-decoding acceptance rate below 30% — "
                    "the draft disagrees with the target, so most "
                    "draft+verify work is wasted; shrink spec.k or "
                    "retire the draft model (docs/operations.md "
                    "runbook)"),
    ]


def _match(labels: Dict[str, str],
           matchers: Tuple[Tuple[str, str], ...]) -> bool:
    return all(labels.get(k, "") == v for k, v in matchers)


class _RuleState:
    __slots__ = ("state", "streak", "since", "value", "last_eval",
                 "history", "last_quantile")

    def __init__(self, window: int):
        self.state = STATE_OK
        self.streak = 0
        self.since: Optional[float] = None
        self.value: Optional[float] = None
        self.last_eval: Optional[float] = None
        self.history: deque = deque(maxlen=max(window, 1))
        # last computed quantile, held across cycles that bring no new
        # observations (zero bucket delta / a flapped scrape) so a
        # quiet cycle cannot erase a breach streak
        self.last_quantile: Optional[float] = None


class AlertEngine:
    """Evaluates the rule catalog against parsed Prometheus samples
    ({name, labels, value} dicts) once per scrape cycle.

    Quantile rules query the shared :class:`WindowStore` instead of
    keeping per-rule bucket snapshots; pass the collector's store via
    `windows` (and ingest cycles there), or let the engine own a
    private store that it feeds from each evaluate() call (the
    standalone `tik alerts eval` path)."""

    def __init__(self, rules: Optional[List[AlertRule]] = None,
                 windows: Optional[WindowStore] = None):
        self.rules = list(rules) if rules is not None \
            else default_alert_rules()
        names = [r.name for r in self.rules]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate alert rule names in {names}")
        self._owns_windows = windows is None
        # an engine that owns its store is the one-shot `tik alerts
        # eval --file/--url` path, where a single static exposition
        # must show quantile rules the whole since-boot population; the
        # collector's long-lived shared store baselines instead
        # (windows.py module docstring)
        self.windows = windows if windows is not None \
            else WindowStore(since_boot=True)
        self._lock = threading.Lock()
        self._states = {r.name: _RuleState(r.window) for r in self.rules}

    # -- value extraction -------------------------------------------------
    def _series_value(self, rule: AlertRule,
                      samples: List[Dict[str, Any]]) -> Optional[float]:
        values = [float(s["value"]) for s in samples
                  if s.get("name") == rule.metric
                  and isinstance(s.get("value"), (int, float))
                  and _match(s.get("labels", {}), rule.labels)]
        if not values:
            return None
        if rule.aggregate == "min":
            return min(values)
        if rule.aggregate == "sum":
            return sum(values)
        if rule.aggregate == "avg":
            return sum(values) / len(values)
        return max(values)

    def _quantile_value(self, rule: AlertRule,
                        state: _RuleState) -> Optional[float]:
        """Quantile of the metric's `_bucket` distribution over the
        window store's last `quantile_window` cycles — recent latency,
        not since-boot latency.  The first cycle uses the cumulative
        counts (delta from zero); a cycle with no new observations (or
        no scraped buckets at all) HOLDS the last computed quantile —
        the latency estimate is unchanged, so a quiet cycle must not
        read as recovery."""
        value = self.windows.quantile_over_window(
            rule.quantile, rule.metric, rule.labels,
            window=rule.quantile_window)
        if value is None:
            return state.last_quantile
        state.last_quantile = value
        return value

    # -- evaluation -------------------------------------------------------
    def _breach(self, rule: AlertRule, state: _RuleState,
                samples: List[Dict[str, Any]]) -> Tuple[bool, Any]:
        if rule.kind == KIND_ABSENCE:
            matched = sum(
                1 for s in samples
                if (s.get("name") == rule.metric
                    or s.get("name", "").startswith(rule.metric + "_"))
                and _match(s.get("labels", {}), rule.labels))
            return matched == 0, float(matched)
        if rule.quantile is not None:
            value = self._quantile_value(rule, state)
        else:
            value = self._series_value(rule, samples)
        if value is None:
            return None, None       # no data: hold state, not recovery
        if rule.kind == KIND_THRESHOLD:
            return _OPS[rule.op](value, rule.threshold), value
        # regression: current vs rolling baseline of its own history
        baseline = statistics.median(state.history) \
            if len(state.history) >= rule.min_samples else None
        if baseline is None or baseline <= 0:
            state.history.append(value)
            return False, value
        breach = value > baseline * (1.0 + rule.pct)
        # only healthy samples feed the baseline: a sustained
        # regression must not poison its own reference and
        # self-resolve while nothing recovered
        if not breach:
            state.history.append(value)
        return breach, value

    def evaluate(self, samples: List[Dict[str, Any]],
                 now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One evaluation cycle; returns the post-cycle state list."""
        now = time.time() if now is None else now
        if self._owns_windows:
            # standalone engine: each evaluate() IS one scrape cycle of
            # its private store.  A shared (collector-owned) store is
            # ingested once per cycle by the collector instead.
            self.windows.ingest(samples, now)
        with self._lock:
            for rule in self.rules:
                state = self._states[rule.name]
                breach, value = self._breach(rule, state, samples)
                if value is not None:
                    state.value = value
                state.last_eval = now
                if breach is None:
                    # no data this cycle: neither breach nor recovery —
                    # state and streak hold (a flapped scrape must not
                    # erase a near-firing streak or resolve an alert)
                    continue
                if breach:
                    state.streak += 1
                    if state.streak >= rule.for_cycles:
                        if state.state != STATE_FIRING:
                            state.state = STATE_FIRING
                            state.since = now
                            events.emit(
                                "tik_alert_fired", rule=rule.name,
                                severity=rule.severity, value=value,
                                threshold=rule.threshold,
                                summary=rule.summary)
                    elif state.state == STATE_OK:
                        state.state = STATE_PENDING
                        state.since = now
                else:
                    if state.state == STATE_FIRING:
                        events.emit("tik_alert_resolved",
                                    rule=rule.name, value=value)
                    state.state = STATE_OK
                    state.streak = 0
                    state.since = None
            return self._state_locked()

    def _state_locked(self) -> List[Dict[str, Any]]:
        out = []
        for rule in self.rules:
            state = self._states[rule.name]
            out.append({
                "name": rule.name,
                "kind": rule.kind,
                "metric": rule.metric,
                "state": state.state,
                "value": state.value,
                "threshold": rule.threshold,
                "severity": rule.severity,
                "summary": rule.summary,
                "since": state.since,
                "last_eval": state.last_eval,
            })
        return out

    def state(self) -> List[Dict[str, Any]]:
        with self._lock:
            return self._state_locked()

    def firing(self) -> List[Dict[str, Any]]:
        return [a for a in self.state() if a["state"] == STATE_FIRING]


def samples_from_exposition(text: str,
                            extra_labels: Optional[Dict[str, str]]
                            = None) -> List[Dict[str, Any]]:
    """Prometheus exposition text -> engine sample stream, with
    target-level labels merged under the sample's own labels."""
    from cloudtik_tpu_torch.telemetry.export import parse_prometheus
    samples = parse_prometheus(text)
    if extra_labels:
        for sample in samples:
            sample["labels"] = {**extra_labels, **sample["labels"]}
    return samples

