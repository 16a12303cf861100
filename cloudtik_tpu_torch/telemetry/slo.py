"""Serving SLOs: declarative objectives + multi-window burn-rate alerts.

An alert rule says "TTFT p95 crossed 2s"; an **SLO** says "95% of
requests must see their first token within 2.5s, and here is how fast
we are spending the 5% error budget".  This module is the declarative
catalog (:func:`default_slos`) plus the evaluation engine the built-in
prometheus collector runs after every scrape cycle, querying the shared
window store (runtimes/prometheus/windows.py — the same store the alert
engine's quantile rules use):

  * **latency** SLOs count good events straight from histogram
    ``_bucket`` deltas: good = requests at or under ``threshold_s``
    (the cumulative count at the matching bucket bound), total = the
    ``+Inf`` count.  ``threshold_s`` should sit on a bucket bound of
    the metric's ladder (telemetry/names.py); otherwise the nearest
    lower bound is used (strict: only provably-fast requests are good).
  * **availability** SLOs count good events from a result-labeled
    counter (``tik_serve_requests_total``): ``good_results`` are good,
    ``excluded_results`` (client cancellations) consume no budget, the
    rest are errors.

Per SLO and per cycle the engine computes the **burn rate** — observed
error rate over the error budget (1 - objective) — over a FAST and a
SLOW window (Google SRE multi-window multi-burn-rate alerting): burn 1.0
spends exactly the budget; burn >> 1 pages.  An SLO fires when BOTH
windows exceed ``burn_threshold`` (the fast window reacts, the slow
window keeps a brief spike from paging), resolves when both recover,
and HOLDS state over windows with no traffic (silence is not recovery).
Transitions journal the existing ``tik_alert_fired`` /
``tik_alert_resolved`` flight-recorder events; the collector exposes
``tik_slo_error_budget_remaining{slo}`` and
``tik_slo_burn_rate{slo,window}`` gauges plus ``/api/v1/slos``.
``tik slo status [--url|--file]`` is the operator surface.

`tools/check_telemetry_names.py` enforces the catalog law: unique SLO
names, referenced metrics resolving against telemetry/names.py, and
docs/observability.md documenting every SLO by name.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from cloudtik_tpu_torch.telemetry import events

KIND_LATENCY = "latency"
KIND_AVAILABILITY = "availability"

STATE_OK = "ok"
STATE_FIRING = "firing"

WINDOW_FAST = "fast"
WINDOW_SLOW = "slow"


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declarative service-level objective."""

    name: str
    kind: str                        # latency | availability
    metric: str                      # catalog name (histogram/counter)
    objective: float                 # target good fraction, e.g. 0.95
    summary: str
    threshold_s: float = 0.0         # latency: good means <= threshold
    labels: Tuple[Tuple[str, str], ...] = ()   # equality matchers
    result_label: str = "result"     # availability: outcome label
    good_results: Tuple[str, ...] = ("ok",)
    excluded_results: Tuple[str, ...] = ("cancelled", "rejected")
    fast_window: int = 5             # scrape cycles
    slow_window: int = 30
    burn_threshold: float = 2.0      # fire when BOTH windows exceed
    severity: str = "critical"

    def __post_init__(self):
        if self.kind not in (KIND_LATENCY, KIND_AVAILABILITY):
            raise ValueError(f"{self.name}: unknown kind {self.kind!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"{self.name}: objective must be in (0,1)")
        if self.kind == KIND_LATENCY and self.threshold_s <= 0:
            raise ValueError(f"{self.name}: latency SLO needs a "
                             "positive threshold_s")

    @property
    def budget(self) -> float:
        return 1.0 - self.objective


def default_slos() -> List[SLO]:
    """The built-in serving SLO catalog the head collector evaluates.

    Thresholds sit on bucket bounds of the metrics' ladders
    (LATENCY_BUCKETS / FAST_BUCKETS in telemetry/names.py)."""
    return [
        SLO(name="serve-ttft", kind=KIND_LATENCY,
            metric="tik_serve_ttft_seconds",
            objective=0.95, threshold_s=2.5,
            summary="95% of requests see their first token within "
                    "2.5s — `tik serve requests --stats` for the "
                    "offline percentiles"),
        SLO(name="serve-tpot", kind=KIND_LATENCY,
            metric="tik_serve_tpot_seconds",
            objective=0.99, threshold_s=0.25,
            summary="99% of decoded tokens arrive within 250ms of the "
                    "previous one (decode cadence)"),
        SLO(name="serve-availability", kind=KIND_AVAILABILITY,
            metric="tik_serve_requests_total",
            objective=0.99,
            summary="99% of accepted requests finish `done` "
                    "(cancellations excluded; errors and shutdown "
                    "drains spend budget)"),
    ]


def tenant_slos(tenants: Sequence[str],
                ttft_objective: float = 0.95,
                ttft_threshold_s: float = 2.5,
                availability_objective: float = 0.99,
                burn_threshold: float = 2.0) -> List[SLO]:
    """Per-tenant SLOs over the tenant-labeled serve metrics
    (multi-tenant serving): one TTFT and one availability objective
    per tenant, each matching ``tenant="<name>"`` — so
    ``tik_slo_burn_rate{slo="serve-ttft-tenant-<name>"}`` reads ONE
    tenant's budget spend, and a bursting neighbor shows up as ITS
    burn rising while the others hold (the weighted-fair admission
    story, observable)."""
    out: List[SLO] = []
    for tenant in tenants:
        out.append(SLO(
            name=f"serve-ttft-tenant-{tenant}", kind=KIND_LATENCY,
            metric="tik_serve_tenant_ttft_seconds",
            labels=(("tenant", tenant),),
            objective=ttft_objective, threshold_s=ttft_threshold_s,
            burn_threshold=burn_threshold,
            summary=f"tenant {tenant}: {ttft_objective * 100:g}% of "
                    f"requests see their first token within "
                    f"{ttft_threshold_s}s"))
        out.append(SLO(
            name=f"serve-availability-tenant-{tenant}",
            kind=KIND_AVAILABILITY,
            metric="tik_serve_tenant_requests_total",
            labels=(("tenant", tenant),),
            objective=availability_objective,
            burn_threshold=burn_threshold,
            summary=f"tenant {tenant}: "
                    f"{availability_objective * 100:g}% of accepted "
                    "requests finish `done`"))
    return out


def catalog_from_env() -> List[SLO]:
    """The collector's SLO catalog: the defaults, plus per-tenant
    SLOs for every tenant named in ``TIK_SLO_TENANTS`` (comma-
    separated) — how an operator turns on per-tenant burn-rate gauges
    without code."""
    slos = default_slos()
    names = [t.strip()
             for t in os.environ.get("TIK_SLO_TENANTS", "").split(",")
             if t.strip()]
    if names:
        slos.extend(tenant_slos(names))
    return slos


class _SloState:
    __slots__ = ("state", "since", "last_eval", "burn", "budget_remaining")

    def __init__(self):
        self.state = STATE_OK
        self.since: Optional[float] = None
        self.last_eval: Optional[float] = None
        self.burn: Dict[str, Optional[float]] = {
            WINDOW_FAST: None, WINDOW_SLOW: None}
        self.budget_remaining: Optional[float] = None


class SloEngine:
    """Evaluates the SLO catalog against a window store once per scrape
    cycle.  The store is duck-typed (histogram_window / delta_over_window
    / `cycles`) so this telemetry-layer module needs no runtimes import."""

    def __init__(self, slos: Optional[List[SLO]] = None):
        self.slos = list(slos) if slos is not None else default_slos()
        names = [s.name for s in self.slos]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate SLO names in {names}")
        self._lock = threading.Lock()
        self._states = {s.name: _SloState() for s in self.slos}

    # -- good/total extraction --------------------------------------------
    @staticmethod
    def _latency_counts(slo: SLO, windows, window: int
                        ) -> Optional[Tuple[float, float]]:
        cumulative = windows.histogram_window(slo.metric, slo.labels,
                                              window=window)
        if not cumulative:
            return None
        total = cumulative.get(float("inf"))
        if total is None:
            total = max(cumulative.values())
        # strict good bound: the largest bucket bound <= threshold —
        # a request is only "good" when the histogram proves it
        bounds = sorted(b for b in cumulative if b != float("inf"))
        good_bound = None
        for bound in bounds:
            if bound <= slo.threshold_s + 1e-12:
                good_bound = bound
            else:
                break
        good = cumulative.get(good_bound, 0.0) \
            if good_bound is not None else 0.0
        return good, total

    @staticmethod
    def _availability_counts(slo: SLO, windows, window: int
                             ) -> Optional[Tuple[float, float]]:
        deltas = windows.delta_over_window(slo.metric, slo.labels,
                                           window=window)
        if deltas is None:
            return None
        good = 0.0
        total = 0.0
        for labels, delta in deltas:
            outcome = labels.get(slo.result_label, "")
            if outcome in slo.excluded_results:
                continue
            total += delta
            if outcome in slo.good_results:
                good += delta
        return good, total

    def _burn(self, slo: SLO, windows, window: int) -> Optional[float]:
        """Error-budget burn rate over the last `window` cycles; None
        when there is no data or no traffic in the window."""
        if slo.kind == KIND_LATENCY:
            counts = self._latency_counts(slo, windows, window)
        else:
            counts = self._availability_counts(slo, windows, window)
        if counts is None:
            return None
        good, total = counts
        if total <= 0:
            return None             # no traffic: not burning, not proof
        error_rate = max(1.0 - good / total, 0.0)
        return error_rate / slo.budget

    # -- evaluation -------------------------------------------------------
    def evaluate(self, windows,
                 now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One cycle over the (already-ingested) window store; returns
        the post-cycle state list."""
        now = time.time() if now is None else now
        with self._lock:
            for slo in self.slos:
                state = self._states[slo.name]
                fast = self._burn(slo, windows, slo.fast_window)
                slow = self._burn(slo, windows, slo.slow_window)
                # budget remaining over the store's whole retention —
                # the long-horizon "how much slack is left" number
                full = self._burn(slo, windows, windows.cycles)
                state.last_eval = now
                if fast is not None:
                    state.burn[WINDOW_FAST] = fast
                if slow is not None:
                    state.burn[WINDOW_SLOW] = slow
                if full is not None:
                    state.budget_remaining = 1.0 - full
                if fast is None or slow is None:
                    continue         # no data: hold state, not recovery
                breaching = fast > slo.burn_threshold \
                    and slow > slo.burn_threshold
                if breaching and state.state != STATE_FIRING:
                    state.state = STATE_FIRING
                    state.since = now
                    events.emit(
                        "tik_alert_fired", rule=f"slo:{slo.name}",
                        severity=slo.severity, value=fast,
                        threshold=slo.burn_threshold,
                        summary=slo.summary)
                elif not breaching and state.state == STATE_FIRING:
                    state.state = STATE_OK
                    state.since = None
                    events.emit("tik_alert_resolved",
                                rule=f"slo:{slo.name}", value=fast)
            return self._state_locked()

    def _state_locked(self) -> List[Dict[str, Any]]:
        out = []
        for slo in self.slos:
            state = self._states[slo.name]
            out.append({
                "name": slo.name,
                "kind": slo.kind,
                "metric": slo.metric,
                "objective": slo.objective,
                "threshold_s": slo.threshold_s
                if slo.kind == KIND_LATENCY else None,
                "burn_threshold": slo.burn_threshold,
                "state": state.state,
                "burn_fast": state.burn[WINDOW_FAST],
                "burn_slow": state.burn[WINDOW_SLOW],
                "budget_remaining": state.budget_remaining,
                "severity": slo.severity,
                "summary": slo.summary,
                "since": state.since,
                "last_eval": state.last_eval,
            })
        return out

    def state(self) -> List[Dict[str, Any]]:
        with self._lock:
            return self._state_locked()

    def firing(self) -> List[Dict[str, Any]]:
        return [s for s in self.state() if s["state"] == STATE_FIRING]


def evaluate_exposition(text: str,
                        slos: Optional[List[SLO]] = None
                        ) -> List[Dict[str, Any]]:
    """Single-shot SLO evaluation over one saved Prometheus exposition
    (the `tik slo status --file` path): a since_boot store counts every
    series from zero, so the single ingested cycle shows each window
    the whole recorded population."""
    from cloudtik_tpu_torch.runtimes.prometheus.windows import WindowStore
    from cloudtik_tpu_torch.telemetry.export import parse_prometheus
    store = WindowStore(since_boot=True)
    store.ingest(parse_prometheus(text))
    return SloEngine(slos).evaluate(store)
