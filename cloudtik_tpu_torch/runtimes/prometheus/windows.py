"""Windowed sample store: a bounded ring of scrape cycles per series.

The built-in collector scrapes point-in-time expositions; alerting and
SLO burn rates need *windows* — "the TTFT p95 over the last five
cycles", "the error rate over the last half hour".  This module is the
one shared store those consumers query, replacing per-consumer delta
bookkeeping (the alert engine used to keep previous-cycle bucket
snapshots per rule):

  * :meth:`WindowStore.ingest` appends one scrape cycle's parsed
    samples ({name, labels, value} dicts); each series keeps a deque of
    its last N (cycle, ts, value) points, so memory is bounded by
    (series count x N).
  * :meth:`query_range` — raw points per matching series (the
    collector's ``/api/v1/query_range`` surface).
  * :meth:`delta_over_window` / :meth:`rate_over_window` — counter
    increase and per-second rate over the last W cycles.
    ``rate_over_window`` needs two points spanning the window, so a
    single-point series yields ``None`` (no time base to divide by).
  * :meth:`histogram_window` / :meth:`quantile_over_window` — merged
    per-bucket deltas of a histogram's ``_bucket`` series over the
    window, and the interpolated quantile over them ("recent latency",
    not since-boot latency).

**Young-series baseline.**  A series with no retained point older than
the window needs a baseline.  Counting it from zero would read the
sample's whole since-boot total as "recent" — after a collector
restart every healthy service's historical errors would flood the burn
windows and false-fire SLOs.  Instead, a series that appeared in the
same cycle its *instance* first reported (collector restart, target
cold-start) baselines at its own first retained point — only increase
observed by THIS store counts, Prometheus ``increase``-style.  A series
that appears later than its instance (a new label materializing
mid-run, e.g. the first ``result="error"`` counter) really did start
from zero, and counts in full.  Stores built for one-shot evaluation
over a single saved exposition (``tik slo status --file``,
``tik alerts eval --file``) pass ``since_boot=True`` to count every
series from zero — there the whole recorded population is the point.

Window queries return ``None`` when no matching series produced a point
in the *current* cycle (a flapped scrape) or the window delta is empty
(no new observations) — consumers hold their last state instead of
reading silence as recovery.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

DEFAULT_CYCLES = 60


def histogram_quantile(q: float,
                       buckets: List[Tuple[float, float]]) -> \
        Optional[float]:
    """Prometheus-style quantile over (upper_bound, count) per-bucket
    (non-cumulative) counts with linear interpolation."""
    buckets = sorted(buckets)
    total = sum(c for _b, c in buckets)
    if total <= 0:
        return None
    rank = q * total
    seen = 0.0
    lower = 0.0
    for bound, count in buckets:
        if seen + count >= rank:
            if bound == float("inf"):
                return lower   # best effort: the last finite bound
            if count <= 0:
                return bound
            frac = (rank - seen) / count
            return lower + (bound - lower) * frac
        seen += count
        if bound != float("inf"):
            lower = bound
    return lower


def match_labels(labels: Dict[str, str],
                 matchers: Tuple[Tuple[str, str], ...]) -> bool:
    """Equality matchers; an absent label matches as ""."""
    return all(labels.get(k, "") == v for k, v in matchers)


class WindowStore:
    """Bounded per-series ring of the last N scrape cycles."""

    def __init__(self, cycles: int = DEFAULT_CYCLES,
                 since_boot: bool = False):
        self.cycles = max(int(cycles), 2)
        self.since_boot = bool(since_boot)
        self._lock = threading.Lock()
        # (name, label_key) -> deque[(cycle, ts, value)]
        self._series: Dict[Tuple[str, LabelKey], deque] = {}
        # birth cycles backing the young-series baseline rule (module
        # docstring): series key -> first cycle seen, instance label ->
        # first cycle any of its series reported
        self._series_first: Dict[Tuple[str, LabelKey], int] = {}
        self._instance_first: Dict[str, int] = {}
        self._cycle = 0

    @property
    def cycle(self) -> int:
        with self._lock:
            return self._cycle

    # -- ingestion --------------------------------------------------------
    def ingest(self, samples: List[Dict[str, Any]],
               now: Optional[float] = None) -> int:
        """Append one scrape cycle; returns the new cycle index."""
        now = time.time() if now is None else now
        with self._lock:
            self._cycle += 1
            for sample in samples:
                value = sample.get("value")
                if not isinstance(value, (int, float)):
                    continue
                key = (sample.get("name", ""),
                       tuple(sorted((k, str(v)) for k, v in
                             (sample.get("labels") or {}).items())))
                series = self._series.get(key)
                if series is None:
                    series = self._series[key] = deque(
                        maxlen=self.cycles)
                    self._series_first[key] = self._cycle
                    instance = str((sample.get("labels") or {})
                                   .get("instance", ""))
                    self._instance_first.setdefault(instance,
                                                    self._cycle)
                # one point per series per cycle: a duplicate sample in
                # the same cycle (two targets exposing the identical
                # series WITH identical labels) keeps the last value
                if series and series[-1][0] == self._cycle:
                    series[-1] = (self._cycle, now, float(value))
                else:
                    series.append((self._cycle, now, float(value)))
            return self._cycle

    # -- raw range --------------------------------------------------------
    def query_range(self, metric: str,
                    matchers: Tuple[Tuple[str, str], ...] = (),
                    window: Optional[int] = None
                    ) -> List[Dict[str, Any]]:
        """[{labels, points: [(ts, value), ...]}] for matching series;
        `window` keeps only points from the last W cycles."""
        with self._lock:
            current = self._cycle
            floor = current - window if window else 0
            out = []
            for (name, key), points in sorted(self._series.items()):
                if name != metric:
                    continue
                labels = dict(key)
                if not match_labels(labels, tuple(matchers)):
                    continue
                kept = [(ts, value) for cycle, ts, value in points
                        if cycle > floor]
                if kept:
                    out.append({"labels": labels, "points": kept})
            return out

    def _base_locked(self, series_key: Tuple[str, LabelKey],
                     points) -> Tuple[float, Optional[float]]:
        """Young-series baseline (module docstring): zero for a
        genuinely new series or a since-boot store, else the series'
        own first retained point so only increase observed by this
        store counts."""
        if self.since_boot:
            return 0.0, None
        born = self._series_first.get(series_key, 0)
        labels = dict(series_key[1])
        instance_born = self._instance_first.get(
            str(labels.get("instance", "")), born)
        if born > instance_born:
            return 0.0, None     # new label on a reporting instance
        _first_cycle, first_ts, first_value = points[0]
        return first_value, first_ts

    def _windowed(self, metric: str,
                  matchers: Tuple[Tuple[str, str], ...],
                  window: int) -> List[Tuple[Dict[str, str],
                                             Tuple[float, float, float,
                                                   float]]]:
        """Per matching series present in the CURRENT cycle:
        (labels, (base_value, base_ts, last_value, last_ts)).  The base
        is the newest point at least `window` cycles old; a series
        younger than the window uses the baseline rule in the module
        docstring (restart-safe by default, from-zero for genuinely new
        series or since_boot stores)."""
        with self._lock:
            current = self._cycle
            out = []
            for (name, key), points in self._series.items():
                if name != metric:
                    continue
                labels = dict(key)
                if not match_labels(labels, tuple(matchers)):
                    continue
                last_cycle, last_ts, last_value = points[-1]
                if last_cycle != current:
                    continue        # flapped out this cycle: no point
                base_value, base_ts = None, None
                for cycle, ts, value in reversed(points):
                    if cycle <= current - window:
                        base_value, base_ts = value, ts
                        break
                if base_value is None:
                    base_value, base_ts = self._base_locked(
                        (name, key), points)
                out.append((labels, (base_value, base_ts, last_value,
                                     last_ts)))
            return out

    # -- counters ---------------------------------------------------------
    def delta_over_window(self, metric: str,
                          matchers: Tuple[Tuple[str, str], ...] = (),
                          window: int = 1
                          ) -> Optional[List[Tuple[Dict[str, str],
                                                   float]]]:
        """Per-series counter increase over the last `window` cycles
        (clamped >= 0 against resets); None when no matching series
        landed a point this cycle."""
        series = self._windowed(metric, matchers, max(int(window), 1))
        if not series:
            return None
        return [(labels, max(last - base, 0.0))
                for labels, (base, _bts, last, _lts) in series]

    def rate_over_window(self, metric: str,
                         matchers: Tuple[Tuple[str, str], ...] = (),
                         window: int = 1) -> Optional[float]:
        """Summed per-second rate across matching series over the
        window; None when no series has two points spanning it."""
        series = self._windowed(metric, matchers, max(int(window), 1))
        rates = []
        for _labels, (base, base_ts, last, last_ts) in series:
            if base_ts is None or last_ts <= base_ts:
                continue
            rates.append(max(last - base, 0.0) / (last_ts - base_ts))
        if not rates:
            return None
        return sum(rates)

    # -- histograms -------------------------------------------------------
    def histogram_window(self, metric: str,
                         matchers: Tuple[Tuple[str, str], ...] = (),
                         window: int = 1
                         ) -> Optional[Dict[float, float]]:
        """Merged per-bound CUMULATIVE-count deltas of `metric`_bucket
        series over the window ({upper_bound: delta}); None when no
        bucket series landed a point this cycle."""
        bucket_metric = metric + "_bucket"
        window = max(int(window), 1)
        with self._lock:
            current = self._cycle
            # group series by labels-minus-le so multi-instance
            # expositions merge per bound
            groups: Dict[LabelKey, Dict[float, Tuple[float, float]]] = {}
            present = False
            for (name, key), points in self._series.items():
                if name != bucket_metric:
                    continue
                labels = dict(key)
                le = labels.pop("le", None)
                if le is None or not match_labels(labels,
                                                  tuple(matchers)):
                    continue
                try:
                    bound = float("inf") if le == "+Inf" else float(le)
                except ValueError:
                    continue
                last_cycle, _last_ts, last_value = points[-1]
                if last_cycle != current:
                    continue
                present = True
                base_value = None
                for cycle, _ts, value in reversed(points):
                    if cycle <= current - window:
                        base_value = value
                        break
                if base_value is None:
                    base_value, _base_ts = self._base_locked(
                        (name, key), points)
                group_key = tuple(sorted(labels.items()))
                base, last = groups.setdefault(group_key, {}).get(
                    bound, (0.0, 0.0))
                groups[group_key][bound] = (base + base_value,
                                            last + last_value)
        if not present:
            return None
        merged: Dict[float, float] = {}
        for bounds in groups.values():
            for bound, (base, last) in bounds.items():
                merged[bound] = merged.get(bound, 0.0) \
                    + max(last - base, 0.0)
        return merged

    def quantile_over_window(self, q: float, metric: str,
                             matchers: Tuple[Tuple[str, str], ...] = (),
                             window: int = 1) -> Optional[float]:
        """Interpolated quantile over the window's per-bucket deltas;
        None with no bucket data this cycle OR no new observations (a
        quiet window is "unchanged", never "recovered")."""
        cumulative = self.histogram_window(metric, matchers, window)
        if cumulative is None:
            return None
        # cumulative per-bound deltas -> non-cumulative per-bucket
        per_bucket: List[Tuple[float, float]] = []
        previous = 0.0
        for bound in sorted(cumulative):
            per_bucket.append((bound,
                               max(cumulative[bound] - previous, 0.0)))
            previous = cumulative[bound]
        return histogram_quantile(q, per_bucket)
