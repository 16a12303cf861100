"""In-process telemetry core: span ring + metrics registry.

Same discipline as faults/seams.py: every emit site pays ONE attribute
check when telemetry is disabled (`TIK_TELEMETRY=off`) — no allocation,
no locking, no registry walk.  The tier-1 test arms a tripwire in place
of the internal record paths and runs every instrumented surface to
prove it.

Enabled-path design:

  * Spans: a ``span(name, **attrs)`` context manager appends a finished-
    span record to a bounded ring (oldest overwritten; overwrites are
    counted in tik_spans_dropped_total).  A thread-local stack links
    nested spans on the same thread; cross-thread request flows link by
    shared attrs (e.g. the serve engine's ``request`` id).
  * Metrics: counters, gauges, and fixed-bucket histograms registered by
    name exactly once (telemetry/instruments.py).  Histograms are
    lock-striped: a series picks one of N stripe locks by label hash, so
    concurrent observers of different series rarely contend.
"""

from __future__ import annotations

import itertools
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from cloudtik_tpu_torch.telemetry.names import LATENCY_BUCKETS

_STRIPES = 8


class _State:
    """The single-attribute gate every emit site reads."""

    __slots__ = ("enabled",)

    def __init__(self, enabled: bool):
        self.enabled = enabled


def _env_enabled() -> bool:
    return os.environ.get("TIK_TELEMETRY", "on").strip().lower() not in (
        "off", "0", "false", "disabled")


STATE = _State(_env_enabled())


def enabled() -> bool:
    return STATE.enabled


def enable() -> None:
    STATE.enabled = True


def disable() -> None:
    STATE.enabled = False


def configure_from_env() -> bool:
    """Re-read TIK_TELEMETRY (for daemons that mutate their env)."""
    STATE.enabled = _env_enabled()
    return STATE.enabled


# ---------------------------------------------------------------- metrics --

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Instrument:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...]):
        self.name = name
        self.help = help
        self.labelnames = labelnames


class Counter(Instrument):
    kind = "counter"

    def __init__(self, name: str, help: str,
                 labelnames: Tuple[str, ...] = ()):
        super().__init__(name, help, labelnames)
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, float] = {}

    def inc(self, value: float = 1.0, **labels) -> None:
        if not STATE.enabled:
            return
        self._record(value, labels)

    def _record(self, value: float, labels: Dict[str, Any]) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0.0)

    def samples(self) -> List[Tuple[LabelKey, float]]:
        with self._lock:
            return sorted(self._series.items())

    def _reset(self) -> None:
        with self._lock:
            self._series.clear()


class Gauge(Instrument):
    kind = "gauge"

    def __init__(self, name: str, help: str,
                 labelnames: Tuple[str, ...] = ()):
        super().__init__(name, help, labelnames)
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        if not STATE.enabled:
            return
        self._record(value, labels)

    def _record(self, value: float, labels: Dict[str, Any]) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = float(value)

    def value(self, **labels) -> Optional[float]:
        with self._lock:
            return self._series.get(_label_key(labels))

    def samples(self) -> List[Tuple[LabelKey, float]]:
        with self._lock:
            return sorted(self._series.items())

    def _reset(self) -> None:
        with self._lock:
            self._series.clear()


class _HistogramSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets      # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0


class Histogram(Instrument):
    """Fixed-bucket histogram; series pick one of N stripe locks."""

    kind = "histogram"

    def __init__(self, name: str, help: str,
                 labelnames: Tuple[str, ...] = (),
                 buckets: Tuple[float, ...] = LATENCY_BUCKETS):
        super().__init__(name, help, labelnames)
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"{name}: buckets must be ascending")
        self.buckets = tuple(float(b) for b in buckets)
        self._locks = [threading.Lock() for _ in range(_STRIPES)]
        self._series: Dict[LabelKey, _HistogramSeries] = {}

    def _stripe(self, key: LabelKey) -> threading.Lock:
        return self._locks[hash(key) % _STRIPES]

    def observe(self, value: float, **labels) -> None:
        if not STATE.enabled:
            return
        self._record(value, labels)

    def _record(self, value: float, labels: Dict[str, Any]) -> None:
        value = float(value)
        key = _label_key(labels)
        # bucket index by linear scan: ladders are short (<= 14) and a
        # scan beats bisect's call overhead at this size
        idx = len(self.buckets)
        for i, bound in enumerate(self.buckets):
            if value <= bound:
                idx = i
                break
        with self._stripe(key):
            series = self._series.get(key)
            if series is None:
                # +1 slot for the +Inf bucket
                series = _HistogramSeries(len(self.buckets) + 1)
                self._series[key] = series
            series.counts[idx] += 1
            series.sum += value
            series.count += 1

    def snapshot(self, **labels) -> Optional[Dict[str, Any]]:
        key = _label_key(labels)
        with self._stripe(key):
            series = self._series.get(key)
            if series is None:
                return None
            return {"counts": list(series.counts), "sum": series.sum,
                    "count": series.count}

    def samples(self) -> List[Tuple[LabelKey, Dict[str, Any]]]:
        # materialize the key list in one C-level step (atomic under
        # the GIL) so concurrent first observations of a new series
        # can't mutate the dict mid-iteration
        out = []
        for key in sorted(list(self._series)):
            snap = self.snapshot(**dict(key))
            if snap is not None:
                out.append((key, snap))
        return out

    def _reset(self) -> None:
        for lock in self._locks:
            lock.acquire()
        try:
            self._series.clear()
        finally:
            for lock in self._locks:
                lock.release()


class Registry:
    """Name -> instrument; a name registers exactly once."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, Instrument] = {}

    def _register(self, instrument: Instrument) -> Instrument:
        with self._lock:
            if instrument.name in self._instruments:
                raise ValueError(
                    f"metric {instrument.name!r} already registered")
            self._instruments[instrument.name] = instrument
        return instrument

    def counter(self, name: str, help: str,
                labelnames: Tuple[str, ...] = ()) -> Counter:
        return self._register(Counter(name, help, labelnames))

    def gauge(self, name: str, help: str,
              labelnames: Tuple[str, ...] = ()) -> Gauge:
        return self._register(Gauge(name, help, labelnames))

    def histogram(self, name: str, help: str,
                  labelnames: Tuple[str, ...] = (),
                  buckets: Tuple[float, ...] = LATENCY_BUCKETS
                  ) -> Histogram:
        return self._register(Histogram(name, help, labelnames, buckets))

    def get(self, name: str) -> Optional[Instrument]:
        with self._lock:
            return self._instruments.get(name)

    def instruments(self) -> List[Instrument]:
        with self._lock:
            return [self._instruments[k]
                    for k in sorted(self._instruments)]

    def reset(self) -> None:
        """Zero every series (instruments stay registered) — tests."""
        for instrument in self.instruments():
            instrument._reset()


REGISTRY = Registry()


# ------------------------------------------------------------------ spans --

_SPAN_RING_SIZE = max(int(os.environ.get("TIK_TELEMETRY_RING", "4096")), 16)
_tls = threading.local()

# W3C-traceparent-style identifiers: 32-hex trace ids, 16-hex span ids.
# Each is a random per-process prefix plus a process-local counter —
# unique across the cluster w.h.p. without paying an os.urandom call per
# span on the enabled hot path.
_TRACE_PREFIX = os.urandom(12).hex()          # 24 of the 32 trace chars
_SPAN_PREFIX = os.urandom(4).hex()            # 8 of the 16 span chars
_trace_ids = itertools.count(1)
_span_ids = itertools.count(1)

# env var the executors export into remote commands; child processes
# adopt it via adopt_traceparent_from_env()
TRACEPARENT_ENV = "TIK_TRACEPARENT"
_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")


def _new_trace_id() -> str:
    return _TRACE_PREFIX + format(next(_trace_ids) & 0xFFFFFFFF, "08x")


def _new_span_id() -> str:
    return _SPAN_PREFIX + format(next(_span_ids) & 0xFFFFFFFF, "08x")


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(
        traceparent: Optional[str]) -> Optional[Tuple[str, str]]:
    """`00-<trace>-<span>-<flags>` -> (trace_id, span_id), else None."""
    if not traceparent:
        return None
    m = _TRACEPARENT_RE.match(str(traceparent).strip())
    if m is None:
        return None
    return m.group(1), m.group(2)


# Process-wide remote parent, adopted once at boot from TIK_TRACEPARENT
# (the executor that launched this process exported it): root spans with
# no more specific context become children of it, so e.g. every span a
# node-boot command's process records joins the head-side trace that
# started the boot.  (trace_id, span_id-or-None).
_AMBIENT: Optional[Tuple[str, Optional[str]]] = None


def adopt_traceparent(traceparent: Optional[str]) -> bool:
    """Adopt a remote parent for this PROCESS; returns True if valid."""
    global _AMBIENT
    parsed = parse_traceparent(traceparent)
    if parsed is None:
        return False
    _AMBIENT = parsed
    return True


def adopt_traceparent_from_env() -> bool:
    """Adopt TIK_TRACEPARENT from the environment when present/valid."""
    return adopt_traceparent(os.environ.get(TRACEPARENT_ENV))


def clear_adopted_traceparent() -> None:
    global _AMBIENT
    _AMBIENT = None


def _resolve_context() -> Tuple[str, Optional[str]]:
    """(trace_id, parent_span_id) a new span on this thread belongs to:
    the innermost open span, else the thread's trace_context, else the
    process ambient, else a freshly minted root trace."""
    stack = getattr(_tls, "stack", None)
    if stack:
        span_id, trace_id = stack[-1]
        return trace_id, span_id
    ambient = getattr(_tls, "ambient", None) or _AMBIENT
    if ambient is not None:
        return ambient[0], ambient[1]
    return _new_trace_id(), None


def current_traceparent() -> Optional[str]:
    """traceparent of the innermost open span (or the adopted ambient
    context) on this thread; None when disabled or no context active."""
    if not STATE.enabled:
        return None
    stack = getattr(_tls, "stack", None)
    if stack:
        span_id, trace_id = stack[-1]
        return format_traceparent(trace_id, span_id)
    ambient = getattr(_tls, "ambient", None) or _AMBIENT
    if ambient is not None and ambient[1] is not None:
        return format_traceparent(ambient[0], ambient[1])
    return None


class trace_context:
    """Ambient trace parent for a block on THIS thread — the
    cross-thread / cross-process handoff primitive.  Pass the
    traceparent a peer minted (HTTP header, serve Request attr,
    executor env) and spans opened inside join that trace as children;
    with no/invalid traceparent a fresh trace is minted so the block is
    still one coherent trace.  No-op when telemetry is disabled."""

    __slots__ = ("_traceparent", "_prev", "_active")

    def __init__(self, traceparent: Optional[str] = None):
        self._traceparent = traceparent
        self._prev: Optional[Tuple[str, Optional[str]]] = None
        self._active = False

    def __enter__(self) -> "trace_context":
        if not STATE.enabled:
            return self
        self._active = True
        self._prev = getattr(_tls, "ambient", None)
        parsed = parse_traceparent(self._traceparent)
        _tls.ambient = parsed if parsed is not None \
            else (_new_trace_id(), None)
        return self

    def __exit__(self, *exc) -> bool:
        if self._active:
            _tls.ambient = self._prev
            self._active = False
        return False


class SpanRing:
    """Bounded ring of finished-span records (dicts)."""

    def __init__(self, size: int = _SPAN_RING_SIZE):
        self.size = size
        self._lock = threading.Lock()
        self._buf: List[Optional[dict]] = [None] * size
        self._next = 0
        self._wrapped = False

    def append(self, record: dict) -> bool:
        """Returns True when an older record was overwritten."""
        with self._lock:
            dropped = self._wrapped   # wrapped => every slot is taken
            self._buf[self._next] = record
            self._next += 1
            if self._next == self.size:
                self._next = 0
                self._wrapped = True
            return dropped

    def snapshot(self) -> List[dict]:
        """Oldest-first list of finished spans."""
        with self._lock:
            if not self._wrapped:
                return [r for r in self._buf[:self._next] if r is not None]
            return [r for r in (self._buf[self._next:]
                                + self._buf[:self._next])
                    if r is not None]

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.size
            self._next = 0
            self._wrapped = False

    def __len__(self) -> int:
        with self._lock:
            return self._next if not self._wrapped else self.size


SPAN_RING = SpanRing()


def _parent_stack() -> List[Tuple[str, str]]:
    """Per-thread stack of (span_id, trace_id) for the open spans."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class _NoopSpan:
    """Shared do-nothing span for the disabled path (zero allocation)."""

    __slots__ = ()

    traceparent: Optional[str] = None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


class Span:
    __slots__ = ("name", "attrs", "span_id", "parent_id", "trace_id",
                 "_t0", "_wall", "dur")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.span_id = _new_span_id()
        self.parent_id: Optional[str] = None
        self.trace_id: Optional[str] = None
        self._t0 = 0.0
        self._wall = 0.0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    @property
    def traceparent(self) -> Optional[str]:
        """Handoff string for children of this span (valid once
        entered): exported as TIK_TRACEPARENT by the executors."""
        if self.trace_id is None:
            return None
        return format_traceparent(self.trace_id, self.span_id)

    def __enter__(self) -> "Span":
        self.trace_id, self.parent_id = _resolve_context()
        _parent_stack().append((self.span_id, self.trace_id))
        self._wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.dur = duration = time.perf_counter() - self._t0
        stack = _parent_stack()
        if stack and stack[-1][0] == self.span_id:
            stack.pop()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        _finish_span({
            "name": self.name,
            "ts": self._wall,
            "dur": duration,
            "id": self.span_id,
            "parent": self.parent_id,
            "trace": self.trace_id,
            "tid": threading.get_ident(),
            "attrs": self.attrs,
        })
        return False


def _finish_span(record: dict) -> None:
    if SPAN_RING.append(record):
        from cloudtik_tpu_torch.telemetry import instruments
        instruments.SPANS_DROPPED._record(1.0, {})


def span(name: str, **attrs) -> Any:
    """Start a span.  Fast path (telemetry off) is one attribute check."""
    if not STATE.enabled:
        return NOOP_SPAN
    return Span(name, attrs)


def add_span(name: str, start_time: float, duration: float,
             **attrs) -> None:
    """Record a retroactive span (a window measured by timestamps rather
    than entered as a context manager — e.g. a request's decode window
    stamped from its lifecycle timestamps)."""
    if not STATE.enabled:
        return
    trace_id, parent_id = _resolve_context()
    _finish_span({
        "name": name,
        "ts": float(start_time),
        "dur": max(float(duration), 0.0),
        "id": _new_span_id(),
        "parent": parent_id,
        "trace": trace_id,
        "tid": threading.get_ident(),
        "attrs": attrs,
    })


class timed_span:
    """Span + duration-histogram context manager: the shared shape for
    'trace this block AND feed its wall time into a histogram'
    (executor runs, updater phases).  `labels` go to the histogram."""

    def __init__(self, name: str, histogram: Histogram,
                 labels: Optional[Dict[str, str]] = None, **attrs):
        self._span = span(name, **attrs)
        self._histogram = histogram
        self._labels = labels or {}
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._span.__enter__()
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._span.__exit__(exc_type, exc, tb)
        self._histogram.observe(time.perf_counter() - self._t0,
                                **self._labels)
        return False


def spans() -> List[dict]:
    """Oldest-first snapshot of the finished-span ring."""
    return SPAN_RING.snapshot()


_RESET_HOOKS: List[Any] = []


def on_reset(hook) -> None:
    """Register a callable run by reset() — modules holding derived
    telemetry state (the goodput ledgers) keep it consistent with the
    zeroed registry."""
    _RESET_HOOKS.append(hook)


def reset() -> None:
    """Clear spans and zero every metric series (tests)."""
    SPAN_RING.clear()
    REGISTRY.reset()
    for hook in _RESET_HOOKS:
        hook()
