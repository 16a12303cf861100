"""Deterministic fault injection: seeded plans fired at code seams.

The control plane detects heartbeat-lost hosts and recycles whole TPU
slices, and the trainer resumes from async checkpoints — this module is
how those paths are *proved* to compose.  A `FaultPlan` is a seeded,
schedule-driven set of `FaultPoint`s; the real code paths carry tiny
injection seams (see `cloudtik_tpu_torch.faults.seams`) that are no-ops unless
a plan is armed, so production cost is a single attribute check.

Fault kinds:

  * ``raise``               raise an exception at the seam (once or N times)
  * ``latency``             sleep `seconds` before the operation proceeds
  * ``preempt_node_group``  terminate a TPU node group through the provider
                            reached at a provider seam (simulated preemption)
  * ``drop``                suppress the operation (heartbeat blackout);
                            bounded by `times` or a `for_s` wall window
  * ``torn_write``          direct the checkpoint seam to truncate the
                            just-written step before its data is complete

Determinism contract: the injection *trace* (which fault fired at which
matching call) is a pure function of (plan spec, seed, seam call
sequence) — `probability` draws come from the plan's private seeded RNG,
never the global one.  Same seed, same workload → same trace.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

# Directives a seam site may receive back from fire(); anything else
# (None) means "proceed normally".
DIRECTIVE_DROP = "drop"
DIRECTIVE_TORN_WRITE = "torn_write"


class FaultInjected(Exception):
    """Default exception raised by `raise` fault points."""


@dataclasses.dataclass
class FaultPoint:
    """One scheduled fault at one seam (or seam glob).

    seam:        seam name, e.g. "provider.create_node"; fnmatch globs
                 are allowed ("provider.*").
    kind:        raise | latency | preempt_node_group | drop | torn_write
    at_call:     1-based index of the first *matching* call that may fire
                 (0 and 1 both mean "from the first call").
    times:       max number of firings (0 = unlimited).
    probability: per-call seeded coin once the schedule window is open.
    match:       equality filters against the seam context, e.g.
                 {"ip": "10.0.0.3"} — non-matching calls are not counted.
    args:        kind-specific arguments:
                   raise:    message, exception ("FaultInjected" default)
                   latency:  seconds
                   preempt_node_group: group_id (default: first group)
                   drop:     for_s (wall window from first firing)
    """

    seam: str
    kind: str
    at_call: int = 0
    times: int = 1
    probability: float = 1.0
    match: Dict[str, Any] = dataclasses.field(default_factory=dict)
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # runtime counters (not part of the spec)
    calls: int = 0
    fired: int = 0
    first_fired_at: Optional[float] = None

    def matches(self, seam: str, ctx: Dict[str, Any]) -> bool:
        if not fnmatch.fnmatchcase(seam, self.seam):
            return False
        return all(ctx.get(k) == v for k, v in self.match.items())


VALID_KINDS = ("raise", "latency", "preempt_node_group", "drop",
               "torn_write")


class FaultPlan:
    """A seeded schedule of fault points plus the trace of what fired.

    `clock` and `sleep` are injectable so tests can drive wall-window
    faults (drop ... for_s) without real time passing.
    """

    def __init__(self, points: List[FaultPoint], seed: int = 0,
                 name: str = "", clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        for p in points:
            if p.kind not in VALID_KINDS:
                raise ValueError(f"unknown fault kind {p.kind!r} "
                                 f"(valid: {', '.join(VALID_KINDS)})")
        self.points = list(points)
        self.seed = seed
        self.name = name
        self.rng = random.Random(seed)
        self.clock = clock
        self.sleep = sleep
        self.trace: List[Dict[str, Any]] = []
        self._lock = threading.RLock()

    # ------------------------------------------------------------------
    def fire(self, seam: str, ctx: Dict[str, Any]) -> Optional[str]:
        """Evaluate every matching point; apply the first that triggers.

        Returns a directive string (DIRECTIVE_DROP / DIRECTIVE_TORN_WRITE)
        for cooperative faults, raises for `raise` faults, sleeps for
        `latency` faults, or returns None when nothing fires.
        """
        fired_point = None
        with self._lock:
            for point in self.points:
                if not point.matches(seam, ctx):
                    continue
                point.calls += 1
                if not self._should_fire(point):
                    continue
                point.fired += 1
                if point.first_fired_at is None:
                    point.first_fired_at = self.clock()
                entry = {"seam": seam, "kind": point.kind,
                         "call": point.calls, "fired": point.fired}
                entry.update(self._detail(point, ctx))
                self.trace.append(entry)
                fired_point = point
                break
        if fired_point is None:
            return None
        # journal the firing BEFORE applying (a `raise` fault must still
        # leave its record); import here — telemetry.events reaches back
        # into faults for the torn-write directive
        if seam != "events.append":    # the journal's own seam: no loop
            from cloudtik_tpu_torch.telemetry import events
            events.emit("tik_fault_fired", seam=seam,
                        kind=fired_point.kind)
        # apply OUTSIDE the lock: a latency sleep or a provider call here
        # must stall only this seam's caller, not every instrumented
        # thread in the process
        return self._apply(fired_point, seam, ctx, entry)

    def _should_fire(self, point: FaultPoint) -> bool:
        if point.calls < max(point.at_call, 1):
            return False
        if point.kind == "drop" and point.args.get("for_s") is not None:
            # wall-window semantics: keep dropping from the first firing
            # until for_s elapses, regardless of `times`
            if point.first_fired_at is not None:
                return (self.clock() - point.first_fired_at
                        < float(point.args["for_s"]))
        if point.times and point.fired >= point.times:
            return False
        if point.probability < 1.0 and \
                self.rng.random() >= point.probability:
            return False
        return True

    def _apply(self, point: FaultPoint, seam: str, ctx: Dict[str, Any],
               entry: Dict[str, Any]) -> Optional[str]:
        if point.kind == "raise":
            exc_name = point.args.get("exception", "FaultInjected")
            message = point.args.get(
                "message", f"injected fault at {seam}")
            raise _exception_for(exc_name)(message)
        if point.kind == "latency":
            self.sleep(float(point.args.get("seconds", 0.05)))
            return None
        if point.kind == "preempt_node_group":
            self._preempt(point, ctx, entry)
            return None
        if point.kind == "drop":
            return DIRECTIVE_DROP
        if point.kind == "torn_write":
            return DIRECTIVE_TORN_WRITE
        return None

    @staticmethod
    def _detail(point: FaultPoint, ctx: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for key in ("node_id", "ip", "node_type", "step", "key", "table"):
            if key in ctx:
                out[key] = ctx[key]
        return out

    @staticmethod
    def _preempt(point: FaultPoint, ctx: Dict[str, Any],
                 entry: Dict[str, Any]) -> None:
        """Simulated slice preemption: terminate a node group through the
        provider present in the seam context (provider seams pass it)."""
        provider = ctx.get("provider")
        if provider is None or not provider.supports_node_groups():
            entry["skipped"] = "no group-capable provider in context"
            return
        group_id = point.args.get("group_id")
        if not group_id:
            groups = provider.list_node_groups({})
            if not groups:
                entry["skipped"] = "no node groups to preempt"
                return
            group_id = sorted(groups)[0]
        provider.terminate_node_group(group_id)
        entry["group_id"] = group_id

    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "name": self.name,
                "seed": self.seed,
                "points": [
                    {"seam": p.seam, "kind": p.kind, "calls": p.calls,
                     "fired": p.fired}
                    for p in self.points],
                "trace": list(self.trace),
            }


def _exception_for(name: str) -> type:
    """Resolve a raise-fault exception by name (a small allowlist — plans
    are operator input, not a code-execution channel)."""
    allowed = {
        "FaultInjected": FaultInjected,
        "RuntimeError": RuntimeError,
        "ConnectionError": ConnectionError,
        "OSError": OSError,
        "TimeoutError": TimeoutError,
    }
    return allowed.get(name, FaultInjected)


def plan_from_dict(spec: Dict[str, Any], **kw) -> FaultPlan:
    """Build a FaultPlan from a parsed plan document:

    seed: 42
    name: preempt-drill
    faults:
      - seam: provider.non_terminated_nodes
        kind: preempt_node_group
        at_call: 3
      - seam: node_agent.heartbeat
        kind: drop
        match: {ip: 127.0.0.1}
        args: {for_s: 30}
    """
    points = []
    for f in spec.get("faults", []):
        unknown = set(f) - {"seam", "kind", "at_call", "times",
                            "probability", "match", "args"}
        if unknown:
            raise ValueError(
                f"unknown fault fields: {sorted(unknown)}")
        points.append(FaultPoint(
            seam=f["seam"], kind=f["kind"],
            at_call=int(f.get("at_call", 0)),
            times=int(f.get("times", 1)),
            probability=float(f.get("probability", 1.0)),
            match=dict(f.get("match") or {}),
            args=dict(f.get("args") or {})))
    return FaultPlan(points, seed=int(spec.get("seed", 0)),
                     name=str(spec.get("name", "")), **kw)


def load_plan(path: str, **kw) -> FaultPlan:
    """Load a plan.yaml (see plan_from_dict for the schema)."""
    import yaml
    with open(path) as f:
        spec = yaml.safe_load(f) or {}
    return plan_from_dict(spec, **kw)
