"""Goodput ledger: attribute every TPU-second of a job's wall time.

MegaScale (arXiv:2402.15627) and Google's ML Goodput methodology both
report that sustained utilization is won by *accounting*: every second
of job wall time lands in exactly one named bucket, and the productive
fraction ("goodput") is watched like a latency SLO.  This module is
that accounting for tik jobs:

  * a per-job :class:`GoodputLedger` turns attributed durations into
    monotonic ``tik_goodput_seconds_total{bucket=,job=}`` counters, a
    ``tik_goodput_wall_seconds`` gauge anchored at the first
    attribution, and a derived ``tik_goodput_fraction`` gauge
    (productive step compute over wall);
  * time nobody attributed becomes ``idle`` at every :meth:`tick`, so
    the buckets always sum to total wall time by construction;
  * :func:`replay_horizon` reconstructs **restart replay** — steps
    re-run after a preemption because the job resumed from an older
    checkpoint — from the flight recorder's ``tik_checkpoint_commit``
    events (the max step any commit recorded is work that already
    happened; re-running up to it is replay, not progress);
  * :func:`breakdown_from_samples` rebuilds the ledger view from a
    Prometheus exposition — the ``tik goodput`` CLI surface.

Emit sites follow the house discipline: :meth:`GoodputLedger.attribute`
is a single attribute check when ``TIK_TELEMETRY=off`` — no locking,
no dict mutation (tripwire-tested; benchmarks/telemetry_overhead.py
reports the disabled cost).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.telemetry import core
from cloudtik_tpu_torch.telemetry import instruments as ti

# The bucket taxonomy.  Every attributed second lands in exactly one;
# `idle` is derived (wall minus everything attributed), never
# attributed directly.
BUCKET_STEP_COMPUTE = "step_compute"
BUCKET_COMPILE = "compile"
BUCKET_DATA_WAIT = "data_wait"
BUCKET_HOST_TRANSFER = "host_transfer"
BUCKET_CHECKPOINT_SAVE = "checkpoint_save"
BUCKET_CHECKPOINT_RESTORE = "checkpoint_restore"
BUCKET_RESTART_REPLAY = "restart_replay"
# data-parallel gradient sync at the step boundary of an accumulated
# step (train/trainer.py _StepDispatcher): the host wall between the
# grads and apply dispatches (plus the apply-retirement tail at window
# flush) — injected latency at the train.grad_sync seam and the bench's
# emulated-DCN sync land here, never in step_compute.  With overlap on
# the per-microbatch reduces hide inside the scan, so a large grad_sync
# under overlap means the buckets are too coarse or the mesh has no
# data axis (docs/observability.md reading guide).
BUCKET_GRAD_SYNC = "grad_sync"
# elastic re-mesh coordination: the step-loop pause while the trainer
# re-meshes across slices (train/elastic.py), NET of the restore and
# compile seconds booked to their own buckets.  First-class so the
# recovered wall time of elasticity reads directly against what a
# restart-everything job books as restart_replay.
BUCKET_ELASTIC_REMESH = "elastic_remesh"
BUCKET_SLOT_IDLE = "slot_idle"
BUCKET_IDLE = "idle"

BUCKETS = (
    BUCKET_STEP_COMPUTE,
    BUCKET_COMPILE,
    BUCKET_DATA_WAIT,
    BUCKET_HOST_TRANSFER,
    BUCKET_CHECKPOINT_SAVE,
    BUCKET_CHECKPOINT_RESTORE,
    BUCKET_RESTART_REPLAY,
    BUCKET_GRAD_SYNC,
    BUCKET_ELASTIC_REMESH,
    BUCKET_SLOT_IDLE,
    BUCKET_IDLE,
)

# buckets that count as productive for the goodput fraction
PRODUCTIVE_BUCKETS = (BUCKET_STEP_COMPUTE,)

SNAPSHOT_ENV = "TIK_GOODPUT_SNAPSHOT"


class GoodputLedger:
    """Wall-time accountant for one job (one label set per process)."""

    def __init__(self, job: str = "train"):
        self.job = job
        self._lock = threading.Lock()
        self._start: Optional[float] = None
        self._totals: Dict[str, float] = {}

    # -- attribution -----------------------------------------------------
    def start_job(self, at: Optional[float] = None) -> None:
        """Anchor the wall clock (idempotent; keeps the earliest)."""
        if not core.STATE.enabled:
            return
        with self._lock:
            if self._start is None:
                self._start = time.monotonic() if at is None else at

    def attribute(self, bucket: str, seconds: float) -> None:
        """Account `seconds` of wall time to `bucket`.  Fast path
        (telemetry off) is one attribute check."""
        if not core.STATE.enabled:
            return
        self._record(bucket, seconds)

    def _record(self, bucket: str, seconds: float) -> None:
        if bucket not in BUCKETS:
            raise ValueError(f"unknown goodput bucket {bucket!r}; "
                             f"taxonomy: {BUCKETS}")
        seconds = max(float(seconds), 0.0)
        with self._lock:
            now = time.monotonic()
            if self._start is None:
                # the first attribution defines the window: the work it
                # measures just finished, so the wall anchors at that
                # work's START — anchoring at `now` would make the
                # clamp below zero out the duration (e.g. a checkpoint
                # restore attributed before fit() calls start_job)
                self._start = now - seconds
            # a wall-time accountant may never book more than the wall
            # that actually elapsed: concurrent attributors (the orbax
            # async-save thread compiling while the step loop books its
            # own segments, the jax.monitoring compile listener firing
            # from any thread) would otherwise double-book the same
            # second and push sum(buckets) past wall — first booked
            # wins, the overlap is dropped, and the sum-to-wall
            # invariant holds by construction instead of by hope
            wall = max(now - self._start, 0.0)
            attributed = sum(self._totals.values())
            seconds = min(seconds, max(wall - attributed, 0.0))
            self._totals[bucket] = self._totals.get(bucket, 0.0) + seconds
        ti.GOODPUT_SECONDS.inc(seconds, bucket=bucket, job=self.job)

    def total(self, bucket: str) -> float:
        with self._lock:
            return self._totals.get(bucket, 0.0)

    # -- derived views ---------------------------------------------------
    def wall_seconds(self, now: Optional[float] = None) -> float:
        with self._lock:
            if self._start is None:
                return 0.0
            return max((time.monotonic() if now is None else now)
                       - self._start, 0.0)

    def tick(self, now: Optional[float] = None) -> float:
        """Fold unattributed wall time into the `idle` bucket and
        refresh the wall/fraction gauges; returns current wall time.
        The invariant after every tick: sum(buckets) == wall."""
        if not core.STATE.enabled:
            return 0.0
        with self._lock:
            if self._start is None:
                return 0.0
            wall = max((time.monotonic() if now is None else now)
                       - self._start, 0.0)
            attributed = sum(self._totals.values())
            idle_delta = wall - attributed
            if idle_delta > 0.0:
                self._totals[BUCKET_IDLE] = \
                    self._totals.get(BUCKET_IDLE, 0.0) + idle_delta
            productive = sum(self._totals.get(b, 0.0)
                             for b in PRODUCTIVE_BUCKETS)
            # attribution can (slightly) exceed elapsed wall when
            # overlapping work is booked twice; the fraction divides by
            # whichever is larger so it stays in [0, 1]
            denom = max(wall, attributed)
        if idle_delta > 0.0:
            ti.GOODPUT_SECONDS.inc(idle_delta, bucket=BUCKET_IDLE,
                                   job=self.job)
        ti.GOODPUT_WALL.set(wall, job=self.job)
        ti.GOODPUT_FRACTION.set(productive / denom if denom > 0 else 0.0,
                                job=self.job)
        return wall

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Tick, then return the full breakdown (buckets sum to wall)."""
        wall = self.tick(now)
        with self._lock:
            buckets = {b: self._totals.get(b, 0.0) for b in BUCKETS}
        productive = sum(buckets[b] for b in PRODUCTIVE_BUCKETS)
        attributed = sum(buckets.values())
        denom = max(wall, attributed)
        return {
            "job": self.job,
            "wall_s": wall,
            "buckets": buckets,
            "attributed_s": attributed,
            "goodput_fraction": productive / denom if denom > 0 else 0.0,
        }

    def write_snapshot(self, path: str) -> str:
        """Persist snapshot() as JSON — the `tik goodput --file` input."""
        path = os.path.expanduser(path)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
        return path

    def reset(self) -> None:
        with self._lock:
            self._start = None
            self._totals.clear()


# ------------------------------------------------------------- registry --

_LEDGERS: Dict[str, GoodputLedger] = {}
_ledgers_lock = threading.Lock()


def get_ledger(job: str) -> GoodputLedger:
    """Process-wide singleton ledger per job label."""
    with _ledgers_lock:
        ledger = _LEDGERS.get(job)
        if ledger is None:
            ledger = _LEDGERS[job] = GoodputLedger(job)
        return ledger


def _reset_all_ledgers() -> None:
    with _ledgers_lock:
        ledgers = list(_LEDGERS.values())
    for ledger in ledgers:
        ledger.reset()


core.on_reset(_reset_all_ledgers)

# The process-default ledger: what the trainer, checkpointer, and the
# compile-tracking seam attribute into.  TIK_JOB names the job label.
LEDGER = get_ledger(os.environ.get("TIK_JOB", "train"))


def attribute(bucket: str, seconds: float) -> None:
    """Attribute into the process-default ledger."""
    LEDGER.attribute(bucket, seconds)


def maybe_write_snapshot(ledger: Optional[GoodputLedger] = None) -> \
        Optional[str]:
    """Write a snapshot when TIK_GOODPUT_SNAPSHOT names a path — the
    simulated-run handoff to `tik goodput --file`."""
    path = os.environ.get(SNAPSHOT_ENV)
    if not path or not core.STATE.enabled:
        return None
    return (ledger or LEDGER).write_snapshot(path)


# ------------------------------------------------------ restart replay --

def replay_horizon(restored_step: int,
                   directory: Optional[str] = None,
                   events_path: Optional[str] = None) -> int:
    """Last step the previous incarnation already ran, reconstructed
    from the flight recorder.

    A `tik_checkpoint_commit` event at step T means the job reached at
    least T before the restart — whether the commit succeeded or tore.
    Resuming from `restored_step` < T means steps restored_step+1..T
    are re-run: their time is `restart_replay`, not progress.  Returns
    `restored_step` when the journal shows nothing newer (fresh run,
    clean resume, or no journal at all).

    `directory` scopes the scan to commits of THIS job's checkpoint
    directory: the journal is shared per node and outlives runs, so
    without the filter a commit from an unrelated earlier job would
    inflate the horizon and book healthy training as replay.  Records
    carrying no directory (or a different one) are ignored when the
    filter is set.
    """
    from cloudtik_tpu_torch.telemetry import events as tevents
    horizon = int(restored_step)
    want = os.path.abspath(os.path.expanduser(directory)) \
        if directory else None
    try:
        records = tevents.read_events(events_path)
    except Exception:
        return horizon
    for record in records:
        if record.get("name") != "tik_checkpoint_commit":
            continue
        if want is not None:
            got = record.get("directory")
            if not got or os.path.abspath(
                    os.path.expanduser(str(got))) != want:
                continue
        try:
            step = int(record.get("step", -1))
        except (TypeError, ValueError):
            continue
        horizon = max(horizon, step)
    return horizon


# ------------------------------------------------------- CLI breakdown --

def breakdown_from_samples(samples: List[Dict[str, Any]],
                           job: Optional[str] = None
                           ) -> List[Dict[str, Any]]:
    """Rebuild per-job breakdowns from parsed Prometheus samples
    (telemetry.parse_prometheus shape: {name, labels, value}).

    Selects `tik_goodput_seconds_total` / `tik_goodput_wall_seconds` /
    `tik_goodput_fraction` series; `job` narrows to one job label.
    Multi-target expositions (the head collector's aggregate) sum
    bucket seconds across instances per job.
    """
    by_job: Dict[str, Dict[str, Any]] = {}

    def entry(j: str) -> Dict[str, Any]:
        return by_job.setdefault(j, {
            "job": j, "wall_s": 0.0, "buckets": {},
            "goodput_fraction": None})

    for sample in samples:
        labels = sample.get("labels", {})
        sample_job = labels.get("job", "")
        if job is not None and sample_job != job:
            continue
        name = sample.get("name")
        value = sample.get("value")
        if not isinstance(value, (int, float)):
            continue
        if name == "tik_goodput_seconds_total":
            bucket = labels.get("bucket", "")
            buckets = entry(sample_job)["buckets"]
            buckets[bucket] = buckets.get(bucket, 0.0) + float(value)
        elif name == "tik_goodput_wall_seconds":
            record = entry(sample_job)
            record["wall_s"] += float(value)
        elif name == "tik_goodput_fraction":
            entry(sample_job)["goodput_fraction"] = float(value)

    out = []
    for record in sorted(by_job.values(), key=lambda r: r["job"]):
        attributed = sum(record["buckets"].values())
        record["attributed_s"] = attributed
        if record["goodput_fraction"] is None:
            wall = record["wall_s"] or attributed
            productive = sum(record["buckets"].get(b, 0.0)
                             for b in PRODUCTIVE_BUCKETS)
            record["goodput_fraction"] = \
                productive / wall if wall > 0 else 0.0
        out.append(record)
    return out


def format_breakdown(record: Dict[str, Any]) -> str:
    """One job's breakdown as the aligned table `tik goodput` prints."""
    wall = record.get("wall_s") or record.get("attributed_s") or 0.0
    lines = [f"job: {record['job']}   wall: {wall:.3f}s   "
             f"goodput: {record['goodput_fraction'] * 100:.1f}%"]
    buckets = record.get("buckets", {})
    ordered = [b for b in BUCKETS if b in buckets] + \
        sorted(set(buckets) - set(BUCKETS))
    for bucket in ordered:
        seconds = buckets[bucket]
        pct = (seconds / wall * 100.0) if wall > 0 else 0.0
        lines.append(f"  {bucket:<20} {seconds:>12.3f}s  {pct:>6.1f}%")
    lines.append(f"  {'(sum)':<20} "
                 f"{record.get('attributed_s', 0.0):>12.3f}s")
    return "\n".join(lines)
