"""Per-step breakdown profiler: where one training step's time goes.

Counterpart of `cloudtik_tpu/telemetry/stepprof.py`, booking into the same
goodput buckets and metric names:

  * :class:`StepProfiler` — monotonic-clock segmentation of each training
    step into data-wait / host-transfer / dispatch, feeding the per-segment
    histograms and the goodput ledger.  Steps at or below the replay
    horizon (a resume from an older checkpoint) attribute to
    ``restart_replay``.  The synchronous window boundary (the trainer's
    ``float()`` of the metrics waits for the card) attributes to
    ``step_compute``.
  * the **compile-tracking seam** — the port compiles its kernels with
    `nvcc` at first use (`ops/_kernels.py` `build_all`); a build listener
    books each build's wall to the ``compile`` bucket the moment it ends,
    and the profiler subtracts compile time seen during a dispatch from
    that step's dispatch attribution, so buckets never double count.
  * **straggler detection** — per-host step publish times through the
    ``train_progress`` state table; :func:`detect_stragglers` compares
    them.

Plus the on-demand profiler window: ``tik profile capture --steps N``
drops a request file; :class:`ProfileCapture` (polled by the trainer at
window boundaries) runs `torch.profiler` for exactly N steps and writes a
Chrome trace into the requested directory.

Disabled discipline: every record path is a single attribute check under
``TIK_TELEMETRY=off``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.telemetry import core
from cloudtik_tpu_torch.telemetry import goodput
from cloudtik_tpu_torch.telemetry import instruments as ti

logger = logging.getLogger(__name__)

# state table the trainer's progress callback publishes into (reuses
# the head state server the heartbeats already flow through)
TABLE_TRAIN_PROGRESS = "train_progress"

DEFAULT_STRAGGLER_LAG_S = 10.0


# ------------------------------------------------------ compile seam --

_compile_lock = threading.Lock()
_compile_installed = False
_compile_target: Optional[goodput.GoodputLedger] = None


def _on_build(seconds: float, sources: List[str]) -> None:
    if not core.STATE.enabled:
        return
    target = _compile_target
    if target is None:
        return
    target.attribute(goodput.BUCKET_COMPILE, seconds)
    ti.TRAIN_COMPILES.inc(len(sources))


def install_compile_tracking(
        ledger: Optional[goodput.GoodputLedger] = None) -> bool:
    """Register the kernel-build listener that attributes every `nvcc`
    build of the port's kernels (`ops/_kernels.py`) to the ledger's
    ``compile`` bucket and counts one compile per source built.  The
    listener registers once per process; the TARGET ledger rebinds on
    every call (the last installer owns the compile attributions).
    Returns True when the listener is installed.  It checks the
    telemetry gate at fire time."""
    global _compile_installed, _compile_target
    from cloudtik_tpu_torch.ops import _kernels

    with _compile_lock:
        _compile_target = ledger if ledger is not None \
            else goodput.LEDGER
        if not _compile_installed:
            _kernels.BUILD_LISTENERS.append(_on_build)
            _compile_installed = True
        return True


# ------------------------------------------------------ step profiler --

class StepProfiler:
    """Segments each step's wall time and feeds the goodput ledger.

    `replay_until`: steps <= this index are re-runs after a resume from
    an older checkpoint — their whole time goes to `restart_replay`.
    """

    def __init__(self, ledger: Optional[goodput.GoodputLedger] = None,
                 replay_until: int = 0):
        self.ledger = ledger if ledger is not None else goodput.LEDGER
        self.replay_until = int(replay_until)
        self._compile_marker = 0.0

    def dispatch_begin(self) -> None:
        """Mark the compile-bucket watermark so compile time landing
        during the coming dispatch can be subtracted from it."""
        if not core.STATE.enabled:
            return
        self._compile_marker = self.ledger.total(goodput.BUCKET_COMPILE)

    def record_step(self, step: int, data_wait_s: float,
                    transfer_s: float, dispatch_s: float,
                    prefetch_wait_s: float = 0.0) -> None:
        """Account one step's segments.  Single attribute check when
        telemetry is off.

        `prefetch_wait_s`: with the async input pipeline enabled the
        loop's only input-side wait is the queue hand-off; it still
        attributes to the ledger's ``data_wait`` bucket (an honest
        residual wait, and where a `train.prefetch.next` latency fault
        must land) but stays out of the per-step data-wait histogram —
        that one collapses toward zero instead of silently absorbing
        the queue wait (`tik_train_prefetch_consumer_wait_seconds`
        carries it, observed by the prefetcher itself).
        """
        if not core.STATE.enabled:
            return
        ti.TRAIN_DATA_WAIT_SECONDS.observe(data_wait_s)
        ti.TRAIN_HOST_TRANSFER_SECONDS.observe(transfer_s)
        # compile time the seam attributed during this dispatch is
        # already in the compile bucket; keep the dispatch attribution
        # disjoint so buckets sum to wall
        compiled = max(
            self.ledger.total(goodput.BUCKET_COMPILE)
            - self._compile_marker, 0.0)
        dispatch_attr = max(dispatch_s - compiled, 0.0)
        ti.TRAIN_DISPATCH_SECONDS.observe(dispatch_attr)
        wait_s = data_wait_s + prefetch_wait_s
        if step <= self.replay_until:
            self.ledger.attribute(
                goodput.BUCKET_RESTART_REPLAY,
                wait_s + transfer_s + dispatch_attr)
            return
        self.ledger.attribute(goodput.BUCKET_DATA_WAIT, wait_s)
        self.ledger.attribute(goodput.BUCKET_HOST_TRANSFER, transfer_s)
        self.ledger.attribute(goodput.BUCKET_STEP_COMPUTE, dispatch_attr)

    def record_grad_sync(self, step: int, seconds: float) -> None:
        """An accumulated step's gradient-sync tail (the `train.grad_sync`
        seam and the closing gather): the grad_sync bucket, or replay
        behind the horizon."""
        if not core.STATE.enabled:
            return
        ti.TRAIN_GRAD_SYNC_SECONDS.observe(seconds)
        bucket = goodput.BUCKET_RESTART_REPLAY \
            if step <= self.replay_until else goodput.BUCKET_GRAD_SYNC
        self.ledger.attribute(bucket, seconds)

    def record_sync(self, step: int, seconds: float) -> None:
        """The blocking window boundary: queued device work retiring
        under the host transfer of the metrics is compute (or replay
        when the window is still behind the horizon)."""
        if not core.STATE.enabled:
            return
        bucket = goodput.BUCKET_RESTART_REPLAY \
            if step <= self.replay_until else goodput.BUCKET_STEP_COMPUTE
        self.ledger.attribute(bucket, seconds)


# -------------------------------------------------- straggler detection --

def publish_progress(state_client, node_id: str, step: int,
                     now: Optional[float] = None) -> None:
    """Publish this host's step watermark through the state path the
    heartbeats already use (head table `train_progress`)."""
    state_client.table_put(TABLE_TRAIN_PROGRESS, node_id, {
        "node_id": node_id,
        "step": int(step),
        "time": time.time() if now is None else now,
    })


def progress_callback(state_client, node_id: str):
    """A Trainer `callbacks=` entry that publishes progress every log
    window — per-host step publish times for straggler detection."""
    def _cb(trainer, _entry) -> None:
        try:
            publish_progress(state_client, node_id, trainer.step)
        except Exception:
            logger.warning("train progress publish failed",
                           exc_info=True)
    return _cb


def detect_stragglers(progress: Dict[str, Dict[str, Any]],
                      now: Optional[float] = None,
                      lag_threshold_s: float = DEFAULT_STRAGGLER_LAG_S
                      ) -> Dict[str, Any]:
    """Compare per-host step publish times.

    For hosts at the max published step, lag is publish-time skew
    behind the fastest host; for hosts behind the max step, lag is how
    stale their last publish is.  Hosts whose lag exceeds
    `lag_threshold_s` are stragglers.  Sets the
    `tik_train_straggler_lag_seconds` gauge to the worst lag.
    """
    now = time.time() if now is None else now
    rows = {}
    for node_id, record in (progress or {}).items():
        try:
            rows[node_id] = (int(record["step"]), float(record["time"]))
        except (KeyError, TypeError, ValueError):
            continue
    if not rows:
        return {"max_step": None, "lags": {}, "stragglers": []}
    max_step = max(step for step, _t in rows.values())
    fastest = min(t for step, t in rows.values() if step == max_step)
    lags: Dict[str, float] = {}
    for node_id, (step, t) in rows.items():
        if step == max_step:
            lags[node_id] = max(t - fastest, 0.0)
        else:
            lags[node_id] = max(now - t, 0.0)
    worst = max(lags.values())
    ti.TRAIN_STRAGGLER_LAG.set(worst)
    return {
        "max_step": max_step,
        "lags": {k: round(v, 3) for k, v in sorted(lags.items())},
        "stragglers": sorted(k for k, v in lags.items()
                             if v > lag_threshold_s),
    }


# ----------------------------------------------------- xprof capture --

REQUEST_ENV = "TIK_PROFILE_REQUEST"


def request_path() -> str:
    override = os.environ.get(REQUEST_ENV)
    if override:
        return os.path.expanduser(override)
    from cloudtik_tpu_torch.utils.constants import tik_home
    return os.path.join(tik_home(), "profile-request.json")


def request_capture(steps: int, output_dir: str,
                    path: Optional[str] = None) -> str:
    """Drop a capture request the next training window picks up."""
    path = path or request_path()
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    os.makedirs(os.path.expanduser(output_dir), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"steps": int(steps),
                   "output_dir": os.path.expanduser(output_dir),
                   "requested_at": time.time()}, f)
    os.replace(tmp, path)
    return path


def take_request(path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """Consume a pending capture request (read + unlink), if any."""
    path = path or request_path()
    try:
        with open(path) as f:
            request = json.load(f)
    except (OSError, ValueError):
        return None
    try:
        os.unlink(path)
    except OSError:
        pass
    if not isinstance(request, dict) or "output_dir" not in request:
        return None
    return request


class ProfileCapture:
    """On-demand `torch.profiler` window inside a running training loop.

    The trainer polls at window boundaries (one os.path.exists when
    idle); when a request is found, a profiler over the CPU (and the
    card, when there is one) starts and runs until N more steps
    complete; then, after a synchronise, the trace is written to
    ``<output_dir>/trace.json`` (chrome://tracing, Perfetto).
    """

    def __init__(self, path: Optional[str] = None):
        self._path = path or request_path()
        self.active = False
        self._remaining = 0
        self._output_dir: Optional[str] = None
        self._profiler = None

    def poll(self) -> bool:
        """Check for a pending request; start the profiler if found."""
        if self.active or not os.path.exists(self._path):
            return self.active
        request = take_request(self._path)
        if request is None:
            return False
        return self.start(request["output_dir"],
                          max(int(request.get("steps", 1)), 1))

    def start(self, output_dir: str, steps: int = 0) -> bool:
        """Start the profiler now, writing into `output_dir`; it stops
        after `steps` completed steps, or (0) only at `stop()`."""
        try:
            import torch
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(output_dir, exist_ok=True)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
        except Exception:
            logger.warning("profile capture failed to start",
                           exc_info=True)
            return False
        self._profiler = profiler
        self.active = True
        self._remaining = steps
        self._output_dir = output_dir
        logger.info("profile capture started: %s -> %s",
                    f"{steps} step(s)" if steps else "until stopped",
                    output_dir)
        return True

    def step_done(self, sync_leaf: Any = None) -> None:
        """Count one completed step while a capture of a step count is
        active."""
        if not self.active or not self._remaining:
            return
        self._remaining -= 1
        if self._remaining <= 0:
            self.stop(sync_leaf)

    def stop(self, sync_leaf: Any = None) -> None:
        """End the capture; `sync_leaf` (a tensor of the live state) is
        waited for first, so the trace holds the steps' device work."""
        if not self.active:
            return
        try:
            import torch
            if sync_leaf is not None and getattr(sync_leaf, "is_cuda",
                                                 False):
                torch.cuda.synchronize(sync_leaf.device)
            self._profiler.stop()
            path = os.path.join(self._output_dir, "trace.json")
            self._profiler.export_chrome_trace(path)
            logger.info("profile capture written to %s", path)
        except Exception:
            logger.warning("profile capture failed to stop",
                           exc_info=True)
        finally:
            self.active = False
            self._remaining = 0
            self._profiler = None
