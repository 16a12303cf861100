"""Async node launcher: background threads creating nodes / node groups.

Reference parity: core/_private/cluster/node_launcher.py
(BaseNodeLauncher, NodeLauncher(threading.Thread):214).  Extended with
group-granular launches for atomic TPU pod slices.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Dict, Optional, Tuple

from cloudtik_tpu_torch.core.node_provider import (
    NodeLaunchException, NodeProvider)
from cloudtik_tpu_torch.core.tags import (
    NODE_KIND_WORKER, STATUS_UNINITIALIZED, TAG_CLUSTER_NAME,
    TAG_LAUNCH_CONFIG, TAG_NODE_KIND, TAG_NODE_STATUS, TAG_USER_NODE_TYPE)
from cloudtik_tpu_torch import telemetry
from cloudtik_tpu_torch.faults import seams
from cloudtik_tpu_torch.telemetry import events
from cloudtik_tpu_torch.telemetry import instruments as ti
from cloudtik_tpu_torch.utils.retry import (
    RetriesExhausted, RetryPolicy, call_with_retry)

logger = logging.getLogger(__name__)

# How a failed launch ask is retried IN the launcher thread before the
# ask is surrendered back to the scaler's reconcile loop.  Exponential
# backoff + jitter through the unified policy (utils/retry.py), so a
# recycling slice that flaps (provider intermittently refusing the
# create) cannot hot-loop the launcher — and every backoff sleep fires
# the `utils.retry` seam, keeping the path drillable.


def _launch_retryable(exc: BaseException) -> bool:
    # provider/transport flaps are worth a backoff; programming or
    # config errors (a bad node_type indexing the config) are not —
    # they would fail identically on every attempt
    return isinstance(exc, Exception) and not isinstance(
        exc, (KeyError, TypeError, AttributeError))


LAUNCH_RETRY_POLICY = RetryPolicy(
    max_attempts=3, base_delay_s=1.0, multiplier=2.0,
    max_delay_s=15.0, jitter=0.2, retryable=_launch_retryable)


class _LauncherStopped(Exception):
    """The launcher was stopped mid-backoff; abandon the retry."""


class PendingLaunches:
    """Thread-safe account of launches in flight, per node type."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: Dict[str, int] = {}

    def inc(self, node_type: str, count: int) -> None:
        with self._lock:
            self._pending[node_type] = self._pending.get(node_type, 0) + count

    def dec(self, node_type: str, count: int) -> None:
        with self._lock:
            remaining = self._pending.get(node_type, 0) - count
            if remaining <= 0:
                self._pending.pop(node_type, None)
            else:
                self._pending[node_type] = remaining

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._pending)

    def total(self) -> int:
        with self._lock:
            return sum(self._pending.values())


class NodeLauncher(threading.Thread):
    """Consumes (node_type, count) asks from a queue and calls the provider.

    For atomic node-group types the whole count is launched as group(s); for
    ordinary types create_node is called with the batch count.
    """

    def __init__(
        self,
        provider: NodeProvider,
        cluster_name: str,
        config: Dict[str, Any],
        launch_queue: "queue.Queue[Tuple[str, int]]",
        pending: PendingLaunches,
        launch_hashes: Dict[str, str],
        failure_callback=None,
        index: int = 0,
        retry_policy: RetryPolicy = LAUNCH_RETRY_POLICY,
    ):
        super().__init__(name=f"tik-node-launcher-{index}", daemon=True)
        self.provider = provider
        self.cluster_name = cluster_name
        self.config = config
        self.queue = launch_queue
        self.pending = pending
        self.launch_hashes = launch_hashes
        self.failure_callback = failure_callback
        self.retry_policy = retry_policy
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def run(self) -> None:
        while not self._stop.is_set():
            try:
                item = self.queue.get(timeout=1.0)
            except queue.Empty:
                continue
            # asks are (node_type, count[, traceparent]): the scaler
            # stamps the reconcile pass's traceparent on each ask, so
            # the provider spans this thread records join the scale-up
            # trace that demanded them
            node_type, count = item[0], item[1]
            traceparent = item[2] if len(item) > 2 else None
            try:
                with telemetry.trace_context(traceparent):
                    self._launch_with_retry(node_type, count)
            except _LauncherStopped:
                pass
            except RetriesExhausted as e:
                logger.error("launch of %d x %s gave up after "
                             "backoff retries: %s", count, node_type, e)
            except Exception:
                logger.exception("launch of %d x %s failed", count, node_type)
            finally:
                self.pending.dec(node_type, count)

    def _launch_with_retry(self, node_type: str, count: int) -> None:
        """One queue ask, retried under the unified backoff policy.

        `launch_failed` asks are NOT immediately re-asked: each retry
        backs off exponentially (with jitter) via `utils/retry.py`, so
        a flapping provider cannot hot-loop this thread.  Partial group
        successes reduce the retried count (the exception carries how
        many nodes DID come up); `pending` stays held across the whole
        retry so the scaler does not double-ask meanwhile.  Failure
        accounting (metrics, `tik_node_launch_failed`, the availability
        callback) runs ONCE per ask, on terminal failure, for the nodes
        that never came up — not once per attempt, which would book a
        3-attempt outage as 3x the failures launches must reconcile
        against.  The sleep is stop-aware: `stop()` aborts a backoff
        immediately.
        """
        remaining = [count]

        def attempt() -> None:
            try:
                self.launch(node_type, remaining[0])
            except BaseException as exc:
                remaining[0] -= getattr(exc, "launched", 0)
                if remaining[0] <= 0:
                    return            # everything requested came up
                raise

        def sleep(delay: float) -> None:
            if self._stop.wait(delay):
                raise _LauncherStopped()

        try:
            call_with_retry(attempt, self.retry_policy, sleep=sleep)
        except _LauncherStopped:
            raise
        except Exception as exc:
            # Exception only: KeyboardInterrupt/SystemExit passing
            # through are interruptions, not launch failures, and must
            # not pollute the launches-vs-failures reconciliation
            cause = exc.last if isinstance(exc, RetriesExhausted) \
                else exc
            self._record_launch_failure(node_type, remaining[0])
            if isinstance(cause, NodeLaunchException) and \
                    self.failure_callback:
                self.failure_callback(node_type, remaining[0], cause)
            raise

    def launch(self, node_type: str, count: int) -> None:
        node_types = self.config["available_node_types"]
        nt = node_types[node_type]
        node_config = nt.get("node_config", {})
        tags = {
            TAG_CLUSTER_NAME: self.cluster_name,
            TAG_NODE_KIND: NODE_KIND_WORKER,
            TAG_NODE_STATUS: STATUS_UNINITIALIZED,
            TAG_USER_NODE_TYPE: node_type,
            TAG_LAUNCH_CONFIG: self.launch_hashes.get(node_type, ""),
        }
        group = nt.get("node_group") or {}
        launched = 0
        try:
            with telemetry.span("provider.create_node",
                                node_type=node_type, count=count):
                seams.fire("provider.create_node", provider=self.provider,
                           node_type=node_type, count=count)
                if group.get("atomic") and \
                        self.provider.supports_node_groups():
                    group_size = int(group.get("group_size", 1))
                    n_groups = max(count // group_size, 1)
                    # whole groups launch, so the real node count is
                    # group_size per completed group, not the raw ask —
                    # and a partial failure still counts the groups
                    # that DID come up
                    for _ in range(n_groups):
                        self.provider.create_node_group(
                            node_config, dict(tags), group_size)
                        launched += group_size
                else:
                    self.provider.create_node_with_resources_and_labels(
                        node_config, tags, count,
                        nt.get("resources", {}), nt.get("labels", {}))
                    launched = count
            ti.NODE_LAUNCHES.inc(launched, node_type=node_type)
            events.emit("tik_node_launch", node_type=node_type,
                        count=launched)
        except NodeLaunchException as e:
            self._credit_partial_launch(node_type, launched)
            logger.error("node launch failed (%s): %s", e.category,
                         e.description)
            e.launched = launched
            raise
        except Exception as e:
            self._credit_partial_launch(node_type, launched)
            # the retry wrapper subtracts partial group successes so a
            # retried ask never over-launches (best effort: some
            # exception types refuse new attributes)
            try:
                e.launched = launched
            except (AttributeError, TypeError):
                pass
            raise

    @staticmethod
    def _credit_partial_launch(node_type: str, launched: int) -> None:
        """launches + failures must reconcile against nodes that exist:
        groups that DID come up before the failure still count."""
        if launched:
            ti.NODE_LAUNCHES.inc(launched, node_type=node_type)
            events.emit("tik_node_launch", node_type=node_type,
                        count=launched)

    @staticmethod
    def _record_launch_failure(node_type: str, failed: int) -> None:
        """Terminal failure of one ask: the nodes that never came up
        despite every retry."""
        ti.NODE_LAUNCH_FAILURES.inc(max(failed, 1),
                                    node_type=node_type)
        events.emit("tik_node_launch_failed", node_type=node_type,
                    count=max(failed, 1))
