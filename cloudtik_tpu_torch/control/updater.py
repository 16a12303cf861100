"""Node updater: per-node bootstrap over the command executor.

Reference parity: core/_private/node/node_updater.py (NodeUpdater:41,
run:151, do_update:433, wait_ready:290, sync_file_mounts:217,
NodeUpdaterThread:791).

Lifecycle (status tag transitions):
    uninitialized -> waiting-for-ssh -> syncing-files -> setting-up ->
    up-to-date | update-failed
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch import telemetry
from cloudtik_tpu_torch.control.executor.base import CommandError, CommandExecutor
from cloudtik_tpu_torch.telemetry import events
from cloudtik_tpu_torch.telemetry import instruments as ti
from cloudtik_tpu_torch.core.node_provider import NodeProvider
from cloudtik_tpu_torch.core.tags import (
    STATUS_SETTING_UP, STATUS_SYNCING_FILES, STATUS_UPDATE_FAILED,
    STATUS_UP_TO_DATE, STATUS_WAITING_FOR_SSH, TAG_FILE_MOUNTS_CONTENTS,
    TAG_NODE_STATUS, TAG_RUNTIME_CONFIG)
from cloudtik_tpu_torch.utils.constants import TIK_NODE_START_WAIT_S
from cloudtik_tpu_torch.utils.retry import (
    RetriesExhausted, RetryPolicy, call_with_retry)

logger = logging.getLogger(__name__)


class _NodeTerminated(Exception):
    """Non-retryable: the node died while we were waiting for it."""


def shared_memory_ratio(config: Dict[str, Any],
                        node_type: str = "") -> float:
    """Max /dev/shm demand any configured runtime declares for this node
    type — sizes the docker --shm-size at container init (reference:
    node_updater.py:451 get_shared_memory_ratio)."""
    from cloudtik_tpu_torch.runtimes.registry import iter_runtimes
    ratio = 0.0
    try:
        for runtime in iter_runtimes(config):
            ratio = max(ratio, float(
                runtime.get_runtime_shared_memory_ratio(
                    config, node_type) or 0.0))
    except Exception:
        logger.warning("cannot compute shared-memory ratio",
                       exc_info=True)
    return ratio


class NodeUpdater:
    def __init__(
        self,
        node_id: str,
        provider: NodeProvider,
        executor: CommandExecutor,
        *,
        file_mounts: Optional[Dict[str, str]] = None,
        initialization_commands: Optional[List[str]] = None,
        setup_commands: Optional[List[str]] = None,
        start_commands: Optional[List[str]] = None,
        runtime_hash: str = "",
        file_mounts_contents_hash: Optional[str] = None,
        environment_variables: Optional[Dict[str, str]] = None,
        is_head_node: bool = False,
        wait_ready_timeout_s: int = TIK_NODE_START_WAIT_S,
        restart_only: bool = False,
        no_restart: bool = False,
        shared_memory_ratio: float = 0.0,
        traceparent: Optional[str] = None,
    ):
        self.node_id = node_id
        self.provider = provider
        self.executor = executor
        self.file_mounts = file_mounts or {}
        self.initialization_commands = initialization_commands or []
        self.setup_commands = setup_commands or []
        self.start_commands = start_commands or []
        self.runtime_hash = runtime_hash
        self.file_mounts_contents_hash = file_mounts_contents_hash
        self.environment_variables = environment_variables or {}
        self.is_head_node = is_head_node
        self.wait_ready_timeout_s = wait_ready_timeout_s
        self.restart_only = restart_only
        self.no_restart = no_restart
        self.shared_memory_ratio = shared_memory_ratio
        # trace context of the operation that spawned this updater
        # (the scaler's reconcile pass): this thread's phase spans and
        # the commands it issues join that trace instead of minting
        # disconnected per-phase traces
        self.traceparent = traceparent
        self.error: Optional[Exception] = None

    def _set_status(self, status: str) -> None:
        self.provider.set_node_tags(self.node_id, {TAG_NODE_STATUS: status})

    def run(self) -> None:
        try:
            with telemetry.trace_context(self.traceparent):
                self.do_update()
            self._record_result("ok")
        except Exception as e:
            self.error = e
            self._record_result("failed")
            try:
                self._set_status(STATUS_UPDATE_FAILED)
            except Exception:
                pass
            logger.exception("node %s update failed", self.node_id)
            raise

    def _record_result(self, result: str) -> None:
        ti.NODE_UPDATES.inc(result=result)
        events.emit("tik_node_update", node_id=self.node_id,
                    result=result, restart_only=self.restart_only)

    def _phase(self, name: str):
        """Span + tik_updater_phase_seconds for one bootstrap phase."""
        return telemetry.timed_span(
            name, ti.UPDATER_PHASE_SECONDS,
            {"phase": name.split(".", 1)[1]}, node_id=self.node_id)

    def wait_ready(self) -> None:
        self._set_status(STATUS_WAITING_FOR_SSH)
        # a zero/negative wait means fail-fast after one probe, not
        # "no limits" (max_attempts=0 + deadline_s=0 would disable both)
        policy = RetryPolicy(
            max_attempts=0 if self.wait_ready_timeout_s > 0 else 1,
            base_delay_s=5.0, multiplier=1.0, jitter=0.0,
            deadline_s=max(self.wait_ready_timeout_s, 0),
            retryable=lambda e: (isinstance(e, Exception)
                                 and not isinstance(e, _NodeTerminated)))

        def probe():
            if self.provider.is_terminated(self.node_id):
                raise _NodeTerminated(self.node_id)
            self.executor.run("uptime", with_output=True, timeout=20)

        try:
            with self._phase("updater.wait_ready"):
                call_with_retry(probe, policy)
        except _NodeTerminated:
            raise RuntimeError(
                f"node {self.node_id} terminated while waiting for boot")
        except RetriesExhausted as e:
            raise TimeoutError(
                f"node {self.node_id} not reachable after "
                f"{self.wait_ready_timeout_s}s: {e.last}") from e.last

    def sync_file_mounts(self) -> None:
        self._set_status(STATUS_SYNCING_FILES)
        with self._phase("updater.sync_files"):
            for remote, local in sorted(self.file_mounts.items()):
                self.executor.run_rsync_up(local, remote)

    def do_update(self) -> None:
        self.wait_ready()

        changed = self.executor.run_init(
            as_head=self.is_head_node, file_mounts=self.file_mounts,
            sync_run_yet=False,
            shared_memory_ratio=self.shared_memory_ratio)
        self.sync_file_mounts()
        if changed:
            self.sync_file_mounts()

        if not self.restart_only:
            self._set_status(STATUS_SETTING_UP)
            with self._phase("updater.setup"):
                for cmd in self.initialization_commands:
                    self.executor.run(
                        cmd,
                        environment_variables=self.environment_variables,
                        run_env="host")
                for cmd in self.setup_commands:
                    self.executor.run(
                        cmd,
                        environment_variables=self.environment_variables)

        if not self.no_restart:
            with self._phase("updater.start_services"):
                for cmd in self.start_commands:
                    self.executor.run(
                        cmd,
                        environment_variables=self.environment_variables)

        tags = {
            TAG_NODE_STATUS: STATUS_UP_TO_DATE,
            TAG_RUNTIME_CONFIG: self.runtime_hash,
        }
        if self.file_mounts_contents_hash is not None:
            tags[TAG_FILE_MOUNTS_CONTENTS] = self.file_mounts_contents_hash
        self.provider.set_node_tags(self.node_id, tags)


class NodeUpdaterThread(NodeUpdater, threading.Thread):
    def __init__(self, *args, **kwargs):
        threading.Thread.__init__(self, daemon=True)
        NodeUpdater.__init__(self, *args, **kwargs)
        self.exitcode = -1

    def run(self) -> None:  # type: ignore[override]
        try:
            with telemetry.trace_context(self.traceparent):
                self.do_update()
            self.exitcode = 0
            self._record_result("ok")
        except Exception as e:
            self.error = e
            self._record_result("failed")
            try:
                self._set_status(STATUS_UPDATE_FAILED)
            except Exception:
                pass
            self.exitcode = 1
            logger.exception("node %s update failed", self.node_id)
