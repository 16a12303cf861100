"""ClusterScaler: the reconciliation loop (desired vs actual nodes).

Reference parity: core/_private/cluster/cluster_scaler.py (ClusterScaler:130,
_update:386 with the weak-consistency snapshot contract :388-405,
terminate_nodes_to_enforce_config_constraints:484, launch_required_nodes:645,
update_nodes:690, recover_if_needed:1244, terminate_unhealthy_nodes:1212).

TPU-first divergence: nodes belonging to an atomic node group (pod slice)
are launched, terminated, and health-judged at *group* granularity — one
dead host condemns (and recycles) the whole slice, because the ICI program
spanning it is gone anyway (SURVEY.md §7 "hard parts").
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Set

from cloudtik_tpu_torch.config.hashing import hash_launch_conf, hash_runtime_conf
from cloudtik_tpu_torch.control.demand import ResourceDemandScheduler
from cloudtik_tpu_torch.control.launcher import NodeLauncher, PendingLaunches
from cloudtik_tpu_torch.control.metrics import ClusterMetrics
from cloudtik_tpu_torch.control.quorum import QuorumManager
from cloudtik_tpu_torch.control.updater import NodeUpdaterThread
from cloudtik_tpu_torch.core.node_provider import NodeProvider
from cloudtik_tpu_torch.core.runtime import NodeConstraint
from cloudtik_tpu_torch.core.tags import (
    NODE_KIND_HEAD, NODE_KIND_WORKER, STATUS_UP_TO_DATE, STATUS_UPDATE_FAILED,
    TAG_LAUNCH_CONFIG, TAG_NODE_GROUP_ID, TAG_NODE_KIND, TAG_NODE_STATUS,
    TAG_RUNTIME_CONFIG, TAG_USER_NODE_TYPE)
from cloudtik_tpu_torch import telemetry
from cloudtik_tpu_torch.faults import seams
from cloudtik_tpu_torch.telemetry import events
from cloudtik_tpu_torch.telemetry import instruments as ti
from cloudtik_tpu_torch.utils.constants import (
    TIK_BOOT_GRACE_S, TIK_MAX_CONCURRENT_LAUNCHES,
    TIK_MAX_CONCURRENT_UPDATES)

logger = logging.getLogger(__name__)


class NonTerminatedNodes:
    """One provider snapshot per reconciliation pass (weak consistency: the
    world may drift under us; every decision below uses only this snapshot
    and is safe to be stale by one tick)."""

    def __init__(self, provider: NodeProvider):
        seams.fire("provider.non_terminated_nodes", provider=provider)
        self.all_node_ids = provider.non_terminated_nodes({})
        self.worker_ids: List[str] = []
        self.head_id: Optional[str] = None
        for node_id in self.all_node_ids:
            tags = provider.node_tags(node_id)
            if tags.get(TAG_NODE_KIND) == NODE_KIND_HEAD:
                self.head_id = node_id
            else:
                self.worker_ids.append(node_id)

    def remove(self, node_ids: Set[str]) -> None:
        self.worker_ids = [n for n in self.worker_ids if n not in node_ids]
        self.all_node_ids = [n for n in self.all_node_ids
                             if n not in node_ids]


class ClusterScaler:
    def __init__(
        self,
        config: Dict[str, Any],
        provider: NodeProvider,
        cluster_metrics: ClusterMetrics,
        *,
        max_concurrent_launches: int = TIK_MAX_CONCURRENT_LAUNCHES,
        max_concurrent_updates: int = TIK_MAX_CONCURRENT_UPDATES,
        node_constraints: Optional[Dict[str, NodeConstraint]] = None,
        executor_factory=None,
        update_environment: Optional[Dict[str, str]] = None,
        event_callback=None,
        num_launcher_threads: int = 2,
    ):
        self.config = config
        self.provider = provider
        self.metrics = cluster_metrics
        self.max_concurrent_updates = max_concurrent_updates
        self.executor_factory = executor_factory or self._default_executor
        self.update_environment = update_environment or {}
        self.event_callback = event_callback

        self.cluster_name = config["cluster_name"]
        node_types = config["available_node_types"]
        self.demand_scheduler = ResourceDemandScheduler(
            node_types, config.get("max_workers", 0),
            config["head_node_type"])
        self.quorum = QuorumManager(provider, node_constraints or {})

        # hashes per node type
        auth = config.get("auth", {})
        self.launch_hashes = {
            name: hash_launch_conf(nt.get("node_config", {}), auth)
            for name, nt in node_types.items()}
        self.runtime_hash, self.contents_hash = hash_runtime_conf(
            config.get("file_mounts", {}),
            [config.get("setup_commands", []),
             config.get("worker_setup_commands", []),
             config.get("worker_start_commands", [])])

        self.pending_launches = PendingLaunches()
        self.launch_queue: "queue.Queue" = queue.Queue()
        # counted one-liners per reconcile tick (ref event_summarizer.py:73)
        from cloudtik_tpu_torch.utils.event_summarizer import EventSummarizer
        self.event_summarizer = EventSummarizer()
        # single-flight executor construction: recover + update threads
        # race to build an SSH executor for the same node (ref
        # concurrent_cache.py:21); invalidated on termination
        from cloudtik_tpu_torch.utils.concurrent_cache import ConcurrentObjectCache
        self._executor_cache = ConcurrentObjectCache()
        # categorized launch-failure history surfaced in summary()
        from cloudtik_tpu_torch.control.node_availability import (
            NodeAvailabilityTracker)
        self.availability = NodeAvailabilityTracker()

        def _on_launch_failure(node_type, count, exc):
            self.availability.record_failure(node_type, exc)

        self.launchers = [
            NodeLauncher(provider, self.cluster_name, config,
                         self.launch_queue, self.pending_launches,
                         self.launch_hashes,
                         failure_callback=_on_launch_failure, index=i)
            for i in range(num_launcher_threads)]
        for launcher in self.launchers:
            launcher.start()

        self.updaters: Dict[str, NodeUpdaterThread] = {}
        self.num_failed_updates: Dict[str, int] = {}
        self.num_successful_updates: Dict[str, int] = {}
        # When each node was first seen UP_TO_DATE: a node gets
        # TIK_BOOT_GRACE_S from that point to deliver its first heartbeat
        # before a missing one counts as unhealthy.
        self.first_up_to_date_time: Dict[str, float] = {}
        self.disable_node_updaters = config.get(
            "disable_node_updaters", False)

    # ------------------------------------------------------------------
    def update(self) -> None:
        """One reconciliation pass."""
        t0 = time.perf_counter()
        result = "ok"
        try:
            with telemetry.span("scaler.reconcile"):
                now = time.time()
                nodes = NonTerminatedNodes(self.provider)

                # liveness accounting from the snapshot
                active_ips = [self.provider.internal_ip(n)
                              for n in nodes.all_node_ids]
                self.metrics.prune_active_ips(
                    [ip for ip in active_ips if ip])

                self.process_completed_updates()
                to_terminate = self.collect_terminations(nodes, now)
                if to_terminate:
                    self.terminate_nodes(nodes, to_terminate)
                self.recover_or_terminate_unhealthy(nodes, now)
                if not self.disable_node_updaters:
                    self.update_out_of_date_nodes(nodes)
                self.launch_required_nodes(nodes)
        except Exception:
            result = "failed"
            raise
        finally:
            # count failing passes too: a dead provider must show up as
            # result="failed" rate, not as the reconcile rate going dark
            ti.SCALER_RECONCILES.inc(result=result)
            ti.SCALER_RECONCILE_SECONDS.observe(
                time.perf_counter() - t0)

    def _decide(self, action: str, reason: str, **attrs) -> None:
        """Record a scale decision: a zero-length `scaler.decision` span
        carrying WHY (demand, lost node, idle timeout, ...) plus the
        termination counter when the action removes nodes, and the same
        WHY journaled durably in the flight recorder."""
        telemetry.add_span("scaler.decision", time.time(), 0.0,
                           action=action, reason=reason, **attrs)
        events.emit("tik_scaler_decision", action=action, reason=reason,
                    **attrs)
        if action == "terminate":
            ti.SCALER_TERMINATIONS.inc(
                attrs.get("count", 1), reason=reason)

    # ------------------------------------------------------------------
    def collect_terminations(
        self, nodes: NonTerminatedNodes, now: float
    ) -> Set[str]:
        """Config-constraint terminations: over-max, outdated launch config,
        idle timeout.  Group-expanded."""
        node_types = self.config["available_node_types"]
        idle_timeout_s = self.config.get("idle_timeout_minutes", 10) * 60
        counts: Dict[str, int] = {}
        to_terminate: Set[str] = set()

        for node_id in nodes.worker_ids:
            tags = self.provider.node_tags(node_id)
            node_type = tags.get(TAG_USER_NODE_TYPE, "")
            nt = node_types.get(node_type)
            if nt is None:
                logger.info("terminating %s: unknown node type %r",
                            node_id, node_type)
                self._decide("terminate", "unknown_node_type",
                             node_id=node_id, node_type=node_type)
                to_terminate.add(node_id)
                continue
            if tags.get(TAG_LAUNCH_CONFIG) not in (
                    None, "", self.launch_hashes.get(node_type)):
                logger.info("terminating %s: outdated launch config", node_id)
                self._decide("terminate", "outdated_launch_config",
                             node_id=node_id, node_type=node_type)
                to_terminate.add(node_id)
                continue
            counts[node_type] = counts.get(node_type, 0) + 1
            max_of_type = nt.get("max_workers", 0)
            if counts[node_type] > max_of_type:
                logger.info("terminating %s: over max_workers of type %s",
                            node_id, node_type)
                self._decide("terminate", "over_max_workers",
                             node_id=node_id, node_type=node_type)
                to_terminate.add(node_id)
                continue
            # Idle termination above min_workers.  A node only becomes
            # eligible once it has been SEEN active (first heartbeat seeds
            # last_active_time, metrics.update_heartbeat) and then stayed
            # idle for the full timeout — never on a node we have no
            # activity record for (e.g. still bootstrapping).
            ip = self.provider.internal_ip(node_id)
            min_of_type = nt.get("min_workers", 0)
            if (counts[node_type] > min_of_type and idle_timeout_s > 0
                    and ip and ip in self.metrics.last_active_time
                    and not self.metrics.is_active(ip, idle_timeout_s, now)):
                logger.info("terminating %s: idle > %ds", node_id,
                            idle_timeout_s)
                self._decide("terminate", "idle_timeout",
                             node_id=node_id, node_type=node_type,
                             idle_timeout_s=idle_timeout_s)
                to_terminate.add(node_id)

        if not to_terminate:
            return to_terminate
        expanded = self.quorum.expand_to_group(list(to_terminate))
        # fate-shared members pulled in by atomic-group expansion die
        # too: count them so terminations_total reconciles against the
        # number of nodes that actually disappear
        extra = len(expanded) - len(to_terminate)
        if extra > 0:
            self._decide("terminate", "group_expansion", count=extra)
        return expanded

    def terminate_nodes(self, nodes: NonTerminatedNodes,
                        to_terminate: Set[str]) -> None:
        # Terminating any member of an atomic group takes the whole group
        # down — expand first so the snapshot and updater map reflect every
        # node that actually dies, not just the ones the caller named.
        expanded = self.quorum.expand_to_group(sorted(to_terminate))
        # callers that pass a pre-expanded set (collect_terminations)
        # already accounted for fate-shared members; callers that name
        # single nodes (update_failed) have not — count the delta here
        # so terminations_total always matches nodes that die
        extra = len(expanded) - len(set(to_terminate))
        if extra > 0:
            self._decide("terminate", "group_expansion", count=extra)
        groups = self.quorum.groups_of(sorted(expanded))
        seams.fire("provider.terminate_node", provider=self.provider,
                   node_ids=sorted(expanded))
        all_dead: Set[str] = set()
        with telemetry.span("provider.terminate_nodes",
                            count=len(expanded)):
            for group_id, members in groups.items():
                if group_id and self.provider.supports_node_groups():
                    self.provider.terminate_node_group(group_id)
                else:
                    self.provider.terminate_nodes(members)
                all_dead.update(members)
        nodes.remove(all_dead)
        for node_id in all_dead:
            self.updaters.pop(node_id, None)
            self._executor_cache.invalidate(node_id)

    # ------------------------------------------------------------------
    def recover_or_terminate_unhealthy(
        self, nodes: NonTerminatedNodes, now: float
    ) -> None:
        unhealthy: List[str] = []
        for node_id in nodes.worker_ids:
            tags = self.provider.node_tags(node_id)
            if tags.get(TAG_NODE_STATUS) != STATUS_UP_TO_DATE:
                continue  # still bootstrapping; updater owns it
            ip = self.provider.internal_ip(node_id)
            if not ip:
                continue
            if ip not in self.metrics.nodes:
                # No heartbeat EVER seen: the agent is still coming up.
                # Give it a boot-grace window from when the node first went
                # up-to-date before condemning it (and its whole group).
                first = self.first_up_to_date_time.setdefault(node_id, now)
                if now - first < TIK_BOOT_GRACE_S:
                    continue
            if not self.metrics.heartbeat_on_time(ip, now):
                unhealthy.append(node_id)
        lost = set(self.metrics.lost_nodes)
        unhealthy.extend(n for n in lost if n in nodes.worker_ids)
        if not unhealthy:
            return
        expanded = self.quorum.expand_to_group(unhealthy)
        grouped = self.quorum.groups_of(sorted(expanded))
        for group_id, members in grouped.items():
            # why this group/node is condemned: a runtime reported it
            # LOST, or its heartbeats simply went dark
            reason = ("lost_node" if any(m in lost for m in members)
                      else "heartbeat_timeout")
            if group_id:
                # An atomic group with a dead member cannot be repaired in
                # place (the SPMD program spanning it is gone): recycle it.
                logger.warning("recycling unhealthy node group %s (%d nodes)",
                               group_id, len(members))
                self._decide("terminate", reason, group_id=group_id,
                             count=len(members))
                self.event_summarizer.add_once_per_interval(
                    "Recycling unhealthy node group %s (%d nodes)."
                    % (group_id, len(members)), key="recycle:" + group_id)
                # same seam + span as terminate_nodes: the recycle path
                # is the main termination the chaos drills exercise
                seams.fire("provider.terminate_node",
                           provider=self.provider,
                           node_ids=sorted(members))
                with telemetry.span("provider.terminate_nodes",
                                    count=len(members)):
                    if self.provider.supports_node_groups():
                        self.provider.terminate_node_group(group_id)
                    else:
                        self.provider.terminate_nodes(members)
                nodes.remove(set(members))
                for node_id in members:
                    self._executor_cache.invalidate(node_id)
            else:
                for node_id in members:
                    self.recover_if_needed(node_id, reason)

    def recover_if_needed(self, node_id: str,
                          reason: str = "heartbeat_timeout") -> None:
        """Re-run start commands on a heartbeat-lost node."""
        if self.disable_node_updaters:
            # no updaters to recover with: this is a TERMINATION and
            # must be recorded as one (terminations_total reconciles
            # against nodes that actually die)
            logger.warning("terminating unhealthy node %s", node_id)
            self._decide("terminate", reason, node_id=node_id)
            self.provider.terminate_node(node_id)
            self._executor_cache.invalidate(node_id)
            return
        if node_id in self.updaters:
            return
        logger.warning("recovering node %s: re-running start commands",
                       node_id)
        self._decide("recover", reason, node_id=node_id)
        ti.SCALER_RECOVERIES.inc()
        self.event_summarizer.add_once_per_interval(
            "Restarting %s services on %s." % (self.cluster_name, node_id),
            key="recover:" + node_id)
        self._spawn_updater(node_id, restart_only=True)

    # ------------------------------------------------------------------
    def process_completed_updates(self) -> None:
        for node_id, updater in list(self.updaters.items()):
            if updater.is_alive():
                continue
            del self.updaters[node_id]
            if updater.exitcode == 0:
                self.num_successful_updates[node_id] = \
                    self.num_successful_updates.get(node_id, 0) + 1
            else:
                self.num_failed_updates[node_id] = \
                    self.num_failed_updates.get(node_id, 0) + 1

    def update_out_of_date_nodes(self, nodes: NonTerminatedNodes) -> None:
        for node_id in nodes.worker_ids:
            if len(self.updaters) >= self.max_concurrent_updates:
                break
            if node_id in self.updaters:
                continue
            tags = self.provider.node_tags(node_id)
            status = tags.get(TAG_NODE_STATUS)
            if status == STATUS_UP_TO_DATE and \
                    tags.get(TAG_RUNTIME_CONFIG) == self.runtime_hash:
                continue
            if status == STATUS_UPDATE_FAILED and \
                    self.num_failed_updates.get(node_id, 0) >= 3:
                logger.error("node %s failed %d updates; terminating",
                             node_id, self.num_failed_updates[node_id])
                self._decide("terminate", "update_failed",
                             node_id=node_id)
                self.terminate_nodes(nodes, {node_id})
                continue
            if status not in (None, "", STATUS_UP_TO_DATE,
                              STATUS_UPDATE_FAILED, "uninitialized"):
                continue  # update in progress by tag state
            self._spawn_updater(node_id)

    def _spawn_updater(self, node_id: str, restart_only: bool = False) -> None:
        from cloudtik_tpu_torch.control.updater import shared_memory_ratio
        from cloudtik_tpu_torch.core.tags import TAG_USER_NODE_TYPE
        executor = self.executor_factory(node_id)
        try:
            node_type = self.provider.node_tags(node_id).get(
                TAG_USER_NODE_TYPE, "")
        except Exception:
            node_type = ""
        updater = NodeUpdaterThread(
            node_id, self.provider, executor,
            file_mounts=self.config.get("file_mounts", {}),
            initialization_commands=self.config.get(
                "initialization_commands", []),
            setup_commands=(self.config.get("setup_commands", []) +
                            self.config.get("worker_setup_commands", [])),
            start_commands=self.config.get("worker_start_commands", []),
            runtime_hash=self.runtime_hash,
            file_mounts_contents_hash=self.contents_hash,
            environment_variables=self.update_environment,
            restart_only=restart_only,
            shared_memory_ratio=shared_memory_ratio(
                self.config, node_type),
            traceparent=telemetry.current_traceparent(),
        )
        self.updaters[node_id] = updater
        updater.start()

    def _default_executor(self, node_id: str):
        from cloudtik_tpu_torch.utils.call_context import CallContext

        def build():
            return self.provider.get_command_executor(
                CallContext(), f"[{node_id}] ", node_id,
                self.config.get("auth", {}), self.cluster_name,
                use_internal_ip=True,
                docker_config=self.config.get("docker"))

        return self._executor_cache.get(node_id, build)

    # ------------------------------------------------------------------
    def launch_required_nodes(self, nodes: NonTerminatedNodes) -> None:
        existing: Dict[str, int] = {}
        free: List[Dict[str, float]] = []
        node_types = self.config["available_node_types"]
        for node_id in nodes.worker_ids:
            tags = self.provider.node_tags(node_id)
            node_type = tags.get(TAG_USER_NODE_TYPE, "")
            existing[node_type] = existing.get(node_type, 0) + 1
            ip = self.provider.internal_ip(node_id)
            m = self.metrics.nodes.get(ip) if ip else None
            # Trust agent-reported availability only when it is THIS node's
            # report (shared-ip providers like virtual would otherwise hand
            # one node's metrics to all, making demands look unsatisfiable
            # forever and over-launching).
            if m and m.available_resources and m.node_id == node_id:
                free.append(dict(m.available_resources))
            else:
                free.append(dict(
                    node_types.get(node_type, {}).get("resources", {})))

        to_launch = self.demand_scheduler.get_nodes_to_launch(
            existing, self.pending_launches.counts(),
            self.metrics.get_resource_demands(), free)

        for node_type, count in to_launch.items():
            count = self.quorum.commit_launch(
                node_type, count, existing.get(node_type, 0))
            if count <= 0:
                continue
            logger.info("launching %d x %s", count, node_type)
            self._decide("launch", "demand", node_type=node_type,
                         count=count)
            self.event_summarizer.add(
                "Adding {} node(s) of type %s." % node_type,
                quantity=count)
            self.pending_launches.inc(node_type, count)
            # stamp the reconcile pass's trace on the ask so the
            # launcher thread's provider spans join this scale-up trace
            self.launch_queue.put(
                (node_type, count, telemetry.current_traceparent()))

    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        nodes = NonTerminatedNodes(self.provider)
        by_status: Dict[str, int] = {}
        by_type: Dict[str, int] = {}
        for node_id in nodes.worker_ids:
            tags = self.provider.node_tags(node_id)
            status = tags.get(TAG_NODE_STATUS, "unknown")
            by_status[status] = by_status.get(status, 0) + 1
            node_type = tags.get(TAG_USER_NODE_TYPE, "unknown")
            by_type[node_type] = by_type.get(node_type, 0) + 1
        return {
            "head": nodes.head_id,
            "num_workers": len(nodes.worker_ids),
            "workers_by_status": by_status,
            "workers_by_type": by_type,
            "pending_launches": self.pending_launches.counts(),
            "active_updaters": len(self.updaters),
            "events": self.event_summarizer.summary(),
            "metrics": self.metrics.summary(),
        }

    def shutdown(self) -> None:
        for launcher in self.launchers:
            launcher.stop()
