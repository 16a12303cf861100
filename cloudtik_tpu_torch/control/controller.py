"""Cluster controller: the head daemon looping the scaler.

Reference parity: core/_private/service/cloudtik_cluster_controller.py
(ClusterController:42, _run:158 every 5s) + resource_scaling_policy.py:13
(the bridge pulling runtime-published ScalingStates each tick) + the
Prometheus metrics server (prometheus_metrics.py:275, port 44217).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.control.metrics import ClusterMetrics
from cloudtik_tpu_torch.control.scaler import ClusterScaler
from cloudtik_tpu_torch.control.state import (
    StateClient, TABLE_HEARTBEAT, TABLE_METRICS, TABLE_NODES,
    TABLE_SCALING)
from cloudtik_tpu_torch.core.node_provider import NodeProvider
from cloudtik_tpu_torch.core.tags import (
    NODE_KIND_HEAD, TAG_NODE_KIND, TAG_NODE_SEQ_ID)
from cloudtik_tpu_torch.core.scaling_policy import ScalingPolicy
from cloudtik_tpu_torch.utils.constants import (
    TIK_METRICS_PORT_DEFAULT, TIK_UPDATE_INTERVAL_S)

logger = logging.getLogger(__name__)


class ClusterController:
    def __init__(
        self,
        config: Dict[str, Any],
        provider: NodeProvider,
        state_client: StateClient,
        *,
        scaling_policies: Optional[List[ScalingPolicy]] = None,
        update_interval_s: float = TIK_UPDATE_INTERVAL_S,
        metrics_port: Optional[int] = None,
        executor_factory=None,
        node_constraints=None,
    ):
        self.config = config
        self.provider = provider
        self.state = state_client
        self.scaling_policies = scaling_policies or []
        self.update_interval_s = update_interval_s
        self.cluster_metrics = ClusterMetrics()
        self.scaler = ClusterScaler(
            config, provider, self.cluster_metrics,
            executor_factory=executor_factory,
            node_constraints=node_constraints)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ticks = 0
        self.event_retention_ticks = 500
        self.last_error: Optional[str] = None
        if metrics_port:
            self._start_metrics_server(metrics_port)

    # -- inputs -------------------------------------------------------------
    def _pull_heartbeats(self) -> None:
        for node_id, hb in self.state.table_list(TABLE_HEARTBEAT).items():
            self.cluster_metrics.update_heartbeat(
                hb.get("node_ip", ""), node_id, hb.get("time"))

    def _pull_node_metrics(self) -> None:
        for node_id, m in self.state.table_list(TABLE_METRICS).items():
            ip = m.get("node_ip", "")
            self.cluster_metrics.update_node_resources(
                ip, node_id,
                m.get("total_resources", {}),
                m.get("available_resources", {}),
                {"cpu": m.get("cpu_percent", 0) / 100.0,
                 "memory": m.get("memory_percent", 0) / 100.0})
            # nodes doing real work are exempt from idle termination
            if m.get("cpu_percent", 0) > 15.0:
                self.cluster_metrics.mark_active(ip)

    def _pull_scaling_states(self) -> None:
        demands: List[Dict[str, float]] = []
        lost: Dict[str, str] = {}
        for policy in self.scaling_policies:
            try:
                state = policy.get_scaling_state()
            except Exception:
                logger.exception("scaling policy %s failed", policy.name())
                continue
            if state is None:
                continue
            instr = state.autoscaling_instructions or {}
            demands.extend(instr.get("resource_demands", []))
            if state.lost_nodes:
                lost.update(state.lost_nodes)
        # runtime-published scaling states (from the state table)
        for _key, published in self.state.table_list(TABLE_SCALING).items():
            demands.extend(published.get("resource_demands", []))
        self.cluster_metrics.set_resource_demands(demands)
        self.cluster_metrics.set_lost_nodes(lost)

    def _publish_node_table(self) -> None:
        """Authoritative cluster membership into TABLE_NODES — consumed by
        quorum runtimes (etcd/zookeeper/kafka/...) and the DNS renderers.

        Also assigns stable seq ids (TAG_NODE_SEQ_ID) to untagged nodes:
        head=1, workers get the smallest unused id — mysql server ids, zk
        myids and DNS names depend on these staying unique and stable.
        The tick loop is single-threaded, so assignment is race-free.
        """
        try:
            node_ids = self.provider.non_terminated_nodes({})
        except Exception:
            logger.exception("node-table snapshot failed")
            return
        snapshot = []
        for node_id in node_ids:
            try:
                tags = self.provider.node_tags(node_id)
                ip = self.provider.internal_ip(node_id)
            except Exception:
                continue
            snapshot.append((node_id, tags, ip))
        used = {int(t.get(TAG_NODE_SEQ_ID, 0) or 0)
                for _, t, _ in snapshot}
        next_seq = 2  # 1 is reserved for the head
        live = set()
        for node_id, tags, ip in snapshot:
            kind = tags.get(TAG_NODE_KIND, "worker")
            seq = int(tags.get(TAG_NODE_SEQ_ID, 0) or 0)
            if seq <= 0:
                if kind == NODE_KIND_HEAD:
                    seq = 1
                else:
                    while next_seq in used:
                        next_seq += 1
                    seq = next_seq
                used.add(seq)
                try:
                    self.provider.set_node_tags(
                        node_id, {TAG_NODE_SEQ_ID: str(seq)})
                except Exception:
                    logger.exception("seq-id tagging failed for %s",
                                     node_id)
            live.add(node_id)
            self.state.table_put(TABLE_NODES, node_id, {
                "ip": ip or "",
                "kind": kind,
                "is_head": kind == NODE_KIND_HEAD,
                "seq_id": seq,
                "time": time.time(),
            })
        for stale in self.state.table_list(TABLE_NODES):
            if stale not in live:
                self.state.table_delete(TABLE_NODES, stale)

    # -- loop ---------------------------------------------------------------
    def tick(self) -> None:
        self._pull_heartbeats()
        self._pull_node_metrics()
        self._pull_scaling_states()
        self._publish_node_table()
        self.scaler.update()
        self.ticks += 1
        # drain the tick's aggregated events into the log + event table
        # (key = tick:index — time-based keys collide within one tick)
        events = self.scaler.event_summarizer.drain()
        now = time.time()
        for i, line in enumerate(events):
            logger.info("cluster event: %s", line)
            self.state.table_put(
                "events", f"{self.ticks:08d}:{i:03d}",
                {"time": now, "message": line})
        if events:
            # bounded-window retention, same stance as the log agent: a
            # recurring per-tick event (e.g. a recycle warning) must not
            # grow the head state store without bound
            cutoff = f"{max(self.ticks - self.event_retention_ticks, 0):08d}"
            for key in self.state.table_keys("events"):
                if key[:8] < cutoff:
                    self.state.table_delete("events", key)
        summary = self.scaler.summary()
        summary["events"] = events
        self.state.table_put("controller", "status", {
            "time": now,
            "ticks": self.ticks,
            "summary": summary,
            "last_error": self.last_error,
        })

    def run_forever(self) -> None:
        while not self._stop.is_set():
            start = time.time()
            try:
                self.tick()
                self.last_error = None
            except Exception as e:
                self.last_error = str(e)
                logger.exception("controller tick failed")
            elapsed = time.time() - start
            self._stop.wait(max(self.update_interval_s - elapsed, 0.1))

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.run_forever, name="tik-controller", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.scaler.shutdown()

    # -- observability ------------------------------------------------------
    def _start_metrics_server(self, port: int) -> None:
        try:
            from prometheus_client import Gauge, start_http_server

            start_http_server(port)
            self._g_workers = Gauge(
                "tik_cluster_workers", "non-terminated worker count")
            self._g_pending = Gauge(
                "tik_pending_launches", "launches in flight")
            self._g_updaters = Gauge(
                "tik_active_updaters", "node updaters running")

            def _export():
                while not self._stop.is_set():
                    try:
                        summary = self.scaler.summary()
                        self._g_workers.set(summary["num_workers"])
                        self._g_pending.set(
                            sum(summary["pending_launches"].values()))
                        self._g_updaters.set(summary["active_updaters"])
                    except Exception:
                        pass
                    self._stop.wait(5)

            threading.Thread(target=_export, daemon=True,
                             name="tik-metrics-export").start()
        except Exception:
            logger.exception("failed to start metrics server on %d", port)
