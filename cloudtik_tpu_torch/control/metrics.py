"""Cluster metrics: heartbeat liveness + resource accounting for the scaler.

Reference parity: core/_private/cluster/cluster_metrics.py (ClusterMetrics:78,
update_heartbeat:114, mark_active:208, prune_active_ips:219,
get_resource_demands:309, set_resource_requests:372) and
state/scaling_state.py (NodeHeartbeatState:21).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.utils.constants import TIK_HEARTBEAT_TIMEOUT_S


class NodeMetrics:
    """Last-known per-node state fed by the node agent."""

    def __init__(self, node_id: str, node_ip: str):
        self.node_id = node_id
        self.node_ip = node_ip
        self.last_heartbeat_time = 0.0
        self.total_resources: Dict[str, float] = {}
        self.available_resources: Dict[str, float] = {}
        self.utilization: Dict[str, float] = {}


class ClusterMetrics:
    """Thread-safe aggregation consumed each reconciliation tick."""

    def __init__(self, heartbeat_timeout_s: int = TIK_HEARTBEAT_TIMEOUT_S):
        self._lock = threading.RLock()
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.nodes: Dict[str, NodeMetrics] = {}         # by ip
        self.last_active_time: Dict[str, float] = {}    # ip -> time
        # Explicit resource asks (api request_resources / scaling policies).
        self.resource_requests: List[Dict[str, float]] = []
        self.resource_demands: List[Dict[str, float]] = []
        self.lost_nodes: Dict[str, str] = {}            # node_id -> ip

    # --- heartbeats ---------------------------------------------------------
    def update_heartbeat(self, node_ip: str, node_id: str,
                         heartbeat_time: Optional[float] = None) -> None:
        with self._lock:
            metrics = self.nodes.get(node_ip)
            if metrics is None:
                metrics = NodeMetrics(node_id, node_ip)
                self.nodes[node_ip] = metrics
                # First sighting counts as activity: a fresh node gets the
                # full idle_timeout grace before idle termination can fire.
                self.last_active_time.setdefault(
                    node_ip, heartbeat_time or time.time())
            metrics.last_heartbeat_time = heartbeat_time or time.time()

    def update_node_resources(
        self, node_ip: str, node_id: str,
        total: Dict[str, float], available: Dict[str, float],
        utilization: Optional[Dict[str, float]] = None,
    ) -> None:
        with self._lock:
            metrics = self.nodes.get(node_ip)
            if metrics is None:
                metrics = NodeMetrics(node_id, node_ip)
                self.nodes[node_ip] = metrics
            metrics.total_resources = dict(total)
            metrics.available_resources = dict(available)
            if utilization is not None:
                metrics.utilization = dict(utilization)

    def mark_active(self, node_ip: str,
                    last_active: Optional[float] = None) -> None:
        with self._lock:
            self.last_active_time[node_ip] = last_active or time.time()

    def prune_active_ips(self, active_ips: List[str]) -> None:
        """Forget state for ips not in the current provider snapshot."""
        active = set(active_ips)
        with self._lock:
            for ip in list(self.nodes):
                if ip not in active:
                    del self.nodes[ip]
            for ip in list(self.last_active_time):
                if ip not in active:
                    del self.last_active_time[ip]

    def heartbeat_on_time(self, node_ip: str,
                          now: Optional[float] = None) -> bool:
        now = now or time.time()
        with self._lock:
            metrics = self.nodes.get(node_ip)
            if metrics is None or metrics.last_heartbeat_time == 0:
                return False
            return now - metrics.last_heartbeat_time < self.heartbeat_timeout_s

    def is_active(self, node_ip: str, idle_timeout_s: float,
                  now: Optional[float] = None) -> bool:
        """Busy recently enough to be exempt from idle termination."""
        now = now or time.time()
        with self._lock:
            last = self.last_active_time.get(node_ip)
            return last is not None and now - last < idle_timeout_s

    # --- demands ------------------------------------------------------------
    def set_resource_requests(self, requests: List[Dict[str, float]]) -> None:
        with self._lock:
            self.resource_requests = list(requests)

    def set_resource_demands(self, demands: List[Dict[str, float]]) -> None:
        with self._lock:
            self.resource_demands = list(demands)

    def set_lost_nodes(self, lost: Dict[str, str]) -> None:
        with self._lock:
            self.lost_nodes = dict(lost)

    def get_resource_demands(self) -> List[Dict[str, float]]:
        with self._lock:
            return list(self.resource_demands) + list(self.resource_requests)

    def heartbeat_ages(self, now: Optional[float] = None
                       ) -> Dict[str, float]:
        """Seconds since each node's last heartbeat, by node_id."""
        now = now or time.time()
        with self._lock:
            return {
                m.node_id: round(now - m.last_heartbeat_time, 3)
                for m in self.nodes.values()
                if m.last_heartbeat_time > 0}

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            total: Dict[str, float] = {}
            available: Dict[str, float] = {}
            for m in self.nodes.values():
                for k, v in m.total_resources.items():
                    total[k] = total.get(k, 0) + v
                for k, v in m.available_resources.items():
                    available[k] = available.get(k, 0) + v
            return {
                "num_nodes": len(self.nodes),
                "total_resources": total,
                "available_resources": available,
                "demands": self.get_resource_demands(),
                "lost_nodes": dict(self.lost_nodes),
                "heartbeat_age_s": self.heartbeat_ages(),
            }
