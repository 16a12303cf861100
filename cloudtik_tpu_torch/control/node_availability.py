"""Node-availability tracking: categorized launch-failure history.

Reference parity: core/_private/node_availability_tracker.py:62 — launch
failures (quota, stockout, auth, api) are recorded per node type with
timestamps so the CLI/status surface can explain *why* the cluster isn't
reaching its target size, and the demand scheduler can deprioritize
unavailable types.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.core.node_provider import NodeLaunchException


class NodeAvailabilityRecord:
    def __init__(self, node_type: str, category: str, description: str,
                 timestamp: float):
        self.node_type = node_type
        self.category = category
        self.description = description
        self.timestamp = timestamp
        self.count = 1

    def to_dict(self) -> Dict[str, Any]:
        return {
            "node_type": self.node_type,
            "category": self.category,
            "description": self.description,
            "last_failure_time": self.timestamp,
            "count": self.count,
        }


class NodeAvailabilityTracker:
    """Sliding record of launch failures per node type."""

    def __init__(self, ttl_s: float = 30 * 60.0):
        self.ttl_s = ttl_s
        self._lock = threading.Lock()
        self._records: Dict[str, NodeAvailabilityRecord] = {}

    def record_failure(self, node_type: str,
                       exc: NodeLaunchException) -> None:
        now = time.time()
        with self._lock:
            rec = self._records.get(node_type)
            if rec is not None and rec.category == exc.category:
                rec.count += 1
                rec.timestamp = now
                rec.description = exc.description
            else:
                self._records[node_type] = NodeAvailabilityRecord(
                    node_type, exc.category, exc.description, now)

    def record_success(self, node_type: str) -> None:
        with self._lock:
            self._records.pop(node_type, None)

    def _prune(self, now: float) -> None:
        stale = [t for t, r in self._records.items()
                 if now - r.timestamp > self.ttl_s]
        for t in stale:
            del self._records[t]

    def is_unavailable(self, node_type: str,
                       within_s: float = 120.0) -> bool:
        """True when the type failed recently (demand scheduler uses this
        to try other types first)."""
        now = time.time()
        with self._lock:
            self._prune(now)
            rec = self._records.get(node_type)
            return rec is not None and now - rec.timestamp < within_s

    def summary(self) -> List[Dict[str, Any]]:
        now = time.time()
        with self._lock:
            self._prune(now)
            return [r.to_dict() for r in
                    sorted(self._records.values(),
                           key=lambda r: -r.timestamp)]
