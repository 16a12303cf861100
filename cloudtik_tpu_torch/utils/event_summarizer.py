"""Aggregating event summarizer for the reconciliation loop.

Reference parity: core/_private/event_summarizer.py:73 — the scaler emits
the same message shape many times per tick ("Adding 1 node of type X");
the summarizer folds them into counted one-liners ("Adding 5 nodes of
type X") drained once per loop so cluster events stay readable at pod
scale.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List


class EventSummarizer:
    """add() folds quantities into a keyed template; drain() emits the
    rendered lines and resets."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._once: List[str] = []
        self._seen_once: set = set()

    def add(self, template: str, *, quantity: int = 1,
            aggregate: Callable[[int, int], int] = lambda a, b: a + b
            ) -> None:
        """template contains `{}` for the aggregated quantity, e.g.
        "Adding {} node(s) of type tpu-v5p." """
        with self._lock:
            if template in self._counts:
                self._counts[template] = aggregate(
                    self._counts[template], quantity)
            else:
                self._counts[template] = quantity

    def add_once_per_interval(self, message: str, key: str) -> None:
        """Emit `message` at most once per drain interval (dedup by key:
        e.g. one per failing node id)."""
        with self._lock:
            if key not in self._seen_once:
                self._seen_once.add(key)
                self._once.append(message)

    def summary(self) -> List[str]:
        with self._lock:
            lines = [t.format(q) for t, q in self._counts.items()]
            return lines + list(self._once)

    def drain(self) -> List[str]:
        with self._lock:
            lines = [t.format(q) for t, q in self._counts.items()]
            lines += self._once
            self._counts.clear()
            self._once.clear()
            self._seen_once.clear()
            return lines
