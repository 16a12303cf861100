"""Thread-safe single-flight memoization.

Reference parity: core/_private/concurrent_cache.py:21 — the control
plane caches provider/executor constructions that many scaler and
updater threads request concurrently; without single-flight semantics a
thundering herd builds N identical SSH executors.  `ConcurrentObjectCache`
guarantees one construction per key: losers of the race block on the
winner's in-progress build instead of duplicating it.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Hashable


class ConcurrentObjectCache:
    """get(key, factory): at most one factory call per key, ever, even
    under concurrent first access.  Factory exceptions are not cached —
    the next caller retries."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._objects: Dict[Hashable, Any] = {}
        self._in_flight: Dict[Hashable, threading.Event] = {}

    def get(self, key: Hashable, factory: Callable[[], Any]) -> Any:
        while True:
            with self._lock:
                if key in self._objects:
                    return self._objects[key]
                event = self._in_flight.get(key)
                if event is None:
                    event = threading.Event()
                    self._in_flight[key] = event
                    building = True
                else:
                    building = False
            if not building:
                event.wait()
                continue        # winner finished (or failed) — re-check
            try:
                obj = factory()
            except BaseException:
                with self._lock:
                    del self._in_flight[key]
                event.set()
                raise
            with self._lock:
                self._objects[key] = obj
                del self._in_flight[key]
            event.set()
            return obj

    def invalidate(self, key: Hashable) -> None:
        with self._lock:
            self._objects.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._objects.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._objects)
