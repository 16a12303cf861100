"""Cluster-lifecycle event callbacks.

Reference parity: core/_private/event_system.py (CreateClusterEvent :8,
states :28-37, execute_callback :80).  The operator layer emits these at
each stage of `tik up`; users register callbacks via the api or config.
"""

from __future__ import annotations

import enum
import logging
import threading
from typing import Any, Callable, Dict, List, Optional, Union

logger = logging.getLogger(__name__)


class CreateClusterEvent(enum.Enum):
    """Stages of cluster creation (reference event_system.py:28-37)."""
    up_started = enum.auto()
    workspace_ready = enum.auto()
    cluster_config_validated = enum.auto()
    acquiring_new_head_node = enum.auto()
    head_node_acquired = enum.auto()
    ssh_control_acquired = enum.auto()
    run_initialization_cmd = enum.auto()
    run_setup_cmd = enum.auto()
    start_head_services = enum.auto()
    cluster_booting_completed = enum.auto()


EventCallback = Callable[[Dict[str, Any]], None]


class _EventSystem:
    """Global registry: event -> callbacks (reference kept one global)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._callbacks: Dict[CreateClusterEvent, List[EventCallback]] = {}

    def add_callback_handler(
            self,
            event: Union[CreateClusterEvent, str],
            callback: Union[EventCallback, List[EventCallback]]) -> None:
        if isinstance(event, str):
            event = CreateClusterEvent[event]
        callbacks = callback if isinstance(callback, list) else [callback]
        with self._lock:
            self._callbacks.setdefault(event, []).extend(callbacks)

    def execute_callback(
            self, event: CreateClusterEvent,
            event_data: Optional[Dict[str, Any]] = None) -> None:
        data = dict(event_data or {})
        data["event_name"] = event.name
        with self._lock:
            callbacks = list(self._callbacks.get(event, []))
        for cb in callbacks:
            try:
                cb(data)
            except Exception:
                logger.exception("event callback for %s failed",
                                 event.name)

    def clear_callbacks_for_event(
            self, event: Union[CreateClusterEvent, str]) -> None:
        if isinstance(event, str):
            event = CreateClusterEvent[event]
        with self._lock:
            self._callbacks.pop(event, None)


global_event_system = _EventSystem()
