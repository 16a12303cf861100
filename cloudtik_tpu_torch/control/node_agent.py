"""Node agent: per-node heartbeat + process + metrics publisher.

Reference parity: core/_private/service/cloudtik_node_agent.py
(NodeMonitor:32, _heartbeat:161 at 1s, _update_processes:194 psutil scan vs
Runtime.get_processes, _update_metrics:240).  Publishes into the head state
server tables instead of Redis.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import psutil

from cloudtik_tpu_torch import telemetry
from cloudtik_tpu_torch.control.state import (
    StateClient, TABLE_HEARTBEAT, TABLE_METRICS, TABLE_PROCESSES)
from cloudtik_tpu_torch.faults import seams
from cloudtik_tpu_torch.faults.plan import DIRECTIVE_DROP
from cloudtik_tpu_torch.telemetry import instruments as ti
from cloudtik_tpu_torch.utils.constants import TIK_HEARTBEAT_PERIOD_S

logger = logging.getLogger(__name__)


def collect_node_metrics() -> Dict[str, Any]:
    vm = psutil.virtual_memory()
    disk = psutil.disk_usage("/")
    load = psutil.getloadavg()
    return {
        "time": time.time(),
        "cpu_percent": psutil.cpu_percent(interval=None),
        "cpu_count": psutil.cpu_count(),
        "load_avg": list(load),
        "memory_percent": vm.percent,
        "memory_total": vm.total,
        "memory_available": vm.available,
        "disk_percent": disk.percent,
        "disk_total": disk.total,
        "disk_free": disk.free,
    }


def scan_processes(
    process_specs: List[Tuple[str, bool, str, str]]
) -> Dict[str, Dict[str, Any]]:
    """Match running processes against runtime specs
    (keyword, match_cmdline, friendly_name, node_kind)."""
    found: Dict[str, Dict[str, Any]] = {}
    for proc in psutil.process_iter(["pid", "name", "cmdline", "status"]):
        try:
            info = proc.info
            cmdline = " ".join(info.get("cmdline") or [])
            for keyword, match_cmdline, friendly, _kind in process_specs:
                haystack = cmdline if match_cmdline else (info["name"] or "")
                if keyword in haystack:
                    found[friendly] = {
                        "pid": info["pid"],
                        "status": info["status"],
                    }
        except (psutil.NoSuchProcess, psutil.AccessDenied):
            continue
    return found


class NodeAgent:
    """Runs on every node; heartbeats + metrics into the state store."""

    def __init__(
        self,
        state_client: StateClient,
        node_id: str,
        node_ip: Optional[str] = None,
        process_specs: Optional[List[Tuple[str, bool, str, str]]] = None,
        heartbeat_period_s: float = TIK_HEARTBEAT_PERIOD_S,
        metrics_period_s: float = 5.0,
        total_resources: Optional[Dict[str, float]] = None,
        slice_id: Optional[int] = None,
    ):
        self.state = state_client
        self.node_id = node_id
        self.node_ip = node_ip or _local_ip()
        # which pod slice this host belongs to, as the DENSE index the
        # elastic trainer meshes over (TIK_SLICE_INDEX exported by the
        # launcher; explicit arg wins — NOT TIK_SLICE_ID, which is the
        # provider's group-id string).  Stamped on every heartbeat so
        # SliceMembership (control/membership.py) can judge slice
        # liveness off the same state path.
        if slice_id is None:
            env = os.environ.get("TIK_SLICE_INDEX")
            if env is not None:
                try:
                    slice_id = int(env)
                except ValueError:
                    logger.warning(
                        "ignoring malformed TIK_SLICE_INDEX=%r", env)
        self.slice_id = slice_id
        self.process_specs = process_specs or []
        self.heartbeat_period_s = heartbeat_period_s
        self.metrics_period_s = metrics_period_s
        if total_resources is None:
            from cloudtik_tpu_torch.utils.resource_spec import (
                detect_node_resources)
            total_resources = detect_node_resources()
        self.total_resources = total_resources
        # the updater's start command exported TIK_TRACEPARENT when the
        # head launched this node: adopt it so this process's spans join
        # the boot trace (no-op when the env var is absent/invalid)
        telemetry.adopt_traceparent_from_env()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # TIK_NATIVE_AGENT=1: /proc-reading C++ sampler (SURVEY §2.4 —
        # psutil's per-sample cost matters on busy training hosts);
        # psutil remains the fallback when the build/start fails
        self._native_sampler = None
        if os.environ.get("TIK_NATIVE_AGENT") == "1":
            try:
                from cloudtik_tpu_torch.native import NativeHostSampler
                sampler = NativeHostSampler(
                    interval_ms=int(metrics_period_s * 1000))
                sampler.start()
                self._native_sampler = sampler
            except Exception:
                logger.warning(
                    "native host agent unavailable; using psutil",
                    exc_info=True)

    def heartbeat_once(self) -> None:
        # drop-heartbeats-for(ip, duration) drill point: a dropped beat
        # is simply never published — exactly what a wedged host looks
        # like from the head's side
        if seams.fire("node_agent.heartbeat", ip=self.node_ip,
                      node_id=self.node_id) == DIRECTIVE_DROP:
            return
        record = {
            "node_id": self.node_id,
            "node_ip": self.node_ip,
            "time": time.time(),
        }
        if self.slice_id is not None:
            record["slice_id"] = self.slice_id
        self.state.table_put(TABLE_HEARTBEAT, self.node_id, record)
        ti.HEARTBEATS_PUBLISHED.inc()

    def publish_metrics_once(self) -> None:
        native = (self._native_sampler.latest()
                  if self._native_sampler else None)
        metrics = dict(native) if native else collect_node_metrics()
        metrics["node_id"] = self.node_id
        metrics["node_ip"] = self.node_ip
        cpu_free = self.total_resources.get("CPU", 0) * \
            (1.0 - metrics["cpu_percent"] / 100.0)
        metrics["total_resources"] = self.total_resources
        metrics["available_resources"] = {
            "CPU": round(cpu_free, 2),
            "memory": float(metrics["memory_available"]),
        }
        self.state.table_put(TABLE_METRICS, self.node_id, metrics)
        if self.process_specs:
            self.state.table_put(
                TABLE_PROCESSES, self.node_id,
                {"time": time.time(),
                 "processes": scan_processes(self.process_specs)})

    def run_forever(self) -> None:
        last_metrics = 0.0
        while not self._stop.is_set():
            try:
                self.heartbeat_once()
                now = time.time()
                if now - last_metrics >= self.metrics_period_s:
                    self.publish_metrics_once()
                    last_metrics = now
            except Exception:
                logger.exception("node agent publish failed")
            self._stop.wait(self.heartbeat_period_s)

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.run_forever, name="tik-node-agent", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._native_sampler is not None:
            self._native_sampler.stop()
            self._native_sampler = None


def _local_ip() -> str:
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect(("8.8.8.8", 80))
        ip = s.getsockname()[0]
        s.close()
        return ip
    except OSError:
        return "127.0.0.1"
