"""Load-balancer controller runtime: reconcile cloud LBs from discovery.

Reference parity: runtime/loadbalancer (SURVEY.md §2.3 — 1,281 LoC;
scripting.py:108 start_controller reconciling LoadBalancerProvider objects
from discovered services).  The controller diffs desired LBs (services
tagged for exposure) against the provider's actual list and issues
create/update/delete.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.core.load_balancer_provider import (
    LoadBalancerProvider, LoadBalancerScheme)
from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    HEAD, ServiceRuntimeBase)

logger = logging.getLogger(__name__)

EXPOSE_TAG = "lb-expose"          # services tagged lb-expose=true get an LB
SCHEME_TAG = "lb-scheme"


def desired_load_balancers(services: List[Dict[str, Any]],
                           workspace: str) -> Dict[str, Dict[str, Any]]:
    """Desired LB configs from tagged service registrations.

    Services with tag lb-expose=true are grouped by name; each group
    becomes one LB with the member (ip, port) targets.
    """
    out: Dict[str, Dict[str, Any]] = {}
    for svc in services:
        tags = svc.get("tags", {})
        if str(tags.get(EXPOSE_TAG, "")).lower() != "true":
            continue
        name = f"{workspace}-{svc['name']}"
        lb = out.setdefault(name, {
            "name": name,
            "protocol": "HTTP" if svc.get("protocol") == "http" else "TCP",
            "port": svc["port"],
            "scheme": tags.get(SCHEME_TAG, LoadBalancerScheme.INTERNAL),
            "targets": [],
        })
        target = {"ip": svc["ip"], "port": svc["port"]}
        if target not in lb["targets"]:
            lb["targets"].append(target)
    for lb in out.values():
        lb["targets"].sort(key=lambda t: (t["ip"], t["port"]))
    return out


def reconcile_load_balancers(
        provider: LoadBalancerProvider,
        desired: Dict[str, Dict[str, Any]],
        workspace: str) -> Dict[str, List[str]]:
    """One reconcile pass; returns {created, updated, deleted} names.

    Deletion is scoped to managed LBs under this workspace's name prefix —
    LBs of other workspaces/clusters sharing the provider account are
    never touched.
    """
    actual = provider.list()
    created, updated, deleted = [], [], []
    for name, config in desired.items():
        if name not in actual:
            provider.create(config)
            created.append(name)
        elif actual[name].get("targets") != config["targets"] or \
                actual[name].get("port") != config["port"]:
            provider.update(actual[name], config)
            updated.append(name)
    prefix = f"{workspace}-"
    for name, lb in actual.items():
        if name not in desired and name.startswith(prefix) \
                and lb.get("managed", True):
            provider.delete(lb)
            deleted.append(name)
    return {"created": created, "updated": updated, "deleted": deleted}


class LoadBalancerController:
    """Background reconcile loop (reference scripting.py start_controller)."""

    def __init__(self, provider: LoadBalancerProvider, registry,
                 workspace: str, interval_s: float = 15.0):
        self.provider = provider
        self.registry = registry
        self.workspace = workspace
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def run_once(self) -> Dict[str, List[str]]:
        desired = desired_load_balancers(
            self.registry.query(), self.workspace)
        return reconcile_load_balancers(self.provider, desired,
                                        self.workspace)

    def start(self) -> None:
        def _loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.run_once()
                except Exception:
                    logger.exception("LB reconcile failed")

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="tik-lb-controller")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)


class LoadBalancerRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "loadbalancer"
    DEFAULT_PORT = 0
    NODE_KIND = HEAD
    PROCESS_KEYWORD = "cloudtik_tpu_torch.runtimes.loadbalancer.sync"

    def get_runtime_services(self, cluster_config, cluster_head_ip):
        return None  # controller only; exposes nothing itself

    def get_head_service_ports(self):
        return None

    def get_health_check(self, cluster_config):
        return None

    def node_services(self, node_context: Dict[str, Any],
                      command: str) -> None:
        """Spawn/stop the LB reconcile daemon on the head (reference:
        scripting.py:108 start_controller)."""
        import json
        import sys

        from cloudtik_tpu_torch.runtimes.common import process_runner
        from cloudtik_tpu_torch.utils.constants import TIK_STATE_PORT_DEFAULT

        if not node_context.get("is_head"):
            return
        name = "lb-controller"
        if command == "stop":
            process_runner.stop_service(name)
            return
        if command != "start":
            raise ValueError(f"unknown services command {command!r}")
        config = node_context.get("config", {})
        cmd = [sys.executable, "-m",
               "cloudtik_tpu_torch.runtimes.loadbalancer.sync",
               "--head-ip", node_context.get("head_ip", "127.0.0.1"),
               "--state-port",
               str(config.get("state_port", TIK_STATE_PORT_DEFAULT)),
               "--cluster", config.get("cluster_name", ""),
               "--workspace", config.get("workspace_name", ""),
               "--interval",
               str(self.runtime_config.get("reconcile_interval_s", 15.0)),
               "--provider-config",
               json.dumps(config.get("provider", {}))]
        process_runner.spawn_service(name, cmd)
