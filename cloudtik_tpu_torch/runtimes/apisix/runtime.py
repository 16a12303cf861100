"""APISIX runtime: API gateway (standalone declarative mode).

Reference parity: runtime/apisix (SURVEY.md §2.3 — 1,220 LoC).  Renders
apisix.yaml in standalone mode: routes + upstream node maps from the
cluster service registry.  Standalone APISIX HOT-RELOADS that file on
mtime change, so live reconfiguration is simply re-rendering it — a sync
loop re-renders whenever the discovered service set changes (the
standalone-mode counterpart of kong's admin-API sync), and scale-ups /
failovers reroute without touching the gateway process.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    HEAD, LoopDaemon, ServiceRuntimeBase)
from cloudtik_tpu_torch.runtimes.kong.runtime import _discovered_http_services

logger = logging.getLogger(__name__)

APISIX_PORT = 9080


def render_apisix_yaml(services: List[Dict[str, Any]]) -> str:
    """services: [{name, targets: [{ip, port}]}] -> apisix.yaml text
    (standalone mode requires the trailing #END marker)."""
    import yaml
    routes = []
    for svc in services:
        nodes = {f"{t['ip']}:{t['port']}": 1
                 for t in sorted(svc["targets"],
                                 key=lambda t: (t["ip"], t["port"]))}
        routes.append({
            "uri": f"/{svc['name']}/*",
            "name": svc["name"],
            "upstream": {"type": "roundrobin", "nodes": nodes},
        })
    return yaml.safe_dump({"routes": routes},
                          sort_keys=False) + "#END\n"


class APISIXRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "apisix"
    BINARY = "apisix"
    CONF_FILE = "apisix.yaml"
    DEFAULT_PORT = APISIX_PORT
    PROTOCOL = "http"
    NODE_KIND = HEAD
    PROCESS_KEYWORD = "apisix"
    EXTERNAL_SERVICE = True   # apisix start daemonizes via its packaging
    ENDPOINT_NAME = "APISIX Gateway"

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        if not self.runs_on(node_context):
            return
        self.render_once(node_context)

    def render_once(self, node_context: Dict[str, Any]) -> bool:
        """Re-render apisix.yaml from discovery; returns True when the
        content changed (standalone APISIX hot-reloads on mtime, so an
        unchanged render is deliberately NOT rewritten)."""
        import os
        services = _discovered_http_services(
            node_context, self.runtime_config)
        rendered = render_apisix_yaml(services)
        path = os.path.join(self.conf_dir(node_context), "apisix.yaml")
        try:
            with open(path) as f:
                if f.read() == rendered:
                    return False
        except OSError:
            pass
        with open(path, "w") as f:
            f.write(rendered)
        return True

    def post_start(self, node_context: Dict[str, Any]) -> None:
        if not self.runtime_config.get("sync", True):
            return
        if node_context.get("state_client") is None:
            return
        if self.has_daemons(node_context):
            return
        daemon = LoopDaemon(
            "tik-apisix-sync", lambda: self.render_once(node_context),
            float(self.runtime_config.get("sync_poll_s", 10.0)))
        daemon.start()
        self.register_daemon(node_context, daemon)
