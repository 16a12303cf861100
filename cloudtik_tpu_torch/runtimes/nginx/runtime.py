"""NGINX runtime: L7 load balancer / reverse proxy / API gateway.

Reference parity: runtime/nginx (SURVEY.md §2.3 — 1,371 LoC; modes:
web / load-balancer / api-gateway, upstreams from discovery).
"""

from __future__ import annotations

from typing import Any, Dict, List

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    HEAD, ServiceRuntimeBase)

NGINX_PORT = 80


def render_nginx_conf(upstreams: List[Dict[str, Any]],
                      listen_port: int = NGINX_PORT) -> str:
    """upstreams: [{name, path, servers: [{ip, port}]}] — one location per
    upstream, proxied under its path prefix (api-gateway shape)."""
    lines = ["worker_processes auto;", "events { worker_connections 1024; }",
             "http {"]
    for up in upstreams:
        lines.append(f"  upstream {up['name']} {{")
        for s in sorted(up["servers"], key=lambda s: (s["ip"], s["port"])):
            lines.append(f"    server {s['ip']}:{s['port']};")
        lines.append("  }")
    lines.append(f"  server {{\n    listen {listen_port};")
    for up in upstreams:
        path = up.get("path", f"/{up['name']}")
        lines += [
            f"    location {path}/ {{",
            f"      proxy_pass http://{up['name']}/;",
            "      proxy_set_header Host $host;",
            "      proxy_set_header X-Real-IP $remote_addr;",
            "    }",
        ]
    lines += ["  }", "}"]
    return "\n".join(lines) + "\n"


class NginxRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "nginx"
    BINARY = "nginx"
    CONF_FILE = "nginx.conf"
    SERVICE_ARGS = ("{binary}", "-c", "{conf}", "-g", "daemon off;")
    DEFAULT_PORT = NGINX_PORT
    PROTOCOL = "http"
    NODE_KIND = HEAD
    PROCESS_KEYWORD = "nginx"

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        if not self.runs_on(node_context):
            return
        import os
        from cloudtik_tpu_torch.runtimes.kong.runtime import (
            _discovered_http_services)
        upstreams = [
            {"name": svc["name"].replace("-", "_"),
             "path": f"/{svc['name']}",
             "servers": svc["targets"]}
            for svc in _discovered_http_services(
                node_context, self.runtime_config)]
        with open(os.path.join(self.conf_dir(node_context),
                               "nginx.conf"), "w") as f:
            f.write(render_nginx_conf(upstreams, listen_port=self.port))
