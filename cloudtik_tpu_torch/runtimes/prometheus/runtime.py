"""Prometheus runtime: metrics server on head, targets from discovery.

Reference parity: runtime/prometheus (SURVEY.md §2.3 — file-SD target
generation runtime/prometheus/discovery.py:62; binary installed by
scripts/install.sh).  This build renders the scrape config from the
cluster's service registrations and runs either the real prometheus binary
(when installed) or the built-in Python collector (collector.py) speaking
the same HTTP surface — so metrics collection genuinely works on
zero-egress TPU images.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Optional

import yaml

from cloudtik_tpu_torch.runtimes.common.runtime_base import HEAD, ServiceRuntimeBase

DEFAULT_PORT = 9090


class PrometheusRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "prometheus"
    DEFAULT_PORT = DEFAULT_PORT
    PROTOCOL = "http"
    NODE_KIND = HEAD
    PROCESS_KEYWORD = "prometheus"
    ENDPOINT_NAME = "Prometheus"
    BINARY = "prometheus"

    def node_install(self, node_context: Dict[str, Any]) -> None:
        """Binary optional: the built-in collector is always available."""
        return None

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        """Write prometheus.yml + file-SD targets from the cluster's
        declared runtime services."""
        if not self.runs_on(node_context):
            return
        conf_dir = self.conf_dir(node_context)
        targets_file = os.path.join(conf_dir, "targets.json")
        config = node_context.get("config", {})
        head_ip = node_context.get("head_ip", "127.0.0.1")
        services = _declared_http_services(config, head_ip)
        # head services serve the in-process telemetry registry
        # (spans + metrics, docs/observability.md) on its own port —
        # scrape it alongside the declared runtime services
        from cloudtik_tpu_torch import telemetry
        from cloudtik_tpu_torch.utils.constants import (
            TIK_TELEMETRY_PORT_DEFAULT)
        # same resolution head services use to BIND the port
        # (cluster-level telemetry_port), overridable per runtime config
        telemetry_port = self.runtime_config.get(
            "telemetry_port",
            config.get("telemetry_port", TIK_TELEMETRY_PORT_DEFAULT))
        if self.runtime_config.get("scrape_telemetry", True) \
                and telemetry_port and telemetry.enabled():
            # only when the head will actually bind the endpoint —
            # TIK_TELEMETRY=off / port 0 must not render a dead target
            services.setdefault("telemetry", {
                "port": telemetry_port,
                "protocol": "http",
                "cluster": config.get("cluster_name", ""),
                "nodes": [{"node_id": "head", "ip": head_ip}],
            })
        if services or not os.path.exists(targets_file):
            write_targets_file(conf_dir, services)
        from cloudtik_tpu_torch.runtimes.prometheus.alerts import write_rules
        rules_file = write_rules(
            conf_dir, **self.runtime_config.get("alert_thresholds", {}))
        prom_config = {
            "global": {"scrape_interval": "15s"},
            "rule_files": [rules_file],
            "scrape_configs": [{
                "job_name": "tik",
                "file_sd_configs": [{"files": [targets_file]}],
            }],
        }
        with open(os.path.join(conf_dir, "prometheus.yml"), "w") as f:
            yaml.safe_dump(prom_config, f)

    def service_command(
        self, node_context: Dict[str, Any]
    ) -> Optional[List[str]]:
        conf_dir = self.conf_dir(node_context)
        binary = self.find_binary()
        if binary:
            return [
                binary,
                f"--config.file={os.path.join(conf_dir, 'prometheus.yml')}",
                f"--web.listen-address=:{self.port}",
                f"--storage.tsdb.path={os.path.join(conf_dir, 'data')}"]
        return [sys.executable, "-m",
                "cloudtik_tpu_torch.runtimes.prometheus.collector",
                "--port", str(self.port), "--conf-dir", conf_dir,
                "--scrape-interval",
                str(self.runtime_config.get("scrape_interval_s", 5.0))]


def _declared_http_services(config: Dict[str, Any],
                            head_ip: str) -> Dict[str, Dict[str, Any]]:
    """Scrapeable (http) services the cluster config declares."""
    from cloudtik_tpu_torch.runtimes.registry import iter_runtimes

    out: Dict[str, Dict[str, Any]] = {}
    for runtime in iter_runtimes(config):
        services = runtime.get_runtime_services(config, head_ip) or {}
        for name, svc in services.items():
            if svc.get("protocol") != "http":
                continue
            out[name] = {
                "port": svc["port"],
                "protocol": svc["protocol"],
                "cluster": config.get("cluster_name", ""),
                "nodes": [{"node_id": "head", "ip": head_ip}],
            }
    return out


def write_targets_file(conf_dir: str,
                       services: Dict[str, Dict[str, Any]]) -> str:
    """Render discovered services into prometheus file-SD format."""
    targets = []
    for name, svc in sorted(services.items()):
        for node in svc.get("nodes", []):
            targets.append({
                "targets": [f"{node['ip']}:{svc['port']}"],
                "labels": {"job": name, "cluster": svc.get("cluster", "")},
            })
    os.makedirs(os.path.expanduser(conf_dir), exist_ok=True)
    path = os.path.join(os.path.expanduser(conf_dir), "targets.json")
    with open(path, "w") as f:
        json.dump(targets, f, indent=1)
    return path
