"""MLflow runtime: experiment tracking server on the head.

Reference parity: the AI runtime's MLflow 2.3.1 server
(runtime/ai/scripts/install.sh:48-54, SURVEY.md §5 checkpoint/resume — the
reference delegated run tracking to MLflow).  Gated: starts only when the
mlflow package is installed; the trainer's tracking client writes through
cloudtik_tpu_torch.train.tracking either way.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

from cloudtik_tpu_torch.core.runtime import Runtime

DEFAULT_PORT = 5000


class MLflowRuntime(Runtime):
    def get_runtime_services(self, cluster_config, cluster_head_ip):
        return {"mlflow": {
            "protocol": "http",
            "port": self.runtime_config.get("port", DEFAULT_PORT),
            "node_kind": "head"}}

    def get_runtime_endpoints(self, cluster_config, cluster_head_ip):
        port = self.runtime_config.get("port", DEFAULT_PORT)
        return {"mlflow": {"name": "MLflow",
                           "url": f"http://{cluster_head_ip}:{port}"}}

    def get_head_service_ports(self):
        return {"mlflow": {
            "protocol": "TCP",
            "port": self.runtime_config.get("port", DEFAULT_PORT)}}

    def node_install(self, node_context: Dict[str, Any]) -> None:
        """pip-install mlflow when absent (reference: ai install.sh:48-54
        pinning the MLflow server)."""
        if not node_context.get("is_head") or shutil.which("mlflow"):
            return
        from cloudtik_tpu_torch.runtimes import installer
        spec = self.runtime_config.get("install") or {
            "type": "pip", "packages": ["mlflow"]}
        installer.install("mlflow", spec)

    def node_services(self, node_context: Dict[str, Any], command: str) -> None:
        from cloudtik_tpu_torch.runtimes.common import process_runner

        if not node_context.get("is_head"):
            return
        if command == "stop":
            process_runner.stop_service("mlflow")
            return
        if command != "start" or not shutil.which("mlflow"):
            return
        backend_dir = os.path.expanduser("~/.tik/mlflow")
        os.makedirs(backend_dir, exist_ok=True)
        port = self.runtime_config.get("port", DEFAULT_PORT)
        process_runner.spawn_service("mlflow", [
            "mlflow", "server",
            "--host", "0.0.0.0",
            "--port", str(port),
            "--backend-store-uri",
            self.backend_store_uri(node_context, backend_dir),
            "--default-artifact-root",
            self.artifact_root(backend_dir),
        ])
        process_runner.wait_for_port("mlflow", int(port), timeout_s=60)

    def backend_store_uri(self, node_context: Dict[str, Any],
                          backend_dir: str) -> str:
        """Discovered postgres (HA run store, the reference's production
        shape) when the cluster runs one; sqlite fallback otherwise."""
        explicit = self.runtime_config.get("backend_store_uri")
        if explicit:
            return explicit
        state = node_context.get("state_client")
        if state is not None:
            try:
                from cloudtik_tpu_torch.runtimes.discovery.runtime import (
                    ServiceRegistry)
                config = node_context.get("config", {})
                registry = ServiceRegistry(
                    state, config.get("cluster_name", ""),
                    config.get("workspace_name", ""))
                pg = [s for s in registry.query("postgres")
                      if s.get("tags", {}).get("role") == "primary"] \
                    or registry.query("postgres")
                if pg:
                    return (f"postgresql://tik@{pg[0]['ip']}:"
                            f"{pg[0]['port']}/mlflow")
            except Exception:
                pass
        return f"sqlite:///{backend_dir}/mlflow.db"

    def artifact_root(self, backend_dir: str) -> str:
        """Managed cloud storage (mount runtime / workload identity env)
        when present, local disk otherwise."""
        return (self.runtime_config.get("artifact_root")
                or os.environ.get("TIK_CLOUD_STORAGE_URI")
                or f"{backend_dir}/artifacts")

    def get_processes(self) -> Optional[List[Tuple[str, bool, str, str]]]:
        return [("mlflow", True, "MLflow", "head")]
