"""Spark/ETL runtime: batch ETL feeding TPU training clusters.

Reference parity: runtime/spark (SURVEY.md §2.3 — Spark on YARN, memory
sizing utils.py:49-86, `cloudtik submit` routing via get_runnable_command
runtime/spark/utils.py:170, install via scripts/install.sh, and the
YARN-metrics scaling policy).  TPU-first scope: Spark runs standalone (no
YARN/HDFS dependency), master+workers spawned through the delivery layer
like every other service, installed from the release tarball, and scaled
by a policy that reads the master's /json API (the standalone-mode
equivalent of the reference's YARN pending-container signal).  Its
headline job is exporting tokenized training shards to the shared storage
TPU slice hosts stream from.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from cloudtik_tpu_torch.core.scaling_policy import (
    ScalingPolicy, ScalingState, make_autoscaling_instructions)
from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    ALL_NODES, ServiceRuntimeBase)

logger = logging.getLogger(__name__)

SPARK_MASTER_PORT = 7077
SPARK_UI_PORT = 8080


def size_executor_memory(total_memory_bytes: int,
                         reserve_fraction: float = 0.2) -> int:
    """Executor memory (MB): total minus OS reserve (reference sized from
    YARN node memory; standalone sizes from the node itself)."""
    usable = int(total_memory_bytes * (1 - reserve_fraction))
    return max(usable // (1024 * 1024), 512)


def pending_cores_from_master_json(status: Dict[str, Any]) -> int:
    """Cores the cluster is short of, from the standalone master's /json:
    running apps' unfilled cores plus fully-waiting apps' requests."""
    pending = 0
    for app in status.get("activeapps", []):
        want = int(app.get("cores", 0) or 0)
        granted = app.get("coresgranted")
        if granted is not None:
            pending += max(want - int(granted), 0)
        elif app.get("state") == "WAITING":
            pending += want
    return pending


class SparkScalingPolicy(ScalingPolicy):
    """Demand = unfilled executor cores on the standalone master
    (reference: the YARN-metrics scaling policy reading pending
    containers, runtime/spark scaling).  The fetcher is injectable for
    tests."""

    def __init__(self, config: Dict[str, Any], head_host: str,
                 ui_port: int = SPARK_UI_PORT, fetcher=None):
        super().__init__(config, head_host)
        self.ui_port = ui_port
        self._fetch = fetcher or self._http_fetch

    def name(self) -> str:
        return "spark-pending-cores"

    def _http_fetch(self) -> Dict[str, Any]:
        url = f"http://{self.head_host}:{self.ui_port}/json/"
        with urllib.request.urlopen(url, timeout=5) as resp:
            return json.loads(resp.read().decode())

    def get_scaling_state(self) -> Optional[ScalingState]:
        try:
            status = self._fetch()
        except Exception:
            return None  # master not up yet: no signal
        pending = pending_cores_from_master_json(status)
        state = ScalingState()
        demands = [{"CPU": 1.0}] * pending
        state.set_autoscaling_instructions(
            make_autoscaling_instructions(demands))
        return state


class SparkRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "spark"
    DEFAULT_PORT = SPARK_MASTER_PORT
    NODE_KIND = ALL_NODES
    PROCESS_KEYWORD = "org.apache.spark.deploy"
    BINARY = "spark-class"
    # Reference: runtime/spark/scripts/install.sh download recipe as data.
    INSTALL = {
        "type": "archive",
        "url": ("https://archive.apache.org/dist/spark/spark-3.5.1/"
                "spark-3.5.1-bin-hadoop3.tgz"),
        "strip_components": 1,
    }

    @property
    def ui_port(self) -> int:
        return int(self.runtime_config.get("ui_port", SPARK_UI_PORT))

    # -- services ----------------------------------------------------------
    def service_command(self, node_context: Dict[str, Any]):
        binary = self.find_binary()
        if binary is None:
            return None
        if node_context.get("is_head"):
            return [binary, "org.apache.spark.deploy.master.Master",
                    "--port", str(self.port),
                    "--webui-port", str(self.ui_port)]
        head_ip = node_context.get("head_ip", "localhost")
        return [binary, "org.apache.spark.deploy.worker.Worker",
                f"spark://{head_ip}:{self.port}"]

    def service_ready_port(self, node_context: Dict[str, Any]):
        # only the head's master listens on the master port
        return self.port if node_context.get("is_head") else None

    def service_env(self, node_context: Dict[str, Any]) -> Dict[str, str]:
        from cloudtik_tpu_torch.runtimes import installer
        return {"SPARK_HOME": installer.install_dir(self.SERVICE_NAME)}

    # -- jobs --------------------------------------------------------------
    def get_runnable_command(self, target, runtime_options=None):
        if not (target.endswith(".py") or target.endswith(".jar")
                or target.endswith(".scala")):
            return None
        submit = None
        binary = self.find_binary()
        if binary is not None:
            candidate = os.path.join(os.path.dirname(binary),
                                     "spark-submit")
            if os.access(candidate, os.X_OK):
                submit = candidate
        submit = submit or shutil.which("spark-submit")
        if submit is None:
            return None
        cmd = [submit, "--master",
               f"spark://localhost:{self.port}"]
        if runtime_options:
            cmd.extend(runtime_options)
        cmd.append(target)
        return cmd

    # -- discovery / observability ----------------------------------------
    def get_runtime_services(self, cluster_config, cluster_head_ip):
        return {
            "spark-master": {"protocol": "tcp", "port": self.port,
                             "node_kind": "head"},
            "spark-ui": {"protocol": "http", "port": self.ui_port,
                         "node_kind": "head"},
        }

    def get_runtime_endpoints(self, cluster_config, cluster_head_ip):
        return {"spark-ui": {
            "name": "Spark UI",
            "url": f"http://{cluster_head_ip}:{self.ui_port}"}}

    def get_head_service_ports(self):
        return {
            "spark-master": {"protocol": "TCP", "port": self.port},
            "spark-ui": {"protocol": "TCP", "port": self.ui_port},
        }

    def get_scaling_policy(self, cluster_config, head_host):
        if not self.runtime_config.get("scaling", True):
            return None
        return SparkScalingPolicy(cluster_config, head_host,
                                  ui_port=self.ui_port)

    def get_logs(self) -> Dict[str, str]:
        return {"spark": "~/.tik/logs/spark"}

    def get_processes(self) -> Optional[List[Tuple[str, bool, str, str]]]:
        return [
            ("org.apache.spark.deploy.master.Master", True, "SparkMaster",
             "head"),
            ("org.apache.spark.deploy.worker.Worker", True, "SparkWorker",
             "worker"),
        ]
