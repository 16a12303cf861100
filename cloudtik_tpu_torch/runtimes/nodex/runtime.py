"""Node exporter runtime: per-node machine metrics.

Reference parity: runtime/nodex/runtime.py:13 (prometheus node-exporter on
every node).  This build ships its own tiny Python exporter
(nodex/exporter.py, psutil → telemetry registry → telemetry HTTP server)
spawned as a real service process by the delivery layer, so no external
binary is required; the same port also exposes the process's full
telemetry registry and span ring (docs/observability.md).
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    ALL_NODES, ServiceRuntimeBase)

DEFAULT_PORT = 9100


class NodexRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "nodex"
    DEFAULT_PORT = DEFAULT_PORT
    PROTOCOL = "http"
    NODE_KIND = ALL_NODES
    PROCESS_KEYWORD = "cloudtik_tpu_torch.runtimes.nodex.exporter"
    ENDPOINT_NAME = None

    def service_command(
        self, node_context: Dict[str, Any]
    ) -> Optional[List[str]]:
        return [sys.executable, "-m", "cloudtik_tpu_torch.runtimes.nodex.exporter",
                "--port", str(self.port),
                "--interval",
                str(self.runtime_config.get("interval_s", 10.0))]
