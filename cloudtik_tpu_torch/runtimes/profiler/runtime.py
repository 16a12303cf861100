"""Profiler runtime: serve the port's profile captures from the head node.

Counterpart of `cloudtik_tpu/runtimes/profiler/runtime.py`, with its
profile root and ports.  The port's captures (`telemetry/stepprof.py`
`ProfileCapture`, `Trainer.fit(profile_dir=...)`) are `torch.profiler`
Chrome-trace JSON files, `<output_dir>/trace.json`, which Perfetto or
chrome://tracing open.  XProf reads JAX's xplane captures, and TensorBoard
without the PyTorch profiler plugin reads none of these files, so this
runtime serves the profile root as static files with the standard
library's HTTP server: `tik tunnel cluster.yaml --service profiler`, then
`http://localhost:6006/<run>/trace.json` opens in a trace viewer.

runtime_config:
  profiler:
    profile_dir: ~/.tik/profiles   # where trainers drop traces
    port: 6006
"""

from __future__ import annotations

import os
import sys
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    HEAD, ServiceRuntimeBase)

PROFILER_PORT = 6006
# The cluster-wide convention: Trainer captures and this runtime serves
# the same root.
DEFAULT_PROFILE_DIR = "~/.tik/profiles"
SERVER_MODULE = "http.server"


def profile_root(runtime_config: Optional[Dict[str, Any]] = None) -> str:
    cfg = runtime_config or {}
    return os.path.expanduser(
        cfg.get("profile_dir", DEFAULT_PROFILE_DIR))


class ProfilerRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "profiler"
    DEFAULT_PORT = PROFILER_PORT
    PROTOCOL = "http"
    NODE_KIND = HEAD
    PROCESS_KEYWORD = SERVER_MODULE
    ENDPOINT_NAME = "Profiler (Chrome-trace JSON)"

    def service_command(self, node_context: Dict[str, Any]
                        ) -> Optional[List[str]]:
        logdir = profile_root(self.runtime_config)
        os.makedirs(logdir, exist_ok=True)
        return [sys.executable, "-m", SERVER_MODULE,
                "--directory", logdir,
                "--bind", "0.0.0.0", str(self.port)]
