"""Serving runtime: the port's tik-serve model servers as a service.

Counterpart of `cloudtik_tpu/runtimes/serving/runtime.py`.  Runs the
port's in-process `serve.server.ServeServer` on its nodes, registered in
discovery (through the port's copies of the service registry, which write
what the reference's registry reads) so gateways route to it like any
runtime service.  A cluster config names it by module and class under
`runtime.types` (`cloudtik_tpu_torch.runtimes.serving.runtime:
ServingRuntime`), with its options under the same key:

runtime_config:
    model: tiny                # transformer preset
    checkpoint_dir: ...        # optional
    engine: true               # continuous batching (slots, max_len)
    gbdt_model: /path.npz      # serve a GBDT instead
    device: cuda               # torch device (default: the card)
    port: 8200
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    HEAD, ServiceRuntimeBase)

SERVE_PORT = 8200

# live servers must outlive runtime instances (delivery re-creates them
# per start/stop invocation); keyed by ServiceRuntimeBase.instance_key
_servers: Dict[Tuple[str, str], Any] = {}


class ServingRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "serving"
    DEFAULT_PORT = SERVE_PORT
    PROTOCOL = "http"
    NODE_KIND = HEAD
    PROCESS_KEYWORD = "tik-serve"
    ENDPOINT_NAME = "Model Serving"

    def _build_backends(self):
        from cloudtik_tpu_torch.serve import server as S
        device = self.runtime_config.get("device")
        gbdt_path = self.runtime_config.get("gbdt_model")
        if gbdt_path:
            return [S.gbdt_backend(gbdt_path, device=device)]
        if self.runtime_config.get("engine"):
            return [S.engine_backend(
                self.runtime_config.get("model", "tiny"),
                checkpoint_dir=self.runtime_config.get("checkpoint_dir"),
                slots=int(self.runtime_config.get("slots", 4)),
                max_len=int(self.runtime_config.get("max_len", 512)),
                device=device)]
        return [S.transformer_backend(
            self.runtime_config.get("model", "tiny"),
            checkpoint_dir=self.runtime_config.get("checkpoint_dir"),
            device=device)]

    def node_services(self, node_context: Dict[str, Any],
                      command: str) -> None:
        if not self.runs_on(node_context):
            return
        from cloudtik_tpu_torch.serve.server import ServeServer
        key = self.instance_key(node_context)
        if command == "start" and key not in _servers:
            server = ServeServer(self._build_backends(), port=self.port)
            server.start()
            _servers[key] = server
            # Registration temporarily adopts the BOUND port (the config
            # may say 0 for an ephemeral bind) so discovery advertises
            # reality, then restores the configured value.
            cfg_port = self.port
            self.runtime_config["port"] = server.port
            try:
                self._register(node_context)
            finally:
                self.runtime_config["port"] = cfg_port
        elif command == "stop":
            server = _servers.pop(key, None)
            if server is not None:
                server.stop()
                for backend in getattr(server, "backends", []):
                    engine = getattr(backend, "engine", None)
                    if engine is not None:
                        engine.stop()
            self._deregister(node_context)

    def get_runtime_services(self, cluster_config, cluster_head_ip):
        return {
            "serving": {"protocol": "http", "port": self.port,
                        "node_kind": "head",
                        "tags": {"lb-expose": "true"}},
        }
