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
    telemetry_port: 9104       # the port's /metrics, /trace (0: off)

The port's engine records its `tik_serve_*` metrics, spans and events in
the port's own telemetry registry and flight recorder, which the
reference's node-services process (the one that starts this runtime)
neither serves nor installs.  So `start` also serves the port's registry
on `telemetry_port` (`telemetry/http.py`), declared and registered as the
http service `serving-telemetry`, which the prometheus runtimes and the
discovery sync render as a scrape target; and it installs the port's
flight recorder at `journal_path()`, beside the reference's journal and
never on it.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional, Tuple

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    HEAD, ServiceRuntimeBase)

logger = logging.getLogger(__name__)

SERVE_PORT = 8200
# beside the reference's head telemetry (9103) and node exporter (9100)
TELEMETRY_PORT = 9104
TELEMETRY_SERVICE = "serving-telemetry"

# live servers must outlive runtime instances (delivery re-creates them
# per start/stop invocation); keyed by ServiceRuntimeBase.instance_key
_servers: Dict[Tuple[str, str], Any] = {}
# (telemetry server or None, the journal this runtime installed or None)
_telemetry: Dict[Tuple[str, str], Tuple[Any, Any]] = {}


def journal_path(runtime_config: Optional[Dict[str, Any]] = None) -> str:
    """Where the serving process journals the port's events: the runtime
    config's `events_path`, else the flight recorder's default path with
    `-torch` before its suffix (`~/.tik/logs/events-torch.jsonl`).  The
    reference's node-services process journals to the default path
    itself, so the two journals never append to one file; the log agent
    ships both (`*.jsonl` under the log dirs), and `tik events dump --path
    <it>` reads this one."""
    explicit = (runtime_config or {}).get("events_path")
    if explicit:
        return os.path.expanduser(explicit)
    from cloudtik_tpu_torch.telemetry import events
    root, ext = os.path.splitext(events.default_path())
    return f"{root}-torch{ext or '.jsonl'}"


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
            self._start_telemetry(node_context, key)
        elif command == "stop":
            self._stop_telemetry(node_context, key)
            server = _servers.pop(key, None)
            if server is not None:
                server.stop()
                for backend in getattr(server, "backends", []):
                    engine = getattr(backend, "engine", None)
                    if engine is not None:
                        engine.stop()
            self._deregister(node_context)

    @property
    def telemetry_port(self) -> int:
        return int(self.runtime_config.get("telemetry_port",
                                            TELEMETRY_PORT))

    def _serves_telemetry(self) -> bool:
        from cloudtik_tpu_torch import telemetry
        return bool(self.telemetry_port) and telemetry.enabled()

    def _telemetry_registry(self, node_context: Dict[str, Any]):
        state_client = node_context.get("state_client")
        if state_client is None:
            return None
        from cloudtik_tpu_torch.runtimes.discovery.runtime import (
            ServiceRegistry)
        config = node_context.get("config", {})
        return ServiceRegistry(state_client,
                               config.get("cluster_name", ""),
                               config.get("workspace_name", ""))

    def _start_telemetry(self, node_context: Dict[str, Any],
                         key: Tuple[str, str]) -> None:
        """Serve the port's registry and install the port's journal in
        this process (module docstring).  A taken port degrades with a
        warning, as the reference's head telemetry does, and an unwritable
        journal warns once (the flight recorder's own guard): neither
        blocks the model server."""
        if not self._serves_telemetry():
            return
        from cloudtik_tpu_torch.telemetry import events
        from cloudtik_tpu_torch.telemetry import http as telemetry_http
        journal = None
        if events.installed() is None:
            journal = events.install(journal_path(self.runtime_config))
        server = None
        try:
            server = telemetry_http.start_server(self.telemetry_port)
        except OSError as e:
            logger.warning("serving: telemetry server not started on %s: %s",
                           self.telemetry_port, e)
        _telemetry[key] = (server, journal)
        registry = self._telemetry_registry(node_context)
        if server is not None and registry is not None:
            registry.register(
                TELEMETRY_SERVICE, node_context.get("node_id", ""),
                node_context.get("node_ip") or node_context.get(
                    "head_ip", ""), server.port, protocol="http")

    def _stop_telemetry(self, node_context: Dict[str, Any],
                        key: Tuple[str, str]) -> None:
        server, journal = _telemetry.pop(key, (None, None))
        if server is not None:
            server.stop()
        if journal is not None:
            from cloudtik_tpu_torch.telemetry import events
            if events.installed() is journal:
                events.uninstall()
        registry = self._telemetry_registry(node_context)
        if registry is not None:
            try:
                registry.deregister(TELEMETRY_SERVICE,
                                    node_context.get("node_id", ""))
            except Exception:
                pass

    def get_runtime_services(self, cluster_config, cluster_head_ip):
        services = {
            "serving": {"protocol": "http", "port": self.port,
                        "node_kind": "head",
                        "tags": {"lb-expose": "true"}},
        }
        if self._serves_telemetry():
            services[TELEMETRY_SERVICE] = {
                "protocol": "http", "port": self.telemetry_port,
                "node_kind": "head"}
        return services
