"""Node services: boot/stop the head & worker daemons.

Reference parity: core/_private/node/node_services.py
(NodeServicesStarter:41, start_head_processes:616 reaper→redis→controller,
start_node_processes:631) + core/_private/services.py (process spawn/track).

Head boots: state server (replaces Redis) → controller (scaler loop) →
node agent → log agent.  Workers boot: node agent → log agent.  All daemons
run as threads of one `tik node start` process (simpler than the
reference's process zoo; the process reaper's fate-sharing is inherited
from the single-process design).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from typing import Any, Dict, List, Optional

import yaml

from cloudtik_tpu_torch.control.controller import ClusterController
from cloudtik_tpu_torch.control.log_agent import LogAgent
from cloudtik_tpu_torch.control.node_agent import NodeAgent
from cloudtik_tpu_torch.control.state import (
    FileStateBackend, StateClient, StateServer, TcpStateBackend)
from cloudtik_tpu_torch.providers.factory import create_node_provider
from cloudtik_tpu_torch.runtimes.registry import iter_runtimes
from cloudtik_tpu_torch.utils.constants import (
    TIK_LOGS_DIR, TIK_RUN_DIR, TIK_STATE_PORT_DEFAULT)

logger = logging.getLogger(__name__)


def _bootstrap_config_path() -> str:
    from cloudtik_tpu_torch.utils.constants import tik_home
    return os.path.join(tik_home(), "bootstrap-config.yaml")


def write_bootstrap_config(config: Dict[str, Any],
                           path: Optional[str] = None) -> str:
    path = path or _bootstrap_config_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def node_services_pid_file(cluster_name: Optional[str] = None) -> str:
    """Pidfile for the daemonized node-services process, scoped per
    cluster so hard teardown of one cluster can never reap another
    cluster's daemon sharing this machine (advisor round-4 medium)."""
    name = (f"node-services-{cluster_name}.pid" if cluster_name
            else "node-services.pid")
    return os.path.join(os.path.expanduser(TIK_RUN_DIR), name)


def load_bootstrap_config(path: Optional[str] = None) -> Dict[str, Any]:
    if path is None:
        path = _bootstrap_config_path()
        if not os.path.exists(path):
            # The updater's file mount delivers the config to the remote
            # user's literal ~/.tik (TIK_BOOTSTRAP_CONFIG_REMOTE); when
            # TIK_HOME points elsewhere (dev/test overrides), fall back to
            # the delivery location instead of failing node start.
            delivered = os.path.expanduser(
                "~/.tik/bootstrap-config.yaml")
            if os.path.exists(delivered):
                path = delivered
    with open(path) as f:
        return yaml.safe_load(f)


class NodeServicesStarter:
    def __init__(
        self,
        config: Dict[str, Any],
        node_id: str,
        *,
        is_head: bool,
        head_ip: str = "127.0.0.1",
        state_port: int = TIK_STATE_PORT_DEFAULT,
    ):
        self.config = config
        self.node_id = node_id
        self.is_head = is_head
        self.head_ip = head_ip
        self.state_port = state_port
        self.state_server: Optional[StateServer] = None
        self.controller: Optional[ClusterController] = None
        self.node_agent: Optional[NodeAgent] = None
        self.log_agent: Optional[LogAgent] = None
        self.state_client: Optional[StateClient] = None
        self.runtime_failures: Dict[str, str] = {}
        self.telemetry_server = None
        # trace propagation: the executor that launched this node's
        # start command exported TIK_TRACEPARENT — adopt it so every
        # span this process records joins the head-side boot trace
        from cloudtik_tpu_torch import telemetry
        telemetry.adopt_traceparent_from_env()

    # ------------------------------------------------------------------
    def start_head_processes(self) -> None:
        os.makedirs(os.path.expanduser(TIK_RUN_DIR), exist_ok=True)
        from cloudtik_tpu_torch.utils.constants import env_bool
        if env_bool("TIK_NATIVE_STATE", False):
            # Native C++ state server (native/state_server.cpp) — the
            # reference ran Redis (native C) here; same wire protocol as
            # the Python server, so every client is unchanged.
            from cloudtik_tpu_torch import native
            if native.compiler() is not None:
                server = native.NativeStateServer(port=self.state_port)
                server.start()
                self.state_server = server  # type: ignore[assignment]
                self.state_client = StateClient(
                    TcpStateBackend("127.0.0.1", server.port))
            else:
                logger.warning("TIK_NATIVE_STATE set but no C++ "
                               "compiler; using the Python server")
        if self.state_client is None:
            backend = FileStateBackend(
                os.path.join(os.path.expanduser(TIK_RUN_DIR), "state"))
            self.state_server = StateServer(
                port=self.state_port, backend=backend)
            self.state_server.start()
            self.state_client = StateClient(backend)

        # cluster info into KV (reference node_services.py:641)
        self.state_client.table_put("cluster", "info", {
            "cluster_name": self.config["cluster_name"],
            "workspace_name": self.config.get("workspace_name", ""),
            "head_node_id": self.node_id,
            "head_ip": self.head_ip,
            "started_at": time.time(),
        })

        provider = create_node_provider(
            self.config["provider"], self.config["cluster_name"])
        runtimes = iter_runtimes(self.config)
        node_constraints = {}
        scaling_policies = []
        for runtime in runtimes:
            for node_type in self.config.get("available_node_types", {}):
                constraint = runtime.get_node_constraints(
                    self.config, node_type)
                if constraint:
                    node_constraints[node_type] = constraint
            policy = runtime.get_scaling_policy(self.config, self.head_ip)
            if policy:
                scaling_policies.append(policy)

        self.controller = ClusterController(
            self.config, provider, self.state_client,
            scaling_policies=scaling_policies,
            node_constraints=node_constraints,
            metrics_port=self.config.get("controller_metrics_port"))
        self.controller.start()
        self._start_telemetry_server()
        self._start_common_agents()

    def _start_telemetry_server(self) -> None:
        """Expose this process's telemetry (/metrics, /trace) — the
        endpoint `tik trace`/`tik metrics` and the prometheus runtime's
        `telemetry` scrape target read.  Port 0 disables."""
        from cloudtik_tpu_torch import telemetry
        from cloudtik_tpu_torch.utils.constants import (
            TIK_TELEMETRY_PORT_DEFAULT)
        port = self.config.get("telemetry_port",
                               TIK_TELEMETRY_PORT_DEFAULT)
        if not telemetry.enabled() or not port:
            return
        try:
            from cloudtik_tpu_torch.runtimes.serving import runtime as serving
            self.telemetry_server = serving.serve_process_telemetry(port)
        except OSError as e:    # port taken: degrade, don't block boot
            logger.warning("telemetry server not started on %s: %s",
                           port, e)

    def start_node_processes(self) -> None:
        self.state_client = StateClient(
            TcpStateBackend(self.head_ip, self.state_port))
        self._start_common_agents()

    def _start_common_agents(self) -> None:
        from cloudtik_tpu_torch.runtimes import delivery
        from cloudtik_tpu_torch.telemetry import events

        # flight recorder (telemetry/events.py): daemons journal their
        # control-plane transitions durably; the journal lives under the
        # shipped log dirs so the log agent and cluster dumps carry it
        try:
            events.install()
            events.emit("tik_node_services_start", node_id=self.node_id,
                        is_head=self.is_head)
        except OSError:
            logger.warning("flight recorder not installed",
                           exc_info=True)

        runtimes = iter_runtimes(self.config)
        process_specs = []
        log_dirs: Dict[str, str] = {"tik": TIK_LOGS_DIR}
        # Node identity from the controller-published membership table
        # (seq_id for stable server ids, node_ip for bind addresses).
        my_info: Dict[str, Any] = {}
        try:
            my_info = self.state_client.table_get("nodes",
                                                  self.node_id) or {}
        except Exception:
            logger.warning("nodes table unavailable; using defaults")
        node_context = delivery.build_node_context(
            self.config,
            is_head=self.is_head,
            head_ip=self.head_ip,
            node_id=self.node_id,
            node_ip=my_info.get("ip") or (
                self.head_ip if self.is_head else ""),
            seq_id=my_info.get("seq_id", 1 if self.is_head else 0),
            # stateful runtimes (etcd/zookeeper/kafka/...) resolve peer
            # identity + membership through the state client
            state_client=self.state_client,
        )
        for runtime in runtimes:
            specs = runtime.get_processes()
            if specs:
                process_specs.extend(specs)
            log_dirs.update(runtime.get_logs())
        # Delivery pipeline (reference: `cloudtik runtime install|configure|
        # services` run by the node updater, runtime_scripts.py:338-343).
        # Failures are recorded per-runtime in the runtime_status table AND
        # in this node's status record — they are node state, not log noise.
        self.runtime_failures: Dict[str, str] = {}
        for phase_fn in (delivery.install_runtimes,
                         delivery.configure_runtimes,
                         delivery.start_runtime_services):
            try:
                phase_fn(self.config, node_context)
            except delivery.RuntimeDeliveryError as e:
                self.runtime_failures.update(e.failures)
                logger.error("runtime %s failed: %s", e.phase, e.failures)
                break  # don't start services on a broken install/configure
        self._publish_node_status()
        self.node_agent = NodeAgent(
            self.state_client, self.node_id, node_ip=self.head_ip
            if self.is_head else None, process_specs=process_specs)
        self.node_agent.start()
        self.log_agent = LogAgent(self.state_client, self.node_id, log_dirs)
        self.log_agent.start()

    def _publish_node_status(self) -> None:
        """Mirror runtime-delivery health into the head's node_status table
        so `tik status` and the scaler see failed nodes (reference: the node
        updater marking update-failed, node_updater.py:151)."""
        try:
            self.state_client.table_put("node_status", self.node_id, {
                "node_id": self.node_id,
                "is_head": self.is_head,
                "runtime_failures": dict(self.runtime_failures),
                "healthy": not self.runtime_failures,
                "time": time.time(),
            })
        except Exception:
            logger.warning("cannot publish node status", exc_info=True)

    # ------------------------------------------------------------------
    def stop(self) -> None:
        from cloudtik_tpu_torch.runtimes import delivery
        node_context = delivery.build_node_context(
            self.config, is_head=self.is_head, head_ip=self.head_ip,
            node_id=self.node_id, state_client=self.state_client)
        delivery.stop_runtime_services(self.config, node_context)
        for svc in (self.node_agent, self.log_agent, self.controller):
            if svc:
                svc.stop()
        if self.telemetry_server:
            self.telemetry_server.stop()
        from cloudtik_tpu_torch.telemetry import events
        events.uninstall()
        if self.state_server:
            self.state_server.stop()

    def run_until_signal(self) -> None:
        stop_event = threading.Event()

        def _handler(_sig, _frame):
            stop_event.set()

        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)
        pid_file = node_services_pid_file(
            self.config.get("cluster_name"))
        os.makedirs(os.path.dirname(pid_file), exist_ok=True)
        with open(pid_file, "w") as f:
            f.write(str(os.getpid()))
        try:
            stop_event.wait()
        finally:
            self.stop()
            try:
                os.unlink(pid_file)
            except OSError:
                pass
