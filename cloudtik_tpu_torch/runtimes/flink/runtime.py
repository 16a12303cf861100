"""Flink runtime: streaming engine (JobManager head / TaskManagers workers).

Reference parity: runtime/flink (SURVEY.md §2.3 — 970 LoC; Flink on YARN).
This build renders standalone-cluster flink-conf.yaml (no YARN required);
when the yarn runtime is present the services script launches a YARN
session instead.
"""

from __future__ import annotations

from typing import Any, Dict

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    ALL_NODES, ServiceRuntimeBase)

JM_RPC_PORT = 6123
JM_UI_PORT = 8081


# Memory-sizing ratios mirroring the reference's session sizing
# (runtime/flink/utils.py:26-35, get_flink_jobmanager_memory:57): the
# node's schedulable memory fraction, the JM's share with clamps, and
# the per-TM overhead floor.
RESOURCE_MEMORY_RATIO = 0.8
JM_MEMORY_RATIO = 0.02
JM_MEMORY_MIN_MB = 1024
JM_MEMORY_MAX_MB = 8192
ADDITIONAL_OVERHEAD_MB = 1024
TM_OVERHEAD_RATIO = 0.1
TM_OVERHEAD_MIN_MB = 384


def size_flink_memory(node_memory_bytes: int,
                      node_cpus: int) -> Dict[str, int]:
    """Session sizing from the node's resources: JM share (clamped),
    TM process size after overheads, one slot per core."""
    for_flink = int(node_memory_bytes / (1024 * 1024)
                    * RESOURCE_MEMORY_RATIO)
    jm = max(min(int(for_flink * JM_MEMORY_RATIO), JM_MEMORY_MAX_MB),
             JM_MEMORY_MIN_MB)
    tm_all = max(for_flink - jm - ADDITIONAL_OVERHEAD_MB,
                 TM_OVERHEAD_MIN_MB + 512)
    overhead = max(int(tm_all * TM_OVERHEAD_RATIO), TM_OVERHEAD_MIN_MB)
    return {"jm_memory_mb": jm,
            "tm_memory_mb": max(tm_all - overhead, 512),
            "slots_per_tm": max(int(node_cpus), 1)}


def render_flink_conf(jobmanager_ip: str,
                      jm_memory_mb: int = 1600,
                      tm_memory_mb: int = 1728,
                      slots_per_tm: int = 2) -> str:
    return "\n".join([
        f"jobmanager.rpc.address: {jobmanager_ip}",
        f"jobmanager.rpc.port: {JM_RPC_PORT}",
        f"jobmanager.memory.process.size: {jm_memory_mb}m",
        f"taskmanager.memory.process.size: {tm_memory_mb}m",
        f"taskmanager.numberOfTaskSlots: {slots_per_tm}",
        f"rest.port: {JM_UI_PORT}",
        "rest.address: 0.0.0.0",
        "execution.checkpointing.interval: 60000",
    ]) + "\n"


class FlinkRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "flink"
    DEFAULT_PORT = JM_UI_PORT
    PROTOCOL = "http"
    NODE_KIND = ALL_NODES
    PROCESS_KEYWORD = "flink"
    ENDPOINT_NAME = "Flink Dashboard"
    BINARY = "jobmanager.sh"
    # Reference: runtime/flink install recipe (release tarball).
    INSTALL = {
        "type": "archive",
        "url": ("https://archive.apache.org/dist/flink/flink-1.18.1/"
                "flink-1.18.1-bin-scala_2.12.tgz"),
        "strip_components": 1,
    }

    def service_command(self, node_context):
        import os
        binary = self.find_binary()
        if binary is None:
            return None
        if node_context.get("is_head"):
            return [binary, "start-foreground"]
        tm = os.path.join(os.path.dirname(binary), "taskmanager.sh")
        return [tm, "start-foreground"] if os.access(tm, os.X_OK) else None

    def service_env(self, node_context):
        from cloudtik_tpu_torch.runtimes import installer
        return {"FLINK_CONF_DIR": self.conf_dir(node_context),
                "FLINK_HOME": installer.install_dir(self.SERVICE_NAME)}

    def service_ready_port(self, node_context):
        return self.port if node_context.get("is_head") else None

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        import os
        sized = self._sized(node_context)
        conf = render_flink_conf(
            node_context.get("head_ip", ""),
            jm_memory_mb=int(self.runtime_config.get(
                "jm_memory_mb", sized["jm_memory_mb"])),
            tm_memory_mb=int(self.runtime_config.get(
                "tm_memory_mb", sized["tm_memory_mb"])),
            slots_per_tm=int(self.runtime_config.get(
                "slots_per_tm", sized["slots_per_tm"])))
        with open(os.path.join(self.conf_dir(node_context),
                               "flink-conf.yaml"), "w") as f:
            f.write(conf)

    def _sized(self, node_context: Dict[str, Any]) -> Dict[str, int]:
        """Auto-size from this node's detected resources (explicit
        runtime_config values override per key)."""
        try:
            from cloudtik_tpu_torch.utils.resource_spec import (
                detect_node_resources)
            res = detect_node_resources()
            return size_flink_memory(
                int(res.get("memory", 0)), int(res.get("CPU", 1)))
        except Exception:
            return {"jm_memory_mb": 1600, "tm_memory_mb": 1728,
                    "slots_per_tm": 2}

    def get_processes(self):
        return [("StandaloneSessionClusterEntrypoint", False,
                 "Flink JobManager", "head"),
                ("TaskManagerRunner", False,
                 "Flink TaskManager", "worker")]
