"""HDFS runtime: NameNode on head, DataNodes on workers.

Reference parity: runtime/hdfs (SURVEY.md §2.3 — 1,362 LoC; NN/DN,
scripts/configure.sh's one-time `hdfs namenode -format` + DN join via
fs.defaultFS).  Renders core-site.xml + hdfs-site.xml; the NameNode
formats its metadata dir exactly once on first boot (gated on hadoop's
own `current/VERSION` marker), DataNodes join by pointing their RPC at
the head and need no format.  The TPU build's primary storage path is
GCS (mount runtime); HDFS exists for Spark/analytics parity.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    ALL_NODES, ServiceRuntimeBase)

NN_RPC_PORT = 9000
NN_HTTP_PORT = 9870
DN_PORT = 9866


def _xml_configuration(props: List[Tuple[str, Any]]) -> str:
    body = "\n".join(
        f"  <property>\n    <name>{k}</name>\n"
        f"    <value>{v}</value>\n  </property>"
        for k, v in props)
    return ("<?xml version=\"1.0\"?>\n<configuration>\n"
            f"{body}\n</configuration>\n")


def render_core_site(namenode_ip: str, rpc_port: int = NN_RPC_PORT) -> str:
    return _xml_configuration([
        ("fs.defaultFS", f"hdfs://{namenode_ip}:{rpc_port}"),
        ("hadoop.tmp.dir", "/tmp/hadoop-tik"),
    ])


def render_hdfs_site(is_namenode: bool, replication: int = 3,
                     name_dir: str = "~/.tik/hdfs/name",
                     data_dirs: str = "~/.tik/hdfs/data") -> str:
    # hadoop does NOT expand '~' in dir properties — emit absolute
    # file: URIs or the daemons create a literal './~' tree
    props = [
        ("dfs.replication", replication),
        ("dfs.namenode.name.dir",
         f"file://{os.path.expanduser(name_dir)}"),
        ("dfs.datanode.data.dir",
         f"file://{os.path.expanduser(data_dirs)}"),
        ("dfs.namenode.http-address", f"0.0.0.0:{NN_HTTP_PORT}"),
        ("dfs.permissions.enabled", "false"),
    ]
    return _xml_configuration(props)


class HDFSRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "hdfs"
    DEFAULT_PORT = NN_RPC_PORT
    NODE_KIND = ALL_NODES
    PROCESS_KEYWORD = "NameNode"
    ENDPOINT_NAME = "HDFS NameNode UI"
    BINARY = "hdfs"
    # Reference: runtime/hdfs install recipe (hadoop release tarball).
    INSTALL = {
        "type": "archive",
        "url": ("https://archive.apache.org/dist/hadoop/common/"
                "hadoop-3.3.6/hadoop-3.3.6.tar.gz"),
        "strip_components": 1,
    }

    def name_dir(self) -> str:
        return os.path.expanduser(self.runtime_config.get(
            "name_dir", "~/.tik/hdfs/name"))

    def maybe_format_namenode(self, node_context: Dict[str, Any]) -> bool:
        """One-time metadata format before the first NameNode boot.

        Gated on hadoop's own `current/VERSION` marker (what the NN
        checks at startup), so re-bootstraps and restarts never reformat
        — a reformat would orphan every DataNode's blocks under a new
        clusterID (reference: hdfs scripts/configure.sh format-on-first-
        boot).  Returns True if a format ran."""
        import subprocess
        if os.path.exists(os.path.join(self.name_dir(), "current",
                                       "VERSION")):
            return False
        binary = self.find_binary()
        if binary is None:
            return False
        try:
            timeout_s = float(self.runtime_config.get(
                "format_timeout_s", 60))
        except (TypeError, ValueError):
            timeout_s = 60.0
        try:
            # bounded: a real format takes seconds; a wedged (or fake)
            # binary must not hang node boot — the NN itself will fail
            # loudly on an unformatted dir if this didn't succeed
            subprocess.run(
                [binary, "--config", self.conf_dir(node_context),
                 "namenode", "-format", "-nonInteractive"],
                capture_output=True, timeout=timeout_s)
        except (subprocess.TimeoutExpired, OSError):
            # a format KILLED mid-write may have dropped current/VERSION
            # without a complete fsimage; leaving it would make the
            # format-once gate refuse to retry forever while the NN
            # crash-loops — wipe the partial marker so next boot retries
            import shutil
            shutil.rmtree(os.path.join(self.name_dir(), "current"),
                          ignore_errors=True)
            return False
        return os.path.exists(os.path.join(self.name_dir(), "current",
                                           "VERSION"))

    def service_command(self, node_context: Dict[str, Any]):
        binary = self.find_binary()
        if binary is None:
            return None
        if node_context.get("is_head"):
            self.maybe_format_namenode(node_context)
            return [binary, "--config", self.conf_dir(node_context),
                    "namenode"]
        # DataNodes join by pointing at fs.defaultFS; no format step
        return [binary, "--config", self.conf_dir(node_context),
                "datanode"]

    def service_ready_port(self, node_context: Dict[str, Any]):
        # only the head's namenode listens on the NN RPC port
        return self.port if node_context.get("is_head") else None

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        import os
        conf_dir = self.conf_dir(node_context)
        head_ip = node_context.get("head_ip", "")
        with open(os.path.join(conf_dir, "core-site.xml"), "w") as f:
            f.write(render_core_site(head_ip, rpc_port=self.port))
        with open(os.path.join(conf_dir, "hdfs-site.xml"), "w") as f:
            f.write(render_hdfs_site(
                is_namenode=bool(node_context.get("is_head")),
                replication=int(
                    self.runtime_config.get("replication", 3)),
                name_dir=self.runtime_config.get(
                    "name_dir", "~/.tik/hdfs/name"),
                data_dirs=self.runtime_config.get(
                    "data_dirs", "~/.tik/hdfs/data")))

    def get_runtime_services(self, cluster_config, cluster_head_ip):
        return {
            "hdfs": {"protocol": "tcp", "port": self.port,
                     "node_kind": "head", "tags": {"role": "namenode"}},
            "hdfs-http": {"protocol": "http", "port": NN_HTTP_PORT,
                          "node_kind": "head"},
        }

    def get_runtime_endpoints(self, cluster_config, cluster_head_ip):
        return {"hdfs": {
            "name": "HDFS NameNode UI",
            "url": f"http://{cluster_head_ip}:{NN_HTTP_PORT}",
        }}

    def get_processes(self):
        return [("NameNode", False, "HDFS NameNode", "head"),
                ("DataNode", False, "HDFS DataNode", "worker")]
