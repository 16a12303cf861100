"""Hive Metastore runtime.

Reference parity: runtime/metastore (SURVEY.md §2.3 — 570 LoC; discovers
MySQL/Postgres via service discovery for its backing DB).  Renders
hive-site.xml with a JDBC URL resolved through the discovery client
(explicit endpoint config wins, then cluster discovery).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.runtimes.common.discovery_client import (
    discover_endpoint_for_config)
from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    HEAD, ServiceRuntimeBase)
from cloudtik_tpu_torch.runtimes.hdfs.runtime import _xml_configuration

METASTORE_PORT = 9083


def render_hive_site(db_kind: str, db_host: str, db_port: int,
                     db_name: str = "metastore",
                     db_user: str = "hive",
                     db_password: str = "hive",
                     port: int = METASTORE_PORT) -> str:
    if db_kind == "mysql":
        url = (f"jdbc:mysql://{db_host}:{db_port}/{db_name}"
               "?createDatabaseIfNotExist=true")
        driver = "com.mysql.cj.jdbc.Driver"
    else:
        url = f"jdbc:postgresql://{db_host}:{db_port}/{db_name}"
        driver = "org.postgresql.Driver"
    return _xml_configuration([
        ("javax.jdo.option.ConnectionURL", url),
        ("javax.jdo.option.ConnectionDriverName", driver),
        ("javax.jdo.option.ConnectionUserName", db_user),
        ("javax.jdo.option.ConnectionPassword", db_password),
        ("hive.metastore.uris", f"thrift://0.0.0.0:{port}"),
        ("hive.metastore.warehouse.dir", "~/.tik/hive/warehouse"),
    ])


class MetastoreRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "metastore"
    DEFAULT_PORT = METASTORE_PORT
    NODE_KIND = HEAD
    PROCESS_KEYWORD = "HiveMetaStore"
    DEPENDENCIES = ["mysql"]
    BINARY = "start-metastore"
    CONF_FILE = "hive-site.xml"
    SERVICE_ARGS = ("{binary}", "-p", "{port}")
    # Reference: runtime/metastore install recipe (standalone metastore).
    INSTALL = {
        "type": "archive",
        "url": ("https://archive.apache.org/dist/hive/"
                "hive-standalone-metastore-3.0.0/"
                "hive-standalone-metastore-3.0.0-bin.tar.gz"),
        "strip_components": 1,
    }

    def service_env(self, node_context: Dict[str, Any]):
        from cloudtik_tpu_torch.runtimes import installer
        return {"METASTORE_HOME": installer.install_dir(
                    self.SERVICE_NAME),
                "HIVE_CONF_DIR": self.conf_dir(node_context)}

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        if not self.runs_on(node_context):
            return
        import os
        config = node_context.get("config", {})
        state = node_context.get("state_client")

        def registry_factory():
            if state is None:
                return None
            from cloudtik_tpu_torch.runtimes.discovery.runtime import (
                ServiceRegistry)
            return ServiceRegistry(
                state, cluster=config.get("cluster_name", ""),
                workspace=config.get("workspace_name", ""))

        db_kind = "mysql"
        ep = discover_endpoint_for_config(
            config, "metastore", "mysql", registry_factory, 3306)
        if ep is None:
            db_kind = "postgres"
            ep = discover_endpoint_for_config(
                config, "metastore", "postgres", registry_factory, 5432)
        if ep is None:
            return  # no backing DB yet; configure retries next tick
        site = render_hive_site(
            db_kind, ep["host"], ep["port"],
            db_user=self.runtime_config.get("db_user", "hive"),
            db_password=self.runtime_config.get("db_password", "hive"),
            port=self.port)
        with open(os.path.join(self.conf_dir(node_context),
                               "hive-site.xml"), "w") as f:
            f.write(site)
