"""PostgreSQL runtime: primary + streaming replicas with failover.

Reference parity: runtime/postgres (SURVEY.md §2.3 — 4,120 LoC; HA via
replication + consul/etcd leader election).  Primary election rides the
common active-standby service on the head state store; replicas render
primary_conninfo from the elected primary.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    ALL_NODES, ServiceRuntimeBase)

PG_PORT = 5432


def render_postgresql_conf(port: int = PG_PORT,
                           max_connections: int = 100,
                           shared_buffers_mb: int = 128,
                           is_primary: bool = True,
                           synchronous: bool = False) -> str:
    lines = [
        "listen_addresses = '*'",
        f"port = {port}",
        f"max_connections = {max_connections}",
        f"shared_buffers = {shared_buffers_mb}MB",
        "wal_level = replica",
        "max_wal_senders = 10",
        "max_replication_slots = 10",
        "hot_standby = on",
    ]
    if is_primary and synchronous:
        lines.append("synchronous_standby_names = '*'")
    return "\n".join(lines) + "\n"


def render_pg_hba(subnet_cidrs: List[str],
                  replication_user: str = "replicator") -> str:
    lines = [
        "local   all             all                     trust",
        "host    all             all   127.0.0.1/32      md5",
    ]
    for cidr in subnet_cidrs:
        lines.append(f"host    all             all   {cidr:<17} md5")
        lines.append(
            f"host    replication     {replication_user} {cidr:<17} md5")
    return "\n".join(lines) + "\n"


def render_replica_conninfo(primary_ip: str, port: int = PG_PORT,
                            user: str = "replicator",
                            password: str = "") -> str:
    """standby signal settings appended to postgresql.auto.conf."""
    auth = f" password={password}" if password else ""
    return (f"primary_conninfo = 'host={primary_ip} port={port} "
            f"user={user}{auth} application_name=tik_standby'\n")


class PostgresRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "postgres"
    BINARY = "postgres"
    CONF_FILE = "postgresql.conf"

    def service_command(self, node_context):
        import os
        conf = os.path.join(self.conf_dir(node_context),
                            "postgresql.conf")
        binary = self.find_binary()
        if binary is None or not os.path.exists(conf):
            return None
        data_dir = os.path.expanduser(self.runtime_config.get(
            "data_dir", "~/.tik/postgres/data"))
        if not os.path.exists(os.path.join(data_dir, "PG_VERSION")):
            # first boot: initdb from the same installation
            import subprocess
            initdb = os.path.join(os.path.dirname(binary), "initdb")
            if os.access(initdb, os.X_OK):
                subprocess.run([initdb, "-D", data_dir, "-U", "tik"],
                               capture_output=True)
        return [binary, "-D", data_dir,
                "-c", f"config_file={conf}",
                "-p", str(self.port)]
    DEFAULT_PORT = PG_PORT
    NODE_KIND = ALL_NODES
    PROCESS_KEYWORD = "postgres"

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        import os
        is_head = bool(node_context.get("is_head"))
        conf_dir = self.conf_dir(node_context)
        with open(os.path.join(conf_dir, "postgresql.conf"), "w") as f:
            f.write(render_postgresql_conf(
                port=self.port, is_primary=is_head,
                shared_buffers_mb=int(
                    self.runtime_config.get("shared_buffers_mb", 128)),
                synchronous=bool(
                    self.runtime_config.get("synchronous", False))))
        with open(os.path.join(conf_dir, "pg_hba.conf"), "w") as f:
            f.write(render_pg_hba(
                self.runtime_config.get("allowed_cidrs", ["10.0.0.0/8"])))
        if not is_head:
            with open(os.path.join(conf_dir, "standby.conf"), "w") as f:
                f.write(render_replica_conninfo(
                    node_context.get("head_ip", ""), port=self.port,
                    password=self.runtime_config.get(
                        "replication_password", "")))

    def get_runtime_services(self, cluster_config, cluster_head_ip):
        return {
            "postgres": {"protocol": "tcp", "port": self.port,
                         "node_kind": "head",
                         "tags": {"role": "primary"}},
            "postgres-replica": {"protocol": "tcp", "port": self.port,
                                 "node_kind": "worker",
                                 "tags": {"role": "replica"}},
        }

    def post_start(self, node_context: Dict[str, Any]) -> None:
        """HA: campaign for the primary lease; on takeover run
        `pg_ctl promote` (reference: postgres HA failover via
        consul/etcd leader election).  Surviving standbys re-render
        primary_conninfo at the new primary and signal a conf reload
        (a returning OLD primary additionally needs pg_rewind before it
        can rejoin as a standby — documented in docs/operations.md)."""
        from cloudtik_tpu_torch.runtimes.common.failover import spawn_db_failover

        def promote():
            import os
            import subprocess
            binary = self.find_binary()
            if binary is None:
                return
            data_dir = os.path.expanduser(self.runtime_config.get(
                "data_dir", "~/.tik/postgres/data"))
            pg_ctl = os.path.join(os.path.dirname(binary), "pg_ctl")
            if os.access(pg_ctl, os.X_OK):
                subprocess.run([pg_ctl, "promote", "-D", data_dir],
                               capture_output=True)

        def follow(meta):
            import os
            import subprocess
            conf_dir = self.conf_dir(node_context)
            with open(os.path.join(conf_dir, "standby.conf"), "w") as f:
                f.write(render_replica_conninfo(
                    str(meta.get("ip", "")),
                    port=int(meta.get("port", self.port)),
                    password=self.runtime_config.get(
                        "replication_password", "")))
            binary = self.find_binary()
            if binary is None:
                return
            data_dir = os.path.expanduser(self.runtime_config.get(
                "data_dir", "~/.tik/postgres/data"))
            pg_ctl = os.path.join(os.path.dirname(binary), "pg_ctl")
            if os.access(pg_ctl, os.X_OK):
                subprocess.run([pg_ctl, "reload", "-D", data_dir],
                               capture_output=True)

        self._failover = spawn_db_failover(
            self, node_context, promote, follow=follow)
        if self._failover is not None:
            # process-wide registration: the stop path runs on a fresh
            # runtime instance, which finds the daemon via the registry
            self.register_daemon(node_context, self._failover)
