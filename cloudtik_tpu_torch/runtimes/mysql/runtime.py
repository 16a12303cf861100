"""MySQL runtime: source-replica replication.

Reference parity: runtime/mysql (SURVEY.md §2.3 — 1,438 LoC; HA via
replication).  Source on head, replicas on workers; server ids are derived
from the node's stable seq id so they survive restarts.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    ALL_NODES, ServiceRuntimeBase)

MYSQL_PORT = 3306


def render_my_cnf(server_id: int, port: int = MYSQL_PORT,
                  is_source: bool = True,
                  source_ip: Optional[str] = None,
                  buffer_pool_mb: int = 256,
                  data_dir: str = "~/.tik/mysql/data") -> str:
    lines = [
        "[mysqld]",
        f"server-id = {server_id}",
        f"port = {port}",
        "bind-address = 0.0.0.0",
        f"datadir = {data_dir}",
        f"innodb_buffer_pool_size = {buffer_pool_mb}M",
        "log-bin = mysql-bin",
        "binlog_format = ROW",
        "gtid_mode = ON",
        "enforce-gtid-consistency = ON",
    ]
    if not is_source:
        lines += [
            "relay-log = relay-bin",
            "read_only = ON",
            "super_read_only = ON",
            f"# replicate from {source_ip}:{port} (CHANGE REPLICATION "
            "SOURCE issued at post_start — see replica-setup.sql)",
        ]
    return "\n".join(lines) + "\n"


def _sql_quote(value: str) -> str:
    """Single-quoted MySQL string literal: ' doubles, \\ escapes — a
    password like o'brien must not truncate (or inject into) the
    CHANGE REPLICATION SOURCE statement."""
    return "'" + str(value).replace("\\", "\\\\").replace("'", "''") + "'"


def render_change_source_sql(source_ip: str, port: int = MYSQL_PORT,
                             user: str = "replicator",
                             password: str = "") -> str:
    """GTID auto-position replication re-point (reference: mysql group
    replication / source-replica setup, runtime/mysql/utils.py:27 — here
    the CHANGE REPLICATION SOURCE flow with GTID auto-position, which is
    what makes re-pointing at a promoted source safe without binlog
    coordinates)."""
    return (
        "STOP REPLICA;\n"
        "CHANGE REPLICATION SOURCE TO\n"
        f"  SOURCE_HOST={_sql_quote(source_ip)},\n"
        f"  SOURCE_PORT={int(port)},\n"
        f"  SOURCE_USER={_sql_quote(user)},\n"
        f"  SOURCE_PASSWORD={_sql_quote(password)},\n"
        "  SOURCE_AUTO_POSITION=1;\n"
        "START REPLICA;\n")


def render_promote_sql() -> str:
    """Replica -> writable source: stop applying, drop replica state,
    open writes."""
    return (
        "STOP REPLICA;\n"
        "RESET REPLICA ALL;\n"
        "SET GLOBAL super_read_only = OFF;\n"
        "SET GLOBAL read_only = OFF;\n")


class MySQLRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "mysql"
    BINARY = "mysqld"
    CONF_FILE = "my.cnf"
    SERVICE_ARGS = ("{binary}", "--defaults-file={conf}",
                    "--port={port}")
    DEFAULT_PORT = MYSQL_PORT
    NODE_KIND = ALL_NODES
    PROCESS_KEYWORD = "mysqld"

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        import os
        is_head = bool(node_context.get("is_head"))
        seq = int(node_context.get("seq_id", 0))
        conf_dir = self.conf_dir(node_context)
        conf = render_my_cnf(
            server_id=seq + 1, port=self.port, is_source=is_head,
            source_ip=node_context.get("head_ip"),
            buffer_pool_mb=int(
                self.runtime_config.get("buffer_pool_mb", 256)))
        with open(os.path.join(conf_dir, "my.cnf"), "w") as f:
            f.write(conf)
        if not is_head:
            sql_path = os.path.join(conf_dir, "replica-setup.sql")
            # the rendered file embeds the replication password: create
            # it 0600 from the first byte (a chmod after writing leaves
            # a world-readable window under the default umask)
            fd = os.open(sql_path,
                         os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
            with os.fdopen(fd, "w") as f:
                f.write(render_change_source_sql(
                    node_context.get("head_ip", ""), port=self.port,
                    user=self.runtime_config.get(
                        "replication_user", "replicator"),
                    password=self.runtime_config.get(
                        "replication_password", "")))
            os.chmod(sql_path, 0o600)  # O_TRUNC path: tighten pre-existing

    def run_sql(self, sql: str) -> None:
        """Feed SQL to the local server via the mysql client (no-op when
        the binary is absent — renders stay testable without mysqld)."""
        import os
        import subprocess
        binary = self.find_binary()
        if binary is None:
            return
        client = os.path.join(os.path.dirname(binary), "mysql")
        if not os.access(client, os.X_OK):
            return
        subprocess.run([client, "--port", str(self.port),
                        "--protocol", "tcp", "-u", "root"],
                       input=sql.encode(), capture_output=True)

    def get_runtime_services(self, cluster_config, cluster_head_ip):
        return {
            "mysql": {"protocol": "tcp", "port": self.port,
                      "node_kind": "head", "tags": {"role": "source"}},
            "mysql-replica": {"protocol": "tcp", "port": self.port,
                              "node_kind": "worker",
                              "tags": {"role": "replica"}},
        }

    def post_start(self, node_context: Dict[str, Any]) -> None:
        """HA (reference: runtime/mysql replication, utils.py:27): a
        replica starts its GTID replication stream, campaigns for the
        source lease, promotes itself when the lease lapses (promote
        SQL), and re-points CHANGE REPLICATION SOURCE when another
        member is promoted."""
        from cloudtik_tpu_torch.runtimes.common.failover import spawn_db_failover

        if not node_context.get("is_head"):
            self.run_sql(render_change_source_sql(
                node_context.get("head_ip", ""), port=self.port,
                user=self.runtime_config.get(
                    "replication_user", "replicator"),
                password=self.runtime_config.get(
                    "replication_password", "")))

        self._failover = spawn_db_failover(
            self, node_context,
            promote=lambda: self.run_sql(render_promote_sql()),
            follow=lambda meta: self.run_sql(render_change_source_sql(
                str(meta.get("ip", "")),
                port=int(meta.get("port", self.port)),
                user=self.runtime_config.get(
                    "replication_user", "replicator"),
                password=self.runtime_config.get(
                    "replication_password", ""))))
        if self._failover is not None:
            self.register_daemon(node_context, self._failover)
