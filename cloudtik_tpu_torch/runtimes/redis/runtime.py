"""Redis runtime: cache/KV with primary-replica replication.

Reference parity: runtime/redis (SURVEY.md §2.3 — 2,965 LoC; HA via
replication + leader election).  Primary runs on the head; workers render
`replicaof` pointing at it.  Failover promotes a replica through the
common active-standby service.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.runtimes.common.runtime_base import (
    ALL_NODES, ServiceRuntimeBase)

REDIS_PORT = 6379


def render_redis_conf(port: int = REDIS_PORT,
                      primary_ip: Optional[str] = None,
                      primary_port: int = REDIS_PORT,
                      password: Optional[str] = None,
                      data_dir: str = "~/.tik/redis/data",
                      maxmemory_mb: int = 0) -> str:
    """redis.conf text; replica when primary_ip is another host."""
    lines = [
        f"port {port}",
        "bind 0.0.0.0",
        "protected-mode no" if not password else "protected-mode yes",
        f"dir {data_dir}",
        "appendonly yes",
        "save 900 1",
    ]
    if maxmemory_mb:
        lines += [f"maxmemory {maxmemory_mb}mb",
                  "maxmemory-policy allkeys-lru"]
    if password:
        lines += [f"requirepass {password}",
                  f"masterauth {password}"]
    if primary_ip:
        lines.append(f"replicaof {primary_ip} {primary_port}")
    return "\n".join(lines) + "\n"


class RedisRuntime(ServiceRuntimeBase):
    SERVICE_NAME = "redis"
    DEFAULT_PORT = REDIS_PORT
    NODE_KIND = ALL_NODES
    PROCESS_KEYWORD = "redis-server"
    BINARY = "redis-server"
    # No default INSTALL: upstream ships source only; configs point
    # install at a prebuilt mirror or put redis-server on PATH.

    def service_command(self, node_context: Dict[str, Any]):
        import os
        conf = os.path.join(self.conf_dir(node_context), "redis.conf")
        binary = self.find_binary()
        if binary is None or not os.path.exists(conf):
            return None
        return [binary, conf]

    def node_configure(self, node_context: Dict[str, Any]) -> None:
        import os
        is_head = bool(node_context.get("is_head"))
        conf = render_redis_conf(
            port=self.port,
            primary_ip=None if is_head else node_context.get("head_ip"),
            primary_port=self.port,
            password=self.runtime_config.get("password"),
            maxmemory_mb=int(self.runtime_config.get("maxmemory_mb", 0)))
        with open(os.path.join(self.conf_dir(node_context),
                               "redis.conf"), "w") as f:
            f.write(conf)

    def get_runtime_services(self, cluster_config, cluster_head_ip):
        return {
            "redis": {"protocol": "tcp", "port": self.port,
                      "node_kind": "head",
                      "tags": {"role": "primary"}},
            "redis-replica": {"protocol": "tcp", "port": self.port,
                              "node_kind": "worker",
                              "tags": {"role": "replica"}},
        }

    def run_cli(self, *args: str) -> None:
        """redis-cli against the local server (no-op when the binary is
        absent — config renders are still testable without redis)."""
        import os
        import subprocess
        binary = self.find_binary()
        if binary is None:
            return
        cli = os.path.join(os.path.dirname(binary), "redis-cli")
        if not os.access(cli, os.X_OK):
            return
        cmd = [cli, "-p", str(self.port)]
        password = self.runtime_config.get("password")
        if password:
            cmd += ["-a", password]
        subprocess.run(cmd + list(args), capture_output=True)

    def post_start(self, node_context: Dict[str, Any]) -> None:
        """HA: campaign for the primary lease.  A promoted replica runs
        REPLICAOF NO ONE; surviving replicas re-point REPLICAOF at the
        new primary (reference: redis HA + sentinel-style promotion via
        leader election — sentinel's promote + reconfigure roles both
        ride the lease here)."""
        from cloudtik_tpu_torch.runtimes.common.failover import spawn_db_failover

        self._failover = spawn_db_failover(
            self, node_context,
            promote=lambda: self.run_cli("replicaof", "no", "one"),
            follow=lambda meta: self.run_cli(
                "replicaof", str(meta.get("ip", "")),
                str(meta.get("port", self.port))))
        if self._failover is not None:
            self.register_daemon(node_context, self._failover)
