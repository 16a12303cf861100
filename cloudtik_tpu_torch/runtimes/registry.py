"""Runtime registry: name -> Runtime class, over the port's runtimes.

Counterpart of `cloudtik_tpu/runtimes/registry.py`: the same loading rules
(a registered class first, then a built-in name, then an external
`package.module:Class`) and the same built-in names, each mapped to the
port's copy of that runtime.  The one difference: an external name in the
JAX package (`cloudtik_tpu.<module>:<Class>`) raises
`UnknownRuntimeError`, so a port cluster never loads a JAX-package class.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Type

from cloudtik_tpu_torch.core.runtime import Runtime

# built-in runtime name -> module path : class name
_BUILT_IN: Dict[str, str] = {
    "ai": "cloudtik_tpu_torch.runtimes.ai.runtime:AIRuntime",
    "prometheus":
        "cloudtik_tpu_torch.runtimes.prometheus.runtime:PrometheusRuntime",
    "nodex": "cloudtik_tpu_torch.runtimes.nodex.runtime:NodexRuntime",
    "mount": "cloudtik_tpu_torch.runtimes.mount.runtime:MountRuntime",
    "discovery":
        "cloudtik_tpu_torch.runtimes.discovery.runtime:DiscoveryRuntime",
    "sshserver":
        "cloudtik_tpu_torch.runtimes.sshserver.runtime:SSHServerRuntime",
    "spark": "cloudtik_tpu_torch.runtimes.spark.runtime:SparkRuntime",
    "grafana": "cloudtik_tpu_torch.runtimes.grafana.runtime:GrafanaRuntime",
    "mlflow": "cloudtik_tpu_torch.runtimes.mlflow.runtime:MLflowRuntime",
    "serving": "cloudtik_tpu_torch.runtimes.serving.runtime:ServingRuntime",
    "profiler": "cloudtik_tpu_torch.runtimes.profiler.runtime:ProfilerRuntime",
    # stateful / data services
    "etcd": "cloudtik_tpu_torch.runtimes.etcd.runtime:EtcdRuntime",
    "zookeeper":
        "cloudtik_tpu_torch.runtimes.zookeeper.runtime:ZooKeeperRuntime",
    "kafka": "cloudtik_tpu_torch.runtimes.kafka.runtime:KafkaRuntime",
    "redis": "cloudtik_tpu_torch.runtimes.redis.runtime:RedisRuntime",
    "mysql": "cloudtik_tpu_torch.runtimes.mysql.runtime:MySQLRuntime",
    "postgres":
        "cloudtik_tpu_torch.runtimes.postgres.runtime:PostgresRuntime",
    "mongodb": "cloudtik_tpu_torch.runtimes.mongodb.runtime:MongoDBRuntime",
    "elasticsearch":
        "cloudtik_tpu_torch.runtimes.elasticsearch.runtime:ElasticsearchRuntime",
    "hdfs": "cloudtik_tpu_torch.runtimes.hdfs.runtime:HDFSRuntime",
    "metastore":
        "cloudtik_tpu_torch.runtimes.metastore.runtime:MetastoreRuntime",
    "minio": "cloudtik_tpu_torch.runtimes.minio.runtime:MinIORuntime",
    "consul": "cloudtik_tpu_torch.runtimes.consul.runtime:ConsulRuntime",
    # load balancers / gateways / DNS / health
    "haproxy": "cloudtik_tpu_torch.runtimes.haproxy.runtime:HAProxyRuntime",
    "nginx": "cloudtik_tpu_torch.runtimes.nginx.runtime:NginxRuntime",
    "kong": "cloudtik_tpu_torch.runtimes.kong.runtime:KongRuntime",
    "apisix": "cloudtik_tpu_torch.runtimes.apisix.runtime:APISIXRuntime",
    "loadbalancer":
        "cloudtik_tpu_torch.runtimes.loadbalancer.runtime:LoadBalancerRuntime",
    "dnsmasq": "cloudtik_tpu_torch.runtimes.dnsmasq.runtime:DnsmasqRuntime",
    "bind": "cloudtik_tpu_torch.runtimes.bind.runtime:BindRuntime",
    "coredns": "cloudtik_tpu_torch.runtimes.coredns.runtime:CoreDNSRuntime",
    "xinetd": "cloudtik_tpu_torch.runtimes.xinetd.runtime:XinetdRuntime",
    # compute / SQL engines / poolers
    "yarn": "cloudtik_tpu_torch.runtimes.yarn.runtime:YARNRuntime",
    "flink": "cloudtik_tpu_torch.runtimes.flink.runtime:FlinkRuntime",
    "ray": "cloudtik_tpu_torch.runtimes.ray.runtime:RayRuntime",
    "trino": "cloudtik_tpu_torch.runtimes.trino.runtime:TrinoRuntime",
    "presto": "cloudtik_tpu_torch.runtimes.presto.runtime:PrestoRuntime",
    "pgpool": "cloudtik_tpu_torch.runtimes.pgpool.runtime:PgpoolRuntime",
    "pgbouncer":
        "cloudtik_tpu_torch.runtimes.pgbouncer.runtime:PgBouncerRuntime",
}

# Installed on every cluster unless disabled (reference: DEFAULT_RUNTIMES =
# [nodex, prometheus, spark]; here the AI stack is the default workload).
DEFAULT_RUNTIMES: List[str] = ["nodex", "prometheus"]

_registry: Dict[str, Type[Runtime]] = {}

# the JAX package, whose runtime classes the port never loads
REFERENCE_PACKAGE = "cloudtik_tpu"


class UnknownRuntimeError(ValueError):
    pass


def register_runtime(name: str, cls: Type[Runtime]) -> None:
    _registry[name] = cls


def get_runtime_cls(name: str) -> Type[Runtime]:
    if name in _registry:
        return _registry[name]
    spec = _BUILT_IN.get(name)
    if spec is None:
        # external runtime: "package.module:Class"
        if ":" in name:
            spec = name
        else:
            raise UnknownRuntimeError(
                f"Unknown runtime {name!r}; known: {sorted(_BUILT_IN)}")
    module_name, _, cls_name = spec.partition(":")
    if module_name.split(".")[0] == REFERENCE_PACKAGE:
        raise UnknownRuntimeError(
            f"Runtime {name!r} names the JAX package; the port's runtimes "
            f"are {sorted(_BUILT_IN)} or cloudtik_tpu_torch.<module>:<Class>")
    module = importlib.import_module(module_name)
    cls = getattr(module, cls_name)
    _registry[name] = cls
    return cls


def create_runtime(name: str, runtime_config: Dict[str, Any]) -> Runtime:
    runtime = get_runtime_cls(name)(runtime_config)
    # The registered name is the contract the CLI, delivery status records,
    # and state tables key on — stamp it so consumers never have to derive
    # a second naming scheme from the class name.
    runtime.registered_name = name
    return runtime


def runtime_types(config: Dict[str, Any]) -> List[str]:
    return list((config.get("runtime") or {}).get("types") or [])


def iter_runtimes(config: Dict[str, Any]) -> List[Runtime]:
    """Instantiate all runtimes declared in a cluster config, in dependency
    order (a runtime's get_dependencies run before it)."""
    names = runtime_types(config)
    runtime_config = config.get("runtime", {})
    ordered: List[str] = []
    visiting: set = set()

    def visit(name: str):
        if name in ordered:
            return
        if name in visiting:
            raise ValueError(f"runtime dependency cycle at {name!r}")
        visiting.add(name)
        for dep in get_runtime_cls(name).get_dependencies():
            if dep in names:
                visit(dep)
        visiting.discard(name)
        ordered.append(name)

    for n in names:
        visit(n)
    return [create_runtime(n, runtime_config.get(n, {})) for n in ordered]
