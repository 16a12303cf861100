"""Service-discovery client library for runtimes.

Reference parity: runtime/common/service_discovery/ (consul.py query/DNS
helpers :121-486, discovery.py:19 DiscoveryType, runtime_discovery.py:84
discover_runtime_service + per-service discover_* helpers wired into cluster
config bootstrap).  Queries go to the head state store's services table via
the ServiceRegistry instead of Consul.
"""

from __future__ import annotations

import enum
import time
from typing import Any, Callable, Dict, List, Optional

from cloudtik_tpu_torch.runtimes.discovery.runtime import ServiceRegistry


class DiscoveryType(enum.Enum):
    """How a runtime locates a service it depends on
    (reference: discovery.py:19)."""
    LOCAL = "local"            # same node
    CLUSTER = "cluster"        # same cluster (head registry)
    WORKSPACE = "workspace"    # any cluster in the workspace
    CONFIG = "config"          # explicitly configured endpoint


class ServiceAddress:
    def __init__(self, host: str, port: int, node_id: str = "",
                 tags: Optional[Dict[str, str]] = None):
        self.host = host
        self.port = port
        self.node_id = node_id
        self.tags = tags or {}

    def uri(self, scheme: str = "") -> str:
        return (f"{scheme}://{self.host}:{self.port}" if scheme
                else f"{self.host}:{self.port}")

    def __repr__(self):
        return f"ServiceAddress({self.host}:{self.port})"


def discover_service(registry: ServiceRegistry, name: str,
                     tags: Optional[Dict[str, str]] = None,
                     max_age_s: Optional[float] = None
                     ) -> List[ServiceAddress]:
    """All live addresses for a named service, newest registration first.

    Reference parity: runtime_discovery.py:84 discover_runtime_service.
    """
    out = []
    for svc in sorted(registry.query(name, max_age_s=max_age_s),
                      key=lambda s: -s.get("time", 0)):
        svc_tags = svc.get("tags", {})
        if tags and any(svc_tags.get(k) != v for k, v in tags.items()):
            continue
        out.append(ServiceAddress(svc["ip"], svc["port"], svc["node_id"],
                                  svc_tags))
    return out


def discover_service_one(registry: ServiceRegistry, name: str,
                         **kw) -> Optional[ServiceAddress]:
    addrs = discover_service(registry, name, **kw)
    return addrs[0] if addrs else None


def wait_for_service(registry: ServiceRegistry, name: str,
                     timeout_s: float = 60.0,
                     poll_s: float = 1.0) -> ServiceAddress:
    deadline = time.time() + timeout_s
    while True:
        addr = discover_service_one(registry, name)
        if addr is not None:
            return addr
        if time.time() > deadline:
            raise TimeoutError(f"service {name!r} not discovered "
                               f"within {timeout_s}s")
        time.sleep(poll_s)


# -- config-bootstrap helpers (reference runtime_discovery.py:142-171 made
#    generic: one helper instead of a dozen discover_<service>() clones) ---

def discover_endpoint_for_config(
        cluster_config: Dict[str, Any], runtime_name: str, service: str,
        registry_factory: Callable[[], Optional[ServiceRegistry]],
        default_port: int) -> Optional[Dict[str, Any]]:
    """Resolve `service` for `runtime_name`'s config: explicit config wins
    (DiscoveryType.CONFIG), else the cluster registry (CLUSTER)."""
    rt_cfg = (cluster_config.get("runtime", {})
              .get(runtime_name, {}))
    explicit = rt_cfg.get(f"{service}_endpoint")
    if explicit:
        host, _, port = explicit.partition(":")
        return {"host": host, "port": int(port or default_port),
                "discovery": DiscoveryType.CONFIG.value}
    registry = registry_factory()
    if registry is None:
        return None
    addr = discover_service_one(registry, service)
    if addr is None:
        return None
    return {"host": addr.host, "port": addr.port,
            "discovery": DiscoveryType.CLUSTER.value}
