"""Cluster DNS records from the node/services tables.

Reference parity: core/_private/service_discovery/naming.py:28-156 — node
FQDNs `{cluster}-{seq}.{workspace}.tik` and service names
`{service}.{cluster}.{workspace}.tik`, served by the dnsmasq/bind/coredns
runtimes off consul DNS upstream.  Here records are materialized straight
from the head state store.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from cloudtik_tpu_torch.runtimes.discovery.runtime import (
    DOMAIN_SUFFIX, node_fqdn, service_fqdn)


def cluster_dns_records(
        cluster: str, workspace: str,
        nodes: Dict[str, Dict[str, Any]],
        services: List[Dict[str, Any]]) -> List[Tuple[str, str]]:
    """Sorted (fqdn, ip) A-records for nodes + service instances."""
    records = []
    for node_id, info in nodes.items():
        ip = info.get("ip")
        seq = info.get("seq_id")
        if ip is None or seq is None:
            continue
        records.append((node_fqdn(cluster, workspace, seq), ip))
    for svc in services:
        records.append((service_fqdn(svc["name"], cluster, workspace),
                        svc["ip"]))
    return sorted(set(records))
