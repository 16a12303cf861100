"""Kubernetes manifest builders — pure functions, client-free.

Reference parity: providers/_private/_kubernetes (SURVEY.md §2.2 — pods as
nodes, 6,521 LoC; operator CRD).  Pod/label shaping is pure and tested;
only the thin kubernetes-client calls in node_provider.py need a cluster.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

LABEL_PREFIX = "tik.io/"


def tags_to_labels(tags: Dict[str, str]) -> Dict[str, str]:
    """tik tags -> pod labels (sanitized to the k8s label charset)."""
    out = {}
    for k, v in tags.items():
        key = LABEL_PREFIX + k.replace("tik-", "", 1)
        out[key] = "".join(
            c if (c.isalnum() or c in "-_.") else "-" for c in v)[:63]
    return out


def labels_to_tags(labels: Dict[str, str]) -> Dict[str, str]:
    out = {}
    for k, v in (labels or {}).items():
        if k.startswith(LABEL_PREFIX):
            out["tik-" + k[len(LABEL_PREFIX):]] = v
    return out


def label_selector(tag_filters: Dict[str, str],
                   cluster_name: str) -> str:
    parts = [f"{LABEL_PREFIX}cluster-name={cluster_name}"]
    for k, v in sorted(tags_to_labels(tag_filters).items()):
        parts.append(f"{k}={v}")
    return ",".join(parts)


def build_pod_manifest(
        node_config: Dict[str, Any], tags: Dict[str, str],
        cluster_name: str, namespace: str = "default") -> Dict[str, Any]:
    """node_config (cluster-YAML pod template) -> a full pod manifest with
    tik labels + defaulted container."""
    pod = copy.deepcopy(node_config.get("pod", {}))
    pod.setdefault("apiVersion", "v1")
    pod.setdefault("kind", "Pod")
    meta = pod.setdefault("metadata", {})
    meta.setdefault("namespace", namespace)
    meta.setdefault("generateName",
                    f"tik-{cluster_name}-"
                    f"{tags.get('tik-node-kind', 'node')}-")
    labels = meta.setdefault("labels", {})
    labels.update(tags_to_labels(dict(tags,
                                      **{"tik-cluster-name":
                                         cluster_name})))
    spec = pod.setdefault("spec", {})
    spec.setdefault("restartPolicy", "Never")
    containers = spec.setdefault("containers", [{}])
    c = containers[0]
    c.setdefault("name", "tik-node")
    c.setdefault("image", node_config.get("image", "python:3.11-slim"))
    c.setdefault("command", ["/bin/sh", "-c",
                             "sleep infinity"])
    resources = node_config.get("resources")
    if resources:
        c.setdefault("resources", {})
        c["resources"].setdefault("requests", dict(resources))
        c["resources"].setdefault("limits", dict(resources))
    return pod


def build_service_manifest(cluster_name: str, port: int,
                           namespace: str = "default") -> Dict[str, Any]:
    """Head service exposing the state-server port inside the cluster."""
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": f"tik-{cluster_name}-head",
            "namespace": namespace,
        },
        "spec": {
            "selector": {
                f"{LABEL_PREFIX}cluster-name": cluster_name,
                f"{LABEL_PREFIX}node-kind": "head",
            },
            "ports": [{"name": "state", "port": port,
                       "targetPort": port}],
        },
    }
