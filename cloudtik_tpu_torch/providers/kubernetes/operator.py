"""Kubernetes operator: TikCluster CRD -> reconciled pod clusters.

Reference parity: providers/kubernetes/cloudtik_operator/operator.py:31
(`CloudTikCluster` CRD, `main`:332 watch loop, `cloudtik-operator` console
script) + tools/kubernetes/operator manifests.  The operator polls
TikCluster custom resources and converges each one: a head pod plus
spec.workers worker pods (via KubernetesNodeProvider), status written back
onto the CR.  APIs are injectable so tests run the full reconcile against
fakes — the same transport-level mocking as the rest of the provider
suite.

Run in-cluster: `tik-operator` (scripts/cli.py entry) or
`python -m cloudtik_tpu_torch.providers.kubernetes.operator`.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.core.tags import (
    NODE_KIND_HEAD, NODE_KIND_WORKER, TAG_NODE_KIND)
from cloudtik_tpu_torch.providers.kubernetes.node_provider import (
    KubernetesNodeProvider)

logger = logging.getLogger(__name__)

CRD_GROUP = "tik.io"
CRD_VERSION = "v1"
CRD_PLURAL = "tikclusters"

# The CRD manifest `kubectl apply`d at install time (reference:
# tools/kubernetes/operator/cloudtik_crd.yaml).
TIK_CLUSTER_CRD: Dict[str, Any] = {
    "apiVersion": "apiextensions.k8s.io/v1",
    "kind": "CustomResourceDefinition",
    "metadata": {"name": f"{CRD_PLURAL}.{CRD_GROUP}"},
    "spec": {
        "group": CRD_GROUP,
        "scope": "Namespaced",
        "names": {"plural": CRD_PLURAL, "singular": "tikcluster",
                  "kind": "TikCluster", "shortNames": ["tikc"]},
        "versions": [{
            "name": CRD_VERSION,
            "served": True,
            "storage": True,
            "schema": {"openAPIV3Schema": {
                "type": "object",
                "properties": {
                    "spec": {
                        "type": "object",
                        "properties": {
                            "workers": {"type": "integer"},
                            "image": {"type": "string"},
                            "resources": {
                                "type": "object",
                                "x-kubernetes-preserve-unknown-fields":
                                    True},
                            "runtimes": {
                                "type": "array",
                                "items": {"type": "string"}},
                        },
                    },
                    "status": {
                        "type": "object",
                        "x-kubernetes-preserve-unknown-fields": True,
                    },
                },
            }},
            "subresources": {"status": {}},
        }],
    },
}


def cluster_config_from_cr(cr: Dict[str, Any]) -> Dict[str, Any]:
    """Map a TikCluster custom resource to a cluster config dict."""
    meta = cr.get("metadata", {})
    spec = cr.get("spec", {})
    node_config: Dict[str, Any] = {"image": spec.get("image", "tik:latest")}
    if spec.get("resources"):
        node_config["resources"] = spec["resources"]
    return {
        "cluster_name": meta.get("name", "tik"),
        "workspace_name": meta.get("namespace", "default"),
        "provider": {"type": "kubernetes",
                     "namespace": meta.get("namespace", "default")},
        "available_node_types": {
            "worker.default": {"node_config": node_config,
                               "min_workers": int(spec.get("workers", 0))},
        },
        "runtime": {"types": list(spec.get("runtimes", []))},
    }


class ClusterReconciler:
    """Converges one TikCluster CR: head pod + N worker pods."""

    def __init__(self, provider: KubernetesNodeProvider):
        self.provider = provider

    def reconcile(self, cr: Dict[str, Any]) -> Dict[str, Any]:
        config = cluster_config_from_cr(cr)
        node_config = config["available_node_types"]["worker.default"][
            "node_config"]
        want_workers = config["available_node_types"]["worker.default"][
            "min_workers"]

        heads = self.provider.non_terminated_nodes(
            {TAG_NODE_KIND: NODE_KIND_HEAD})
        if not heads:
            self.provider.create_node(
                node_config, {TAG_NODE_KIND: NODE_KIND_HEAD}, 1)
            heads = self.provider.non_terminated_nodes(
                {TAG_NODE_KIND: NODE_KIND_HEAD})

        workers = self.provider.non_terminated_nodes(
            {TAG_NODE_KIND: NODE_KIND_WORKER})
        if len(workers) < want_workers:
            self.provider.create_node(
                node_config, {TAG_NODE_KIND: NODE_KIND_WORKER},
                want_workers - len(workers))
        elif len(workers) > want_workers:
            for node_id in sorted(workers)[want_workers:]:
                self.provider.terminate_node(node_id)
        workers = self.provider.non_terminated_nodes(
            {TAG_NODE_KIND: NODE_KIND_WORKER})
        return {
            "head": heads[0] if heads else None,
            "workers": len(workers),
            "desiredWorkers": want_workers,
            "phase": ("Running"
                      if heads and len(workers) == want_workers
                      else "Reconciling"),
        }

    def teardown(self) -> None:
        for node_id in self.provider.non_terminated_nodes({}):
            self.provider.terminate_node(node_id)


class Operator:
    """Watch loop over TikCluster CRs (reference operator.py main:332).

    custom_api is injectable (kubernetes CustomObjectsApi-compatible:
    list_namespaced_custom_object / patch status); provider_factory maps a
    CR to a node provider (tests inject fakes for both).
    """

    def __init__(self, custom_api=None, namespace: str = "default",
                 provider_factory=None, interval_s: float = 5.0):
        self.custom_api = custom_api
        self.namespace = namespace
        self.interval_s = interval_s
        self.provider_factory = provider_factory or self._default_provider
        self._known: Dict[str, ClusterReconciler] = {}

    @staticmethod
    def _default_provider(cr: Dict[str, Any]) -> KubernetesNodeProvider:
        config = cluster_config_from_cr(cr)
        return KubernetesNodeProvider(
            config["provider"], config["cluster_name"])

    def _list_crs(self) -> List[Dict[str, Any]]:
        resp = self.custom_api.list_namespaced_custom_object(
            CRD_GROUP, CRD_VERSION, self.namespace, CRD_PLURAL)
        return list(resp.get("items", []))

    def run_once(self) -> Dict[str, Dict[str, Any]]:
        """One reconcile pass over all CRs; returns name -> status."""
        statuses: Dict[str, Dict[str, Any]] = {}
        seen = set()
        for cr in self._list_crs():
            name = cr["metadata"]["name"]
            seen.add(name)
            reconciler = self._known.get(name)
            if reconciler is None:
                reconciler = ClusterReconciler(self.provider_factory(cr))
                self._known[name] = reconciler
            try:
                status = reconciler.reconcile(cr)
            except Exception as e:
                logger.exception("reconcile %s failed", name)
                status = {"phase": "Error", "error": str(e)}
            statuses[name] = status
            try:
                self.custom_api.patch_namespaced_custom_object_status(
                    CRD_GROUP, CRD_VERSION, self.namespace, CRD_PLURAL,
                    name, {"status": status})
            except Exception:
                logger.warning("status patch failed for %s", name,
                               exc_info=True)
        # CRs deleted since the last pass: tear their pods down.
        for name in list(self._known):
            if name not in seen:
                self._known.pop(name).teardown()
        return statuses

    def run_forever(self) -> None:
        while True:
            try:
                self.run_once()
            except Exception:
                logger.exception("operator pass failed")
            time.sleep(self.interval_s)


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    from kubernetes import client, config as kube_config
    try:
        kube_config.load_incluster_config()
        import os
        namespace = open(
            "/var/run/secrets/kubernetes.io/serviceaccount/namespace"
        ).read().strip() if os.path.exists(
            "/var/run/secrets/kubernetes.io/serviceaccount/namespace"
        ) else "default"
    except Exception:
        kube_config.load_kube_config()
        namespace = "default"
    Operator(custom_api=client.CustomObjectsApi(),
             namespace=namespace).run_forever()


if __name__ == "__main__":
    main()
