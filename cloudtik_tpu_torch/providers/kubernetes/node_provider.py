"""Kubernetes node provider: pods as cluster nodes.

Reference parity: providers/_private/_kubernetes/node_provider.py
(SURVEY.md §2.2).  Manifest shaping lives in manifests.py (pure, tested);
this class wraps the kubernetes client (lazy import — control plane and
tests run without it; a fake core_api is injectable).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.core.node_provider import (
    NodeLaunchException, NodeProvider)
from cloudtik_tpu_torch.providers.kubernetes.manifests import (
    build_pod_manifest, label_selector, labels_to_tags, tags_to_labels)


def _kube_core_api():
    try:
        from kubernetes import client, config as kube_config
    except ImportError as e:
        raise RuntimeError(
            "kubernetes provider requires the kubernetes client "
            "(not installed in this environment)") from e
    try:
        kube_config.load_incluster_config()
    except Exception:
        kube_config.load_kube_config()
    return client.CoreV1Api()


class KubernetesNodeProvider(NodeProvider):
    """provider_config keys: namespace, core_api (injectable)."""

    def __init__(self, provider_config: Dict[str, Any], cluster_name: str):
        super().__init__(provider_config, cluster_name)
        self.namespace = provider_config.get("namespace", "default")
        self._api = provider_config.get("core_api")
        self._lock = threading.RLock()

    @property
    def api(self):
        if self._api is None:
            self._api = _kube_core_api()
        return self._api

    # -- helpers -----------------------------------------------------------
    def _pod(self, node_id: str):
        try:
            return self.api.read_namespaced_pod(node_id, self.namespace)
        except Exception:
            return None

    @staticmethod
    def _phase(pod) -> str:
        status = getattr(pod, "status", None) or pod.get("status", {})
        return getattr(status, "phase", None) or status.get("phase", "")

    @staticmethod
    def _meta(pod) -> Dict[str, Any]:
        meta = getattr(pod, "metadata", None)
        if meta is not None and not isinstance(meta, dict):
            return {"name": meta.name, "labels": meta.labels or {}}
        return pod.get("metadata", {})

    # -- queries -----------------------------------------------------------
    def non_terminated_nodes(self, tag_filters):
        selector = label_selector(tag_filters, self.cluster_name)
        pods = self.api.list_namespaced_pod(
            self.namespace, label_selector=selector)
        items = (pods.get("items", []) if isinstance(pods, dict)
                 else pods.items)
        out = []
        for pod in items:
            if self._phase(pod) in ("Pending", "Running"):
                out.append(self._meta(pod)["name"])
        return sorted(out)

    def is_running(self, node_id):
        pod = self._pod(node_id)
        return bool(pod) and self._phase(pod) == "Running"

    def is_terminated(self, node_id):
        pod = self._pod(node_id)
        return not pod or self._phase(pod) in ("Succeeded", "Failed")

    def node_tags(self, node_id):
        pod = self._pod(node_id)
        if not pod:
            return {}
        return labels_to_tags(self._meta(pod).get("labels", {}))

    def internal_ip(self, node_id):
        pod = self._pod(node_id)
        if not pod:
            return None
        status = getattr(pod, "status", None) or pod.get("status", {})
        return getattr(status, "pod_ip", None) or status.get("podIP")

    def external_ip(self, node_id):
        return None  # pods are reached via the cluster network

    # -- mutation ----------------------------------------------------------
    def create_node(self, node_config, tags, count):
        from cloudtik_tpu_torch.providers.kubernetes.cloud import apply_cloud_glue
        created = {}
        for _ in range(count):
            manifest = apply_cloud_glue(
                build_pod_manifest(
                    node_config, tags, self.cluster_name, self.namespace),
                self.provider_config.get("cloud"))
            try:
                pod = self.api.create_namespaced_pod(
                    self.namespace, manifest)
            except Exception as e:
                raise NodeLaunchException("api", str(e))
            created[self._meta(pod)["name"]] = manifest
        return created

    def set_node_tags(self, node_id, tags):
        patch = {"metadata": {"labels": tags_to_labels(tags)}}
        self.api.patch_namespaced_pod(node_id, self.namespace, patch)

    def terminate_node(self, node_id):
        try:
            self.api.delete_namespaced_pod(node_id, self.namespace)
        except Exception:
            return None
        return {node_id: "deleting"}

    # -- wiring ------------------------------------------------------------
    def get_command_executor(
        self, call_context, log_prefix, node_id, auth_config,
        cluster_name, process_runner=None, use_internal_ip=False,
        docker_config=None,
    ):
        """Pods are reached with kubectl exec/cp, not SSH (reference:
        kubernetes_command_executor.py:27)."""
        from cloudtik_tpu_torch.control.executor.kubernetes import (
            KubernetesCommandExecutor)

        return KubernetesCommandExecutor(
            call_context=call_context,
            node_id=node_id,
            namespace=self.namespace,
            container=self.provider_config.get("container"),
            process_runner=process_runner,
            log_prefix=log_prefix,
            kubectl=self.provider_config.get("kubectl", "kubectl"),
        )

    @staticmethod
    def validate_config(provider_config: Dict[str, Any]) -> None:
        cloud = provider_config.get("cloud")
        if cloud:
            from cloudtik_tpu_torch.providers.kubernetes.cloud import (
                validate_cloud_config)
            validate_cloud_config(cloud)
