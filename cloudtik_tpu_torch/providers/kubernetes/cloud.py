"""Cloud glue for Kubernetes clusters on EKS / GKE / AKS.

Reference parity: providers/_private/_kubernetes/{aws_eks,gcp_gke,
azure_aks} — the reference wires pods to cloud storage/identity per
managed-Kubernetes flavor.  The modern mechanism on all three clouds is
workload identity (pod service account -> cloud IAM principal), so this
module renders:

* a ServiceAccount manifest carrying the flavor's identity annotation
  (EKS IRSA role ARN, GKE Workload Identity GSA, AKS client id),
* pod-spec glue: serviceAccountName, identity labels, and the cloud
  environment pods need (project/region/storage URI) — consumed by the
  mount runtime's FUSE mounts and the AI data path.

Config shape (provider.cloud in the cluster YAML):
    cloud:
      type: aws | gcp | azure
      region: ...
      aws_role_arn: arn:aws:iam::...:role/...        (EKS)
      gcp_service_account: sa@project.iam.gserviceaccount.com  (GKE)
      azure_client_id: <uuid>                        (AKS)
      storage:
        uri: s3://bucket | gs://bucket | abfs://container@account
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

SERVICE_ACCOUNT_NAME = "tik-node"

_IDENTITY_ANNOTATIONS = {
    "aws": ("eks.amazonaws.com/role-arn", "aws_role_arn"),
    "gcp": ("iam.gke.io/gcp-service-account", "gcp_service_account"),
    "azure": ("azure.workload.identity/client-id", "azure_client_id"),
}


def validate_cloud_config(cloud: Dict[str, Any]) -> None:
    ctype = cloud.get("type")
    if ctype not in _IDENTITY_ANNOTATIONS:
        raise ValueError(
            f"unknown kubernetes cloud type {ctype!r}; "
            f"known: {sorted(_IDENTITY_ANNOTATIONS)}")
    _, key = _IDENTITY_ANNOTATIONS[ctype]
    if not cloud.get(key):
        raise ValueError(
            f"kubernetes cloud type {ctype!r} requires `{key}`")


def cloud_service_account_manifest(
        cloud: Dict[str, Any], namespace: str = "default",
        name: str = SERVICE_ACCOUNT_NAME) -> Dict[str, Any]:
    """ServiceAccount with the flavor's workload-identity annotation."""
    validate_cloud_config(cloud)
    annotation_key, config_key = _IDENTITY_ANNOTATIONS[cloud["type"]]
    return {
        "apiVersion": "v1",
        "kind": "ServiceAccount",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "annotations": {annotation_key: cloud[config_key]},
        },
    }


def cloud_pod_env(cloud: Dict[str, Any]) -> Dict[str, str]:
    """Environment pods need to reach cloud APIs + managed storage."""
    ctype = cloud.get("type")
    env: Dict[str, str] = {"TIK_CLOUD": ctype or ""}
    if cloud.get("region"):
        env["TIK_CLOUD_REGION"] = cloud["region"]
        if ctype == "aws":
            env["AWS_REGION"] = cloud["region"]
    if ctype == "gcp" and cloud.get("project_id"):
        env["GOOGLE_CLOUD_PROJECT"] = cloud["project_id"]
    if ctype == "azure" and cloud.get("azure_client_id"):
        env["AZURE_CLIENT_ID"] = cloud["azure_client_id"]
    storage = cloud.get("storage") or {}
    if storage.get("uri"):
        env["TIK_CLOUD_STORAGE_URI"] = storage["uri"]
    return env


def apply_cloud_glue(pod: Dict[str, Any],
                     cloud: Optional[Dict[str, Any]],
                     service_account: str = SERVICE_ACCOUNT_NAME
                     ) -> Dict[str, Any]:
    """Attach workload identity + cloud env to a pod manifest."""
    if not cloud:
        return pod
    validate_cloud_config(cloud)
    pod = copy.deepcopy(pod)
    spec = pod.setdefault("spec", {})
    spec.setdefault("serviceAccountName", service_account)
    if cloud["type"] == "azure":
        # AKS workload identity requires the opt-in pod label
        pod.setdefault("metadata", {}).setdefault("labels", {})[
            "azure.workload.identity/use"] = "true"
    env = cloud_pod_env(cloud)
    for container in spec.get("containers", []):
        existing = {e.get("name") for e in container.get("env", [])}
        container.setdefault("env", []).extend(
            {"name": k, "value": v} for k, v in sorted(env.items())
            if k not in existing)
    return pod
