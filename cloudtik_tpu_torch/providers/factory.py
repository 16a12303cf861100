"""Provider factory: provider type -> classes.

Reference parity: core/_private/provider_factory.py:119 (_NODE_PROVIDERS
registry, external-class loading _import_external:114).
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, Optional, Type

from cloudtik_tpu_torch.core.node_provider import NodeProvider
from cloudtik_tpu_torch.core.workspace_provider import WorkspaceProvider

_NODE_PROVIDERS: Dict[str, str] = {
    "virtual": "cloudtik_tpu_torch.providers.virtual.node_provider:VirtualNodeProvider",
    "gcp": "cloudtik_tpu_torch.providers.gcp.node_provider:GCPNodeProvider",
    "aws": "cloudtik_tpu_torch.providers.aws.node_provider:AWSNodeProvider",
    "azure": "cloudtik_tpu_torch.providers.azure.node_provider:AzureNodeProvider",
    "aliyun": "cloudtik_tpu_torch.providers.aliyun.node_provider:AliyunNodeProvider",
    "huaweicloud": "cloudtik_tpu_torch.providers.huaweicloud.node_provider:HuaweiCloudNodeProvider",
    "kubernetes": "cloudtik_tpu_torch.providers.kubernetes.node_provider:KubernetesNodeProvider",
    "local": "cloudtik_tpu_torch.providers.local.node_provider:LocalNodeProvider",
    "onpremise": "cloudtik_tpu_torch.providers.onpremise.node_provider:OnPremiseNodeProvider",
    "mock": "tests.mock_infra:MockProvider",
}

_WORKSPACE_PROVIDERS: Dict[str, str] = {
    "virtual": "cloudtik_tpu_torch.providers.virtual.workspace_provider:VirtualWorkspaceProvider",
    "gcp": "cloudtik_tpu_torch.providers.gcp.workspace_provider:GCPWorkspaceProvider",
    "aws": "cloudtik_tpu_torch.providers.aws.workspace_provider:AWSWorkspaceProvider",
    "azure": "cloudtik_tpu_torch.providers.azure.workspace_provider:AzureWorkspaceProvider",
    "aliyun": "cloudtik_tpu_torch.providers.aliyun.workspace_provider:AliyunWorkspaceProvider",
    "huaweicloud": "cloudtik_tpu_torch.providers.huaweicloud.workspace_provider:HuaweiCloudWorkspaceProvider",
}

_STORAGE_PROVIDERS: Dict[str, str] = {
    "gcp": "cloudtik_tpu_torch.providers.gcp.storage_provider:GCSStorageProvider",
    "aws": "cloudtik_tpu_torch.providers.aws.storage_provider:S3StorageProvider",
    "azure": "cloudtik_tpu_torch.providers.azure.storage_provider:AzureBlobStorageProvider",
    "aliyun": "cloudtik_tpu_torch.providers.aliyun.storage_provider:OSSStorageProvider",
    "huaweicloud": "cloudtik_tpu_torch.providers.huaweicloud.storage_provider:OBSStorageProvider",
}

_DATABASE_PROVIDERS: Dict[str, str] = {
    "gcp": "cloudtik_tpu_torch.providers.gcp.database_provider:CloudSQLDatabaseProvider",
    "aws": "cloudtik_tpu_torch.providers.aws.database_provider:RDSDatabaseProvider",
    "azure": "cloudtik_tpu_torch.providers.azure.database_provider:AzureDatabaseProvider",
    "aliyun": "cloudtik_tpu_torch.providers.aliyun.database_provider:AliyunDatabaseProvider",
    "huaweicloud": "cloudtik_tpu_torch.providers.huaweicloud.database_provider:HuaweiCloudDatabaseProvider",
}

_LOAD_BALANCER_PROVIDERS: Dict[str, str] = {
    "gcp": "cloudtik_tpu_torch.providers.gcp.load_balancer_provider:GCPLoadBalancerProvider",
    "aws": "cloudtik_tpu_torch.providers.aws.load_balancer_provider:AWSLoadBalancerProvider",
    "azure": "cloudtik_tpu_torch.providers.azure.load_balancer_provider:AzureLoadBalancerProvider",
    "aliyun": "cloudtik_tpu_torch.providers.aliyun.load_balancer_provider:AliyunLoadBalancerProvider",
    "huaweicloud": "cloudtik_tpu_torch.providers.huaweicloud.load_balancer_provider:HuaweiCloudLoadBalancerProvider",
}


def _load(spec: str):
    module_name, _, cls_name = spec.partition(":")
    return getattr(importlib.import_module(module_name), cls_name)


def register_node_provider(name: str, spec: str) -> None:
    _NODE_PROVIDERS[name] = spec


def get_node_provider_cls(provider_config: Dict[str, Any]) -> Type[NodeProvider]:
    # external providers: provider.module = "pkg.mod:Class"
    if provider_config.get("module"):
        return _load(provider_config["module"])
    ptype = provider_config.get("type")
    spec = _NODE_PROVIDERS.get(ptype)
    if spec is None:
        raise ValueError(
            f"Unknown provider type {ptype!r}; known: "
            f"{sorted(_NODE_PROVIDERS)}")
    return _load(spec)


def create_node_provider(provider_config: Dict[str, Any],
                         cluster_name: str) -> NodeProvider:
    return get_node_provider_cls(provider_config)(
        provider_config, cluster_name)


def get_workspace_provider_cls(
        provider_config: Dict[str, Any]) -> Type[WorkspaceProvider]:
    if provider_config.get("workspace_module"):
        return _load(provider_config["workspace_module"])
    ptype = provider_config.get("type")
    spec = _WORKSPACE_PROVIDERS.get(ptype)
    if spec is None:
        raise ValueError(
            f"No workspace provider for type {ptype!r}; known: "
            f"{sorted(_WORKSPACE_PROVIDERS)}")
    return _load(spec)


def create_workspace_provider(provider_config: Dict[str, Any],
                              workspace_name: str) -> WorkspaceProvider:
    return get_workspace_provider_cls(provider_config)(
        provider_config, workspace_name)


def _shared_infra_cls(registry: Dict[str, str], module_key: str,
                      provider_config: Dict[str, Any], kind: str):
    if provider_config.get(module_key):
        return _load(provider_config[module_key])
    ptype = provider_config.get("type")
    spec = registry.get(ptype)
    if spec is None:
        raise ValueError(
            f"No {kind} provider for type {ptype!r}; known: "
            f"{sorted(registry)}")
    return _load(spec)


def create_storage_provider(provider_config: Dict[str, Any],
                            workspace_name: str, storage_name: str):
    """Reference parity: core/storage_provider.py:10 + provider factory."""
    cls = _shared_infra_cls(_STORAGE_PROVIDERS, "storage_module",
                            provider_config, "storage")
    return cls(provider_config, workspace_name, storage_name)


def create_database_provider(provider_config: Dict[str, Any],
                             workspace_name: str, database_name: str):
    """Reference parity: core/database_provider.py:10 + provider factory."""
    cls = _shared_infra_cls(_DATABASE_PROVIDERS, "database_module",
                            provider_config, "database")
    return cls(provider_config, workspace_name, database_name)


def create_load_balancer_provider(provider_config: Dict[str, Any],
                                  workspace_name: str):
    """Reference parity: core/load_balancer_provider.py:27 + factory."""
    cls = _shared_infra_cls(_LOAD_BALANCER_PROVIDERS,
                            "load_balancer_module",
                            provider_config, "load balancer")
    return cls(provider_config, workspace_name)
