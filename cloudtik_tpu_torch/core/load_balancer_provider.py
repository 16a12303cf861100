"""LoadBalancerProvider — managed cloud load-balancer abstraction.

Reference parity: core/load_balancer_provider.py:27 (list/get/create/update/
delete).  The `loadbalancer` runtime reconciles discovered services into
these objects.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class LoadBalancerScheme:
    INTERNET_FACING = "internet-facing"
    INTERNAL = "internal"


class LoadBalancerProtocol:
    TCP = "TCP"
    UDP = "UDP"
    HTTP = "HTTP"
    HTTPS = "HTTPS"


class LoadBalancerProvider:
    """One instance per (provider_config, workspace_name)."""

    def __init__(self, provider_config: Dict[str, Any], workspace_name: str):
        self.provider_config = provider_config
        self.workspace_name = workspace_name

    def support_multi_service_group(self) -> bool:
        """Whether one LB can route to multiple service groups."""
        return False

    def list(self) -> Dict[str, Dict[str, Any]]:
        """load balancer name -> info."""
        raise NotImplementedError

    def get(self, load_balancer_name: str) -> Optional[Dict[str, Any]]:
        return self.list().get(load_balancer_name)

    def create(self, load_balancer_config: Dict[str, Any]) -> None:
        raise NotImplementedError

    def update(
        self, load_balancer: Dict[str, Any], load_balancer_config: Dict[str, Any]
    ) -> None:
        raise NotImplementedError

    def delete(self, load_balancer: Dict[str, Any]) -> None:
        raise NotImplementedError

    @staticmethod
    def validate_config(provider_config: Dict[str, Any]) -> None:
        return None
