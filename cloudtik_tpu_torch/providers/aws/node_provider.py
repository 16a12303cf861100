"""AWS EC2 node provider.

Reference parity: providers/_private/aws/node_provider.py (SURVEY.md §2.2).
All request/response shaping lives in config.py (pure, tested); this class
holds the boto3 session (imported lazily — the control plane and tests run
without the SDK) and a small node cache refreshed per snapshot.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.core.node_provider import (
    NodeLaunchException, NodeProvider)
from cloudtik_tpu_torch.providers.aws.config import (
    build_run_instances_request, from_aws_tags, tag_filters_to_aws)


def _boto3():
    try:
        import boto3
        return boto3
    except ImportError as e:
        raise RuntimeError(
            "AWS provider requires boto3 (not installed in this "
            "environment)") from e


class AWSNodeProvider(NodeProvider):
    """provider_config keys: region, profile (optional), ec2_client
    (injectable for tests)."""

    CACHE_TTL_S = 10.0

    def __init__(self, provider_config: Dict[str, Any], cluster_name: str):
        super().__init__(provider_config, cluster_name)
        self._client = provider_config.get("ec2_client")
        self._lock = threading.RLock()
        # node id -> (instance dict, fetch time); entries expire after
        # CACHE_TTL_S so externally terminated instances are re-observed
        self._cache: Dict[str, Any] = {}

    @property
    def ec2(self):
        if self._client is None:
            boto3 = _boto3()
            session = boto3.session.Session(
                profile_name=self.provider_config.get("profile"),
                region_name=self.provider_config.get("region"))
            self._client = session.client("ec2")
        return self._client

    # -- snapshot ----------------------------------------------------------
    def _describe(self, tag_filters: Dict[str, str]
                  ) -> Dict[str, Dict[str, Any]]:
        filters = tag_filters_to_aws(tag_filters, self.cluster_name)
        out: Dict[str, Dict[str, Any]] = {}
        paginator = self.ec2.get_paginator("describe_instances")
        for page in paginator.paginate(Filters=filters):
            for res in page.get("Reservations", []):
                for inst in res.get("Instances", []):
                    out[inst["InstanceId"]] = inst
        now = time.time()
        with self._lock:
            for iid, inst in out.items():
                self._cache[iid] = (inst, now)
        return out

    def _instance(self, node_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            entry = self._cache.get(node_id)
        if entry is not None and \
                time.time() - entry[1] < self.CACHE_TTL_S:
            return entry[0]
        resp = self.ec2.describe_instances(InstanceIds=[node_id])
        for res in resp.get("Reservations", []):
            for inst in res.get("Instances", []):
                with self._lock:
                    self._cache[inst["InstanceId"]] = (inst, time.time())
                return inst
        with self._lock:
            self._cache.pop(node_id, None)
        return None

    # -- queries -----------------------------------------------------------
    def non_terminated_nodes(self, tag_filters):
        return sorted(self._describe(tag_filters))

    def is_running(self, node_id):
        inst = self._instance(node_id)
        return bool(inst) and inst["State"]["Name"] == "running"

    def is_terminated(self, node_id):
        inst = self._instance(node_id)
        return not inst or inst["State"]["Name"] in (
            "terminated", "shutting-down", "stopped")

    def node_tags(self, node_id):
        inst = self._instance(node_id)
        return from_aws_tags(inst.get("Tags", [])) if inst else {}

    def internal_ip(self, node_id):
        inst = self._instance(node_id)
        return inst.get("PrivateIpAddress") if inst else None

    def external_ip(self, node_id):
        inst = self._instance(node_id)
        return inst.get("PublicIpAddress") if inst else None

    # -- mutation ----------------------------------------------------------
    def create_node(self, node_config, tags, count):
        req = build_run_instances_request(node_config, tags, count)
        try:
            resp = self.ec2.run_instances(**req)
        except Exception as e:
            category = "quota" if "InstanceLimitExceeded" in str(e) else \
                "stockout" if "InsufficientInstanceCapacity" in str(e) \
                else "api"
            raise NodeLaunchException(category, str(e))
        created = {}
        now = time.time()
        for inst in resp.get("Instances", []):
            created[inst["InstanceId"]] = inst
            with self._lock:
                self._cache[inst["InstanceId"]] = (inst, now)
        return created

    def set_node_tags(self, node_id, tags):
        if not tags:
            return
        self.ec2.create_tags(
            Resources=[node_id],
            Tags=[{"Key": k, "Value": v}
                  for k, v in sorted(tags.items())])
        with self._lock:
            self._cache.pop(node_id, None)   # force re-describe

    def terminate_node(self, node_id):
        self.ec2.terminate_instances(InstanceIds=[node_id])
        with self._lock:
            self._cache.pop(node_id, None)
        return {node_id: "terminating"}

    @staticmethod
    def validate_config(provider_config: Dict[str, Any]) -> None:
        if not provider_config.get("region") and \
                not provider_config.get("ec2_client"):
            raise ValueError("aws provider requires `region`")
