"""GCP node provider: Compute VMs + GPU hosts, multi-host groups atomic.

Counterpart of `cloudtik_tpu/providers/gcp/node_provider.py` for GPU
clusters.  The reference's control plane loads it as an external class:

    provider:
      type: gcp
      module: "cloudtik_tpu_torch.providers.gcp.node_provider:GCPNodeProvider"
      project_id: ...
      availability_zone: ...

CPU VMs (the head, CPU workers) get the reference's instance bodies.  A
GPU host (an A3 machine type, gpu.py) is an ordinary instance too; a node
type declared `node_group: {atomic: true, group_size: N}` launches N of them
as ONE group: a compact placement policy and one `instances.bulkInsert`
with `minCount == count`, so Compute Engine makes all N or none, where the
reference makes a TPU pod slice.

Node id scheme:
    gce/<instance-name>     every VM, group members included
Group id = gpu/<group-name>; its members are the instances
<group-name>-<worker index>, and the placement policy is
<group-name>-placement.

Tags: full-fidelity tags live in instance metadata key `tik-tags` (JSON);
a group's members share theirs at creation, and each member's worker
index is read from its name.
"""

from __future__ import annotations

import json
import re
import threading
import uuid
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.core.node_provider import (
    NodeLaunchException, NodeProvider)
from cloudtik_tpu_torch.core.tags import (
    TAG_CLUSTER_NAME, TAG_NODE_GROUP_ID, TAG_NODE_GROUP_SIZE,
    TAG_NODE_GROUP_WORKER_INDEX, TAG_NODE_KIND)
from cloudtik_tpu_torch.providers.gcp import gpu
from cloudtik_tpu_torch.providers.gcp.compute import (
    ComputeClient, instance_ips)
from cloudtik_tpu_torch.providers.gcp.rest import GCPApiError, RestClient

TAGS_METADATA_KEY = "tik-tags"
GROUP_PREFIX = "gpu/"
PLACEMENT_SUFFIX = "-placement"


def _sanitize_label(value: str) -> str:
    """GCP labels: lowercase letters, digits, dash/underscore, <=63 chars."""
    return re.sub(r"[^a-z0-9_-]", "-", str(value).lower())[:63]


LAUNCH_ERRORS = (GCPApiError, gpu.OperationError, TimeoutError)


def _launch_error(error: Exception) -> NodeLaunchException:
    """NodeLaunchException with the reference's categories ("timeout"
    for an operation that never ended)."""
    if isinstance(error, gpu.OperationError):
        category = error.category
    elif isinstance(error, TimeoutError):
        category = "timeout"
    else:
        category = gpu.launch_category(error.status)
    return NodeLaunchException(category, str(error))


class GCPNodeProvider(NodeProvider):
    """provider_config: project_id, availability_zone (or zone), region,
    optional gpu_source_image, plus an injectable _rest_client for
    tests."""

    def __init__(self, provider_config: Dict[str, Any], cluster_name: str):
        super().__init__(provider_config, cluster_name)
        self.project = provider_config["project_id"]
        self.zone = (provider_config.get("availability_zone")
                     or provider_config.get("zone"))
        rest: Optional[RestClient] = provider_config.get("_rest_client")
        self.compute = ComputeClient(self.project, self.zone, rest=rest)
        self.groups = gpu.GpuGroupClient(self.project, self.zone, rest=rest)
        self._lock = threading.RLock()
        # Cache of cloud objects from the last non_terminated_nodes snapshot.
        self._cached_instances: Dict[str, Dict[str, Any]] = {}
        # placement policies whose delete was refused while their members
        # were still going away; retried at each snapshot
        self._pending_policies: set = set()

    # ---------------------------------------------------------------- tags --
    def _meta_tags(self, obj: Dict[str, Any]) -> Dict[str, str]:
        for item in (obj.get("metadata") or {}).get("items", []):
            if item.get("key") == TAGS_METADATA_KEY:
                return json.loads(item.get("value") or "{}")
        return {}

    def _belongs_to_cluster(self, obj: Dict[str, Any]) -> bool:
        return self._meta_tags(obj).get(TAG_CLUSTER_NAME) == self.cluster_name

    # ------------------------------------------------------------- queries --
    def _snapshot(self) -> None:
        instances = {}
        for inst in self.compute.list_instances():
            if inst.get("status") in ("STOPPING", "TERMINATED"):
                continue
            if self._belongs_to_cluster(inst):
                instances[f"gce/{inst['name']}"] = inst
        with self._lock:
            self._cached_instances = instances
        self._reap_policies()

    def non_terminated_nodes(self, tag_filters: Dict[str, str]) -> List[str]:
        self._snapshot()
        with self._lock:
            node_ids = list(self._cached_instances)
        return sorted(n for n in node_ids if self._tags_match(n, tag_filters))

    def _tags_match(self, node_id: str, tag_filters: Dict[str, str]) -> bool:
        tags = self.node_tags(node_id)
        return all(tags.get(k) == v for k, v in tag_filters.items())

    def _find(self, node_id: str) -> Optional[Dict[str, Any]]:
        """The instance behind `node_id`.  Cache misses fetch OUTSIDE the
        provider lock — a slow cloud call must not stall concurrent
        scaler/updater queries."""
        if not node_id.startswith("gce/"):
            raise ValueError(f"Bad node id {node_id!r}")
        with self._lock:
            inst = self._cached_instances.get(node_id)
        if inst is None:
            inst = self.compute.get_instance(node_id[len("gce/"):])
            if inst is not None:
                with self._lock:
                    self._cached_instances[node_id] = inst
        return inst

    def is_running(self, node_id: str) -> bool:
        inst = self._find(node_id)
        return inst is not None and inst.get("status") == "RUNNING"

    def is_terminated(self, node_id: str) -> bool:
        inst = self._find(node_id)
        if inst is None:
            return True
        return inst.get("status") not in ("RUNNING", "PROVISIONING",
                                          "STAGING")

    def node_tags(self, node_id: str) -> Dict[str, str]:
        inst = self._find(node_id)
        if inst is None:
            return {}
        tags = dict(self._meta_tags(inst))
        if tags.get(TAG_NODE_GROUP_ID, "").startswith(GROUP_PREFIX):
            tags[TAG_NODE_GROUP_WORKER_INDEX] = inst["name"].rsplit("-", 1)[1]
        return tags

    def external_ip(self, node_id: str) -> Optional[str]:
        inst = self._find(node_id)
        return instance_ips(inst)["external_ip"] if inst else None

    def internal_ip(self, node_id: str) -> Optional[str]:
        inst = self._find(node_id)
        return instance_ips(inst)["internal_ip"] if inst else None

    # ------------------------------------------------------------ mutation --
    def create_node(self, node_config: Dict[str, Any], tags: Dict[str, str],
                    count: int) -> Optional[Dict[str, Any]]:
        """`count` single VMs.  A GPU host's insert is waited on, so that
        a zone out of cards fails the launch here, leaving no instance."""
        is_gpu = gpu.is_gpu_node_config(node_config)
        created = {}
        for _ in range(count):
            name = self._vm_name(tags)
            body = self._instance_body(name, node_config, tags)
            try:
                op = self.compute.insert_instance(body)
                if is_gpu:
                    self.groups.wait(op)
            except LAUNCH_ERRORS as e:
                if is_gpu:
                    self._delete_instance(name)
                raise _launch_error(e) from None
            created[f"gce/{name}"] = {"name": name}
        return created

    def _vm_name(self, tags: Dict[str, str]) -> str:
        kind = tags.get("tik-node-kind", "node")
        return _sanitize_label(
            f"{self.cluster_name}-{kind}-{uuid.uuid4().hex[:8]}")

    def _instance_body(self, name: str, node_config: Dict[str, Any],
                       tags: Dict[str, str]) -> Dict[str, Any]:
        body = {k: v for k, v in node_config.items()
                if k not in ("metadata", "labels")}
        body["name"] = name
        machine = body.get("machineType", "n2-standard-8")
        if "/" not in machine:
            body["machineType"] = (
                f"zones/{self.zone}/machineTypes/{machine}")
        labels = dict(node_config.get("labels") or {})
        labels["tik-cluster"] = _sanitize_label(self.cluster_name)
        body["labels"] = labels
        items = list((node_config.get("metadata") or {}).get("items", []))
        items.append({"key": TAGS_METADATA_KEY, "value": json.dumps(tags)})
        body["metadata"] = {"items": items}
        return body

    def set_node_tags(self, node_id: str, tags: Dict[str, str]) -> None:
        if self._find(node_id) is None:
            raise ValueError(f"node {node_id} not found")
        # Re-fetch for a fresh metadata fingerprint (setMetadata is
        # compare-and-swap on it; a cached fingerprint 412s after any write).
        name = node_id[len("gce/"):]
        fresh = self.compute.get_instance(name)
        if fresh is None:
            raise ValueError(f"node {node_id} disappeared")
        merged = {**self._meta_tags(fresh), **tags}
        meta = fresh.get("metadata") or {}
        items = [i for i in meta.get("items", [])
                 if i.get("key") != TAGS_METADATA_KEY]
        items.append({"key": TAGS_METADATA_KEY, "value": json.dumps(merged)})
        self.compute.set_metadata(
            name, {"items": items, "fingerprint": meta.get("fingerprint")})
        with self._lock:
            # Invalidate: next read re-fetches the post-write fingerprint.
            self._cached_instances.pop(node_id, None)

    def terminate_node(self, node_id: str) -> Optional[Dict[str, Any]]:
        group_id = self.node_tags(node_id).get(TAG_NODE_GROUP_ID, "")
        if group_id.startswith(GROUP_PREFIX):
            # Terminating any group member terminates the group (atomic).
            self.terminate_node_group(group_id)
            return {node_id: {"group": group_id}}
        self._delete_instance(node_id[len("gce/"):])
        return {node_id: {}}

    def _delete_instance(self, name: str) -> None:
        try:
            self.compute.delete_instance(name)
        except GCPApiError as e:
            if not e.not_found:
                raise
        with self._lock:
            self._cached_instances.pop(f"gce/{name}", None)

    # --------------------------------------------------------- node groups --
    def supports_node_groups(self) -> bool:
        return True

    def create_node_group(self, node_config: Dict[str, Any],
                          tags: Dict[str, str], group_size: int,
                          ) -> Optional[str]:
        """`group_size` GPU hosts, all or none: a compact placement policy
        (for more than one host), then one bulk insert, both waited on.
        On any failure the policy and every member that exists are deleted
        and NodeLaunchException is raised."""
        if not gpu.is_gpu_node_config(node_config):
            raise ValueError(
                "node groups are GPU hosts; "
                f"{node_config.get('machineType')!r} is no GPU machine type")
        size = max(int(group_size), 1)
        name = _sanitize_label(
            f"{self.cluster_name}-gpu-{uuid.uuid4().hex[:8]}")[:50]
        group_id = GROUP_PREFIX + name
        members = [f"{name}-{i}" for i in range(size)]
        policy = name + PLACEMENT_SUFFIX if size > 1 else None
        full_tags = {**tags, TAG_NODE_GROUP_ID: group_id,
                     TAG_NODE_GROUP_SIZE: str(size)}
        full_tags.setdefault(TAG_NODE_KIND, "worker")
        properties = self._instance_body(name, node_config, full_tags)
        del properties["name"]
        properties["machineType"] = gpu.machine_name(
            properties["machineType"])
        if policy:
            properties["resourcePolicies"] = [policy]
        try:
            if policy:
                self.groups.wait(
                    self.groups.insert_placement_policy(policy, size))
            self.groups.wait(self.groups.bulk_insert(members, properties))
        except LAUNCH_ERRORS as e:
            self._remove_group(members, policy)
            raise _launch_error(e) from None
        return group_id

    def _remove_group(self, members: List[str],
                      policy: Optional[str]) -> None:
        for member in members:
            self._delete_instance(member)
        if policy:
            with self._lock:
                self._pending_policies.add(policy)
            self._reap_policies()

    def _reap_policies(self) -> None:
        """Delete the placement policies left by groups that are gone; one
        that is still in use (its members not yet deleted) waits for the
        next snapshot."""
        with self._lock:
            pending = sorted(self._pending_policies)
        for policy in pending:
            try:
                self.groups.delete_placement_policy(policy)
            except GCPApiError as e:
                if not e.not_found:
                    continue
            with self._lock:
                self._pending_policies.discard(policy)

    def terminate_node_group(self, group_id: str) -> None:
        """Members first, then the group's placement policy."""
        self._snapshot()
        members = self._groups().get(group_id, [])
        name = group_id[len(GROUP_PREFIX):]
        self._remove_group([m[len("gce/"):] for m in members],
                           name + PLACEMENT_SUFFIX)

    def _groups(self) -> Dict[str, List[str]]:
        """group id -> member node ids in worker-index order, from the
        last snapshot."""
        out: Dict[str, List[str]] = {}
        with self._lock:
            node_ids = list(self._cached_instances)
        for node_id in node_ids:
            tags = self.node_tags(node_id)
            group_id = tags.get(TAG_NODE_GROUP_ID, "")
            if group_id.startswith(GROUP_PREFIX):
                out.setdefault(group_id, []).append(node_id)
        for group_id, members in out.items():
            members.sort(key=lambda n: int(n.rsplit("-", 1)[1]))
        return out

    def list_node_groups(self, tag_filters: Dict[str, str]
                         ) -> Dict[str, List[str]]:
        self._snapshot()
        return {g: members for g, members in self._groups().items()
                if any(self._tags_match(m, tag_filters) for m in members)}

    # ------------------------------------------------------ config pipeline --
    @staticmethod
    def bootstrap_config(cluster_config: Dict[str, Any]) -> Dict[str, Any]:
        from cloudtik_tpu_torch.providers.gcp.config import bootstrap_gcp
        return bootstrap_gcp(cluster_config)

    @staticmethod
    def validate_config(provider_config: Dict[str, Any]) -> None:
        for key in ("project_id",):
            if not provider_config.get(key):
                raise ValueError(f"gcp provider requires {key!r}")
        if not (provider_config.get("availability_zone")
                or provider_config.get("zone")):
            raise ValueError("gcp provider requires availability_zone")
