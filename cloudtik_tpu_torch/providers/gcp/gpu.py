"""Compute Engine GPU hosts: A3 machine types and atomic multi-host groups.

Counterpart of `cloudtik_tpu/providers/gcp/tpu.py`.  Where the reference
creates a TPU pod slice as one API object (a TPU node or a queued
resource), a group of H100 hosts here is N ordinary instances created by
ONE `instances.bulkInsert` with `minCount == count`: Compute Engine creates
all of them or none, and deletes the ones it made when it cannot make the
rest.  A multi-host group shares a compact placement policy (a
`resourcePolicies` object with `groupPlacementPolicy.collocation:
COLLOCATED`), so its hosts sit close on the data-centre network.

Fields as Google's published Compute Engine API v1 reference gives them:
  * instances.bulkInsert (BulkInsertInstanceResource): `count`,
    `minCount`, `perInstanceProperties` (keys are the instance names),
    `instanceProperties` (InstanceProperties: `machineType` is a machine
    type NAME there, not a URL; `resourcePolicies` are policy NAMES);
    https://cloud.google.com/compute/docs/reference/rest/v1/instances/bulkInsert
  * resourcePolicies.insert / delete (regional; ResourcePolicy
    `groupPlacementPolicy`: `collocation`, `vmCount`);
    https://cloud.google.com/compute/docs/reference/rest/v1/resourcePolicies
  * zone and region Operations: `status` PENDING / RUNNING / DONE, `error.
    errors[].code`, and `<selfLink>/wait`, which returns when the
    operation is DONE or about two minutes have passed;
    https://cloud.google.com/compute/docs/reference/rest/v1/zoneOperations/wait
  * A3 machine types and their attached H100 80GB cards:
    https://cloud.google.com/compute/docs/accelerator-optimized-machines
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.providers.gcp.compute import COMPUTE_API
from cloudtik_tpu_torch.providers.gcp.rest import RestClient

H100_80GB = "NVIDIA H100 80GB HBM3"

# machine type -> (cards, card model as the driver names it); the cards
# come with the machine type, no `guestAccelerators` is written for them
GPU_MACHINES = {
    "a3-highgpu-1g": (1, H100_80GB),
    "a3-highgpu-2g": (2, H100_80GB),
    "a3-highgpu-4g": (4, H100_80GB),
    "a3-highgpu-8g": (8, H100_80GB),
    "a3-megagpu-8g": (8, H100_80GB),
}
# accelerator-optimized families: a node type of one of these whose
# machine type is not in GPU_MACHINES must state its own `resources`
GPU_MACHINE_FAMILIES = ("a2-", "a3-", "a4-", "g2-")

# how long a launch waits for Compute Engine to make its hosts
OPERATION_TIMEOUT_S = 1800.0

# Operation error codes that mean "no capacity" and "no quota"
STOCKOUT_CODES = ("ZONE_RESOURCE_POOL_EXHAUSTED",
                  "ZONE_RESOURCE_POOL_EXHAUSTED_WITH_DETAILS",
                  "RESOURCE_POOL_EXHAUSTED")
QUOTA_CODES = ("QUOTA_EXCEEDED",)


def machine_name(machine_type: str) -> str:
    """'zones/z/machineTypes/a3-highgpu-8g' -> 'a3-highgpu-8g'."""
    return str(machine_type or "").rsplit("/", 1)[-1]


def is_gpu_node_config(node_config: Dict[str, Any]) -> bool:
    """A GPU host: an accelerator-optimized machine type, or cards
    attached by `guestAccelerators`."""
    name = machine_name(node_config.get("machineType", ""))
    return (name in GPU_MACHINES or name.startswith(GPU_MACHINE_FAMILIES)
            or bool(node_config.get("guestAccelerators")))


def machine_cards(machine_type: str) -> int:
    """Cards of a GPU machine type; an unknown one is refused, never
    guessed."""
    name = machine_name(machine_type)
    if name not in GPU_MACHINES:
        raise ValueError(
            f"unknown GPU machine type {name!r} (known: "
            f"{sorted(GPU_MACHINES)}); write the node type's `resources` "
            "(e.g. {GPU: 8}) to use it")
    return GPU_MACHINES[name][0]


def machine_model(machine_type: str) -> str:
    machine_cards(machine_type)
    return GPU_MACHINES[machine_name(machine_type)][1]


def launch_category(status: int) -> str:
    """The reference's launch-failure categories for an HTTP status."""
    return "stockout" if status == 429 else (
        "quota" if status == 403 else f"http-{status}")


class OperationError(Exception):
    """A Compute Engine operation that ended DONE with an error."""

    def __init__(self, operation: Dict[str, Any]):
        errors = (operation.get("error") or {}).get("errors") or [{}]
        self.code = errors[0].get("code", "")
        self.status = int(operation.get("httpErrorStatusCode") or 0)
        super().__init__(
            f"{operation.get('operationType', 'operation')} "
            f"{operation.get('name', '')}: {self.code}: "
            f"{errors[0].get('message', '')}")

    @property
    def category(self) -> str:
        if self.code in STOCKOUT_CODES:
            return "stockout"
        if self.code in QUOTA_CODES:
            return "quota"
        if self.status:
            return launch_category(self.status)
        return f"operation-{self.code.lower() or 'error'}"


class GpuGroupClient:
    """The REST calls of a GPU host group, one zone."""

    def __init__(self, project: str, zone: str,
                 rest: Optional[RestClient] = None):
        self.project = project
        self.zone = zone
        self.region = zone.rsplit("-", 1)[0]
        self.rest = rest or RestClient()

    def _zone_url(self, suffix: str) -> str:
        return (f"{COMPUTE_API}/projects/{self.project}/zones/{self.zone}"
                f"{suffix}")

    def _region_url(self, suffix: str) -> str:
        return (f"{COMPUTE_API}/projects/{self.project}/regions/"
                f"{self.region}{suffix}")

    def bulk_insert(self, names: List[str],
                    properties: Dict[str, Any]) -> Dict[str, Any]:
        """All of `names` or none: `minCount == count`."""
        count = str(len(names))
        return self.rest.post(self._zone_url("/instances/bulkInsert"), {
            "count": count,
            "minCount": count,
            "perInstanceProperties": {n: {"name": n} for n in names},
            "instanceProperties": properties,
        })

    def insert_placement_policy(self, name: str,
                                vm_count: int) -> Dict[str, Any]:
        return self.rest.post(self._region_url("/resourcePolicies"), {
            "name": name,
            "groupPlacementPolicy": {"collocation": "COLLOCATED",
                                     "vmCount": vm_count},
        })

    def delete_placement_policy(self, name: str) -> Dict[str, Any]:
        return self.rest.delete(self._region_url(f"/resourcePolicies/{name}"))

    def wait(self, operation: Dict[str, Any]) -> Dict[str, Any]:
        """Block until `operation` is DONE; raise OperationError if it
        ended with an error, TimeoutError if it is not DONE within
        OPERATION_TIMEOUT_S.  A response that is no operation (no
        `status`) counts as done."""
        deadline = time.time() + OPERATION_TIMEOUT_S
        op = operation or {}
        while op.get("status") not in (None, "DONE"):
            if time.time() > deadline:
                raise TimeoutError(
                    f"operation {op.get('name')} not DONE after "
                    f"{OPERATION_TIMEOUT_S}s")
            op = self.rest.post(f"{op['selfLink']}/wait", {})
        if op.get("error"):
            raise OperationError(op)
        return op
