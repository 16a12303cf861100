"""Compute Engine v1 client for ordinary VM nodes (head, CPU workers).

Reference parity: providers/_private/gcp/node.py `GCPCompute` (the COMPUTE
side of GCPNodeType); trimmed to the operations the control plane uses.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.providers.gcp.rest import GCPApiError, RestClient

COMPUTE_API = "https://compute.googleapis.com/compute/v1"


class ComputeClient:
    def __init__(self, project: str, zone: str,
                 rest: Optional[RestClient] = None):
        self.project = project
        self.zone = zone
        self.rest = rest or RestClient()

    def _zone_url(self, suffix: str) -> str:
        return (f"{COMPUTE_API}/projects/{self.project}/zones/{self.zone}"
                f"{suffix}")

    # -- instances -----------------------------------------------------------
    def list_instances(self,
                       label_filter: Optional[Dict[str, str]] = None
                       ) -> List[Dict[str, Any]]:
        from urllib.parse import quote
        params = []
        if label_filter:
            clauses = " AND ".join(
                f"(labels.{k} = {v})" for k, v in label_filter.items())
            params.append(f"filter={quote(clauses)}")
        out: List[Dict[str, Any]] = []
        token = None
        while True:
            page_params = params + (
                [f"pageToken={token}"] if token else [])
            url = self._zone_url("/instances")
            if page_params:
                url += "?" + "&".join(page_params)
            resp = self.rest.get(url)
            out.extend(resp.get("items", []))
            token = resp.get("nextPageToken")
            if not token:
                return out

    def get_instance(self, name: str) -> Optional[Dict[str, Any]]:
        try:
            return self.rest.get(self._zone_url(f"/instances/{name}"))
        except GCPApiError as e:
            if e.not_found:
                return None
            raise

    def insert_instance(self, body: Dict[str, Any]) -> Dict[str, Any]:
        return self.rest.post(self._zone_url("/instances"), body)

    def delete_instance(self, name: str) -> Dict[str, Any]:
        return self.rest.delete(self._zone_url(f"/instances/{name}"))

    def set_labels(self, name: str, labels: Dict[str, str],
                   fingerprint: str) -> Dict[str, Any]:
        return self.rest.post(
            self._zone_url(f"/instances/{name}/setLabels"),
            {"labels": labels, "labelFingerprint": fingerprint})

    def set_metadata(self, name: str,
                     metadata: Dict[str, Any]) -> Dict[str, Any]:
        return self.rest.post(
            self._zone_url(f"/instances/{name}/setMetadata"), metadata)

    def wait_for_instance(self, name: str, timeout: float = 600.0,
                          poll: float = 5.0) -> Dict[str, Any]:
        deadline = time.time() + timeout
        while True:
            inst = self.get_instance(name)
            status = (inst or {}).get("status")
            if status == "RUNNING":
                return inst
            if status in ("STOPPING", "TERMINATED", "SUSPENDED"):
                raise RuntimeError(f"instance {name} in state {status}")
            if time.time() > deadline:
                raise TimeoutError(
                    f"instance {name} not RUNNING after {timeout}s")
            time.sleep(poll)


def instance_ips(inst: Dict[str, Any]) -> Dict[str, Optional[str]]:
    nic = (inst.get("networkInterfaces") or [{}])[0]
    external = None
    for ac in nic.get("accessConfigs", []):
        if ac.get("natIP"):
            external = ac["natIP"]
    return {"internal_ip": nic.get("networkIP"), "external_ip": external}
