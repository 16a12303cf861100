"""GCP config bootstrap for GPU clusters: network, GPU-host defaults.

Counterpart of `cloudtik_tpu/providers/gcp/config.py` (`bootstrap_gcp`)
with a GPU branch in place of the TPU one.  The head stays a CPU VM that
runs only the control plane; GPU hosts (A3 machine types, gpu.py) are
worker node types, single hosts or atomic groups.  A GPU node type gets
  * `scheduling.onHostMaintenance: TERMINATE` (Compute Engine refuses a GPU
    VM that keeps the default live migration) and `automaticRestart`, or
    `preemptible` mapped as the TPU branch maps it;
  * a boot disk from an image family that carries the NVIDIA driver and
    CUDA 12.8 (`provider.gpu_source_image` overrides it; a node config's
    own `disks` win over both);
  * `resources` for the demand scheduler: `GPU` (cards per host),
    `gpu_hosts: 1` and `accelerator_type:<model>`, the keys the host's node
    agent advertises (utils/resource_spec.py).

TPU node types belong to the reference's provider and are refused here.

The node-side channel: a host's resources are detected ON the host, by
utils/resource_spec.py, because every worker the scaler launches shares
one environment.  Each head and worker start command is prefixed with
`NODE_RESOURCES_EXPORT`, which sets `TIK_NODE_RESOURCES` to what the
detection prints, and fails the command where the detection fails; the
reference's node agent takes its resources from that variable.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

from cloudtik_tpu_torch.providers.gcp import gpu
from cloudtik_tpu_torch.utils.resource_spec import accelerator_key

REFERENCE_PROVIDER = "cloudtik_tpu.providers.gcp.node_provider:GCPNodeProvider"

DEFAULT_SCOPES = ["https://www.googleapis.com/auth/cloud-platform"]

# Deep Learning VM image family with the NVIDIA 570 driver and CUDA 12.8,
# which torch 2.11+cu128 needs; families listed at
# https://cloud.google.com/deep-learning-vm/docs/images
DEFAULT_GPU_SOURCE_IMAGE = (
    "projects/deeplearning-platform-release/global/images/family/"
    "common-cu128-ubuntu-2204-nvidia-570")
# the image alone holds CUDA, cuDNN and the driver
DEFAULT_GPU_DISK_GB = "200"

NODE_RESOURCES_EXPORT = (
    'TIK_NODE_RESOURCES="$(${TIK_PYTHON:-python3} -m '
    'cloudtik_tpu_torch.utils.resource_spec)" && '
    'export TIK_NODE_RESOURCES && ')


def _is_tpu_type(node_config: Dict[str, Any]) -> bool:
    return ("acceleratorType" in node_config
            or "accelerator_type" in node_config)


def prepare_gcp(config: Dict[str, Any]) -> Dict[str, Any]:
    """Fill provider-level defaults before validation."""
    config = copy.deepcopy(config)
    provider = config.setdefault("provider", {})
    if provider.get("zone") and not provider.get("availability_zone"):
        provider["availability_zone"] = provider["zone"]
    if not provider.get("region") and provider.get("availability_zone"):
        provider["region"] = provider["availability_zone"].rsplit("-", 1)[0]
    return config


def with_node_resources(commands: List[str]) -> List[str]:
    """`commands`, each run with this host's detected resources."""
    return [c if c.startswith(NODE_RESOURCES_EXPORT)
            else NODE_RESOURCES_EXPORT + c for c in commands]


def bootstrap_gcp(config: Dict[str, Any]) -> Dict[str, Any]:
    """Bootstrap the node configs for launch: head must be a CPU VM, GPU
    node types get scheduling / image / resource defaults."""
    config = prepare_gcp(config)
    head_type = config.get("head_node_type")
    node_types = config.get("available_node_types", {})
    workspace = config.get("workspace_name", "default")
    image = config["provider"].get("gpu_source_image",
                                   DEFAULT_GPU_SOURCE_IMAGE)

    for type_name, node_type in node_types.items():
        node_config = node_type.setdefault("node_config", {})
        if _is_tpu_type(node_config):
            raise ValueError(
                f"node type {type_name!r} is a TPU slice; TPU clusters run "
                f"on the reference's provider ({REFERENCE_PROVIDER}), this "
                "one launches CPU VMs and GPU hosts")
        if gpu.is_gpu_node_config(node_config):
            if type_name == head_type:
                raise ValueError(
                    "GPU node type cannot be the head: the head runs the "
                    "control plane on a CPU VM; GPU hosts are worker node "
                    f"types (got head_node_type={type_name!r})")
            _bootstrap_gpu_node(node_type, node_config, image)
        _bootstrap_vm_node(node_config, workspace,
                           is_head=(type_name == head_type))
    for key in ("head_start_commands", "worker_start_commands"):
        config[key] = with_node_resources(config.get(key) or [])
    return config


def _bootstrap_gpu_node(node_type: Dict[str, Any],
                        node_config: Dict[str, Any], image: str) -> None:
    machine = node_config.get("machineType", "")
    resources = node_type.setdefault("resources", {})
    if "GPU" not in resources:
        resources["GPU"] = gpu.machine_cards(machine)   # unknown: refused
    resources.setdefault("gpu_hosts", 1)
    if gpu.machine_name(machine) in gpu.GPU_MACHINES:
        resources.setdefault(accelerator_key(gpu.machine_model(machine)), 1)
    scheduling = node_config.setdefault("scheduling", {})
    policy = scheduling.setdefault("onHostMaintenance", "TERMINATE")
    if policy != "TERMINATE":
        raise ValueError(
            f"GPU hosts cannot live-migrate: onHostMaintenance={policy!r} "
            f"on {gpu.machine_name(machine)!r} must be TERMINATE")
    if node_type.get("preemptible") or node_config.pop("preemptible", None):
        scheduling["preemptible"] = True
        scheduling["automaticRestart"] = False
    scheduling.setdefault("automaticRestart", True)
    if "disks" not in node_config:
        node_config["disks"] = [{
            "boot": True,
            "autoDelete": True,
            "initializeParams": {
                "sourceImage": image,
                "diskSizeGb": DEFAULT_GPU_DISK_GB,
            },
        }]


def _bootstrap_vm_node(node_config: Dict[str, Any], workspace: str,
                       is_head: bool) -> None:
    node_config.setdefault("machineType", "n2-standard-8")
    if "disks" not in node_config:
        node_config["disks"] = [{
            "boot": True,
            "autoDelete": True,
            "initializeParams": {
                "sourceImage": ("projects/ubuntu-os-cloud/global/images/"
                                "family/ubuntu-2204-lts"),
                "diskSizeGb": "100",
            },
        }]
    if "networkInterfaces" not in node_config:
        nic: Dict[str, Any] = {
            "subnetwork": _subnet_name(workspace, private=not is_head),
        }
        if is_head:
            nic["accessConfigs"] = [{"type": "ONE_TO_ONE_NAT",
                                     "name": "External NAT"}]
        node_config["networkInterfaces"] = [nic]
    node_config.setdefault("serviceAccounts", [{
        "email": "default",
        "scopes": DEFAULT_SCOPES,
    }])


def _subnet_name(workspace: str, private: bool) -> str:
    kind = "private" if private else "public"
    return f"tik-{workspace}-{kind}-subnet"
