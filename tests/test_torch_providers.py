"""The other providers on the port: local hosts through Kubernetes.

The port holds a copy of each of the reference's other providers
(`tests/test_torch_copies.py` holds them verbatim): the `local` host
inventory, the on-premise machine pool with its simulator, GCP's
workspace, storage and database providers, AWS, Azure, Alibaba Cloud,
Huawei Cloud, and Kubernetes with its cloud glue and operator.  Here the
reference's own tests of them (`tests/test_providers.py`,
`test_workspace_providers.py`, `test_cloud_infra_providers.py`,
`test_kubernetes_cloud.py` and `test_kubernetes_executor_operator.py`)
run again on the copies, each module's source with `cloudtik_tpu` renamed
to `cloudtik_tpu_torch`, collected here under a `TestPort...` or
`test_port_...` name.

`tests/test_gcp_provider.py` imports the TPU module at its top, which the
port has no copy of (its counterpart is `providers/gcp/gpu.py`), so it is
not rerun: the port's GCP workspace provider is driven on its fake cloud
below, beside the service-account roles it grants.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

import pytest

from cloudtik_tpu.providers.gcp import config as JC
from cloudtik_tpu_torch.core.workspace_provider import Existence
from cloudtik_tpu_torch.providers.factory import create_workspace_provider
from cloudtik_tpu_torch.providers.gcp import config as TC
from cloudtik_tpu_torch.providers.gcp.rest import RestClient
from cloudtik_tpu_torch.providers.gcp.workspace_provider import (
    GCPWorkspaceProvider)
from tests.test_gcp_provider import FakeGCP
from tests.test_torch_control import PORT_MOCK, _load, _marked, _renamed

ROOT = Path(__file__).resolve().parents[1]
# the reference's provider test modules, each rerun whole
REFERENCE_TESTS = ("test_providers", "test_workspace_providers",
                   "test_cloud_infra_providers", "test_kubernetes_cloud",
                   "test_kubernetes_executor_operator")
# cases of those left out, with their reason: none
LEFT_OUT = {}
# the reference's test helpers the reruns may import, loaded renamed
HELPERS = {"tests.test_providers": "tests.test_providers_on_the_port",
           "tests.fake_infra": "tests.fake_infra_on_the_port",
           "tests.mock_infra": PORT_MOCK}


def _port_source(name):
    text = _renamed((ROOT / "tests" / f"{name}.py").read_text())
    for ref, port in HELPERS.items():
        text = re.sub(rf"\b{re.escape(ref)}\b", port, text)
    return text


for _ref, _port in HELPERS.items():
    if _port not in sys.modules:
        _name = _ref.split(".")[-1]
        _load(ROOT / "tests" / f"{_name}.py", _port, _port_source(_name))
ON_THE_PORT = {name: sys.modules.get(f"tests.{name}_on_the_port") or
               _load(ROOT / "tests" / f"{name}.py",
                     f"tests.{name}_on_the_port", _port_source(name))
               for name in REFERENCE_TESTS}

COLLECTED = {}
for _name, _module in ON_THE_PORT.items():
    _prefix = "".join(w.title() for w in _name[len("test_"):].split("_"))
    _marks = getattr(_module, "pytestmark", [])
    for _attr, _obj in list(vars(_module).items()):
        if _attr.startswith("Test") and isinstance(_obj, type):
            _as = f"TestPort{_prefix}{_attr[len('Test'):]}"
        elif _attr.startswith("test_") and callable(_obj):
            _as = f"test_port_{_name[len('test_'):]}_{_attr[len('test_'):]}"
        else:
            continue
        globals()[_as] = _marked(_obj, _marks)
        COLLECTED[_as] = _name
# the module-level fixture of those modules
gcp_cloud = ON_THE_PORT["test_cloud_infra_providers"].gcp_cloud


def test_every_reference_test_is_rerun():
    want = sum(1 for name in REFERENCE_TESTS for line in
               (ROOT / "tests" / f"{name}.py").read_text().splitlines()
               if re.match(r"\s*def test_", line))
    got = 0
    for attr in COLLECTED:
        obj = globals()[attr]
        got += sum(1 for k in vars(obj) if k.startswith("test_")) \
            if isinstance(obj, type) else 1
    assert (got, want - len(LEFT_OUT)) == (79, 79)


@pytest.mark.parametrize("name", REFERENCE_TESTS)
def test_the_reruns_import_the_ports_providers(name):
    source = _port_source(name)
    assert not re.findall(r"\bcloudtik_tpu\.[\w.]+", source)
    assert not re.findall(r"\btests\.(test_providers|fake_infra|mock_infra)"
                          r"\b(?!_on_the_port)", source)
    assert [k for k, v in COLLECTED.items() if v == name]
    loaded = {m.__name__ for m in vars(ON_THE_PORT[name]).values()
              if type(m).__name__ == "module"}
    assert not {m for m in loaded if m.split(".")[0] == "cloudtik_tpu"}


# --------------------------------------------------- GCP's workspace ---

def _workspace(fake, name="ws1"):
    rest = RestClient(transport=fake.transport, token_provider=lambda: "t")
    return GCPWorkspaceProvider(
        {"project_id": "proj", "region": "us-central2",
         "_rest_client": rest}, name)


def test_gcp_workspace_create_exists_delete_on_the_fake_cloud():
    """The reference's workspace cycle (test_gcp_provider.py's
    `test_workspace_create_delete_cycle`) on the port's copy: one VPC, a
    public and a private subnet, a router with NAT and two firewall rules,
    then nothing after the delete."""
    fake = FakeGCP()
    ws = _workspace(fake)
    assert ws.check_workspace_existence({}) == Existence.NOT_EXIST
    ws.create_workspace({})
    assert ws.check_workspace_existence({}) == Existence.COMPLETED
    assert set(fake.networks) == {"tik-ws1-vpc"}
    assert sorted(fake.subnets) == ["tik-ws1-private-subnet",
                                    "tik-ws1-public-subnet"]
    assert len(fake.firewalls) == 2
    assert fake.routers["tik-ws1-router"]["nats"]
    ws.create_workspace({})
    assert ws.check_workspace_existence({}) == Existence.COMPLETED
    ws.delete_workspace({})
    assert ws.check_workspace_existence({}) == Existence.NOT_EXIST
    assert not (fake.networks or fake.subnets or fake.routers
                or fake.firewalls)
    assert not [u for _, u in fake.calls if "tpu.googleapis.com" in u]


def test_gcp_workspace_is_the_factorys():
    assert type(create_workspace_provider(
        {"type": "gcp", "project_id": "proj", "region": "us-central2",
         "_rest_client": object()}, "ws1")) is GCPWorkspaceProvider


def test_gcp_service_account_roles_are_the_references_without_tpu():
    """The port's hosts are Compute Engine A3 VMs, which
    `roles/compute.admin` covers; it calls no TPU API."""
    assert "roles/tpu.admin" in JC.HEAD_SERVICE_ACCOUNT_ROLES
    assert TC.HEAD_SERVICE_ACCOUNT_ROLES == [
        r for r in JC.HEAD_SERVICE_ACCOUNT_ROLES if r != "roles/tpu.admin"]
    assert "roles/compute.admin" in TC.HEAD_SERVICE_ACCOUNT_ROLES
    assert TC.WORKER_SERVICE_ACCOUNT_ROLES == JC.WORKER_SERVICE_ACCOUNT_ROLES
    assert not [r for r in TC.HEAD_SERVICE_ACCOUNT_ROLES
                + TC.WORKER_SERVICE_ACCOUNT_ROLES if "tpu" in r]
