"""The port's GCP provider against a fake REST cloud, beside the reference's.

`cloudtik_tpu_torch.providers.gcp` launches CPU VMs with the reference's
bodies and bootstraps, and H100 hosts: single A3 instances, or atomic
groups made by one `instances.bulkInsert` with `minCount == count` under a
compact placement policy.  The fake extends the reference's own fake cloud
(tests/test_gcp_provider.py) with bulk insert, resource policies and
operations; no network, no process.
"""

import json
import re
import uuid

import pytest

from cloudtik_tpu.providers.gcp import config as JC
from cloudtik_tpu.providers.gcp.node_provider import (
    GCPNodeProvider as JProvider)
from cloudtik_tpu.providers.gcp.rest import RestClient as JRest
from cloudtik_tpu_torch.core.node_provider import NodeLaunchException
from cloudtik_tpu_torch.core.tags import (
    TAG_CLUSTER_NAME, TAG_NODE_GROUP_ID, TAG_NODE_GROUP_SIZE,
    TAG_NODE_GROUP_WORKER_INDEX, TAG_NODE_KIND)
from cloudtik_tpu_torch.providers.gcp import config as TC
from cloudtik_tpu_torch.providers.gcp import gpu
from cloudtik_tpu_torch.providers.gcp.node_provider import (
    GCPNodeProvider as TProvider)
from cloudtik_tpu_torch.providers.gcp.rest import RestClient, RestResponse
from tests.test_gcp_provider import FakeGCP

ZONE = "us-central1-a"
WORKER_TAGS = {TAG_CLUSTER_NAME: "clusterA", TAG_NODE_KIND: "worker"}


class FakeGpuCloud(FakeGCP):
    """The reference's fake GCE plus bulkInsert, regional resource
    policies and operations.  `op_error` makes the next bulk insert end
    DONE with that error code after creating `op_error_partial` members;
    `policy_busy` refuses that many policy deletes with HTTP 400."""

    def __init__(self):
        super().__init__()
        self.policies = {}
        self.op_error = None
        self.op_error_partial = 0
        self.policy_busy = 0
        self.running_ops = False      # operations answer RUNNING first
        self.ops = {}

    def _op(self, kind, error=None):
        op = {"kind": "compute#operation", "name": f"op-{len(self.calls)}",
              "operationType": kind, "status": "DONE",
              "selfLink": f"https://compute.googleapis.com/compute/v1/"
                          f"projects/p/zones/z/operations/op-{len(self.calls)}"}
        if error:
            op["error"] = {"errors": [{"code": error, "message": "fake"}]}
        if self.running_ops:
            self.ops[op["name"]] = op
            return {**op, "status": "RUNNING", "error": None}
        return op

    def _route(self, method, url, body):
        path = url.split("?")[0]
        m = re.search(r"/operations/([^/]+)/wait$", path)
        if m:
            return RestResponse(200, self.ops.pop(m.group(1)))
        if path.endswith("/instances/bulkInsert"):
            names = list(body["perInstanceProperties"])
            assert body["count"] == body["minCount"] == str(len(names))
            props = body["instanceProperties"]
            for p in props.get("resourcePolicies", []):
                assert p in self.policies, f"policy {p} not created"
            error, self.op_error = self.op_error, None
            made = names[:self.op_error_partial] if error else names
            for name in made:
                super()._route("POST", re.sub(
                    r"/bulkInsert$", "", url), {**props, "name": name})
            return RestResponse(200, self._op("bulkInsert", error))
        m = re.search(r"/regions/([^/]+)/resourcePolicies(?:/([^/?]+))?$",
                      path)
        if m:
            name = m.group(2)
            if method == "POST":
                self.policies[body["name"]] = dict(body, region=m.group(1))
                return RestResponse(200, self._op("insert"))
            if method == "DELETE":
                if self.policy_busy:
                    self.policy_busy -= 1
                    return RestResponse(400, {"error": {
                        "message": "resourceInUseByAnotherResource"}})
                del self.policies[name]
                return RestResponse(200, self._op("delete"))
        resp = super()._route(method, url, body)
        if method == "POST" and re.search(r"/instances$", path):
            return RestResponse(200, self._op("insert", self.op_error))
        return resp


def _rest(fake, cls=RestClient):
    return cls(transport=fake.transport, token_provider=lambda: "t",
               sleep=lambda s: None)


@pytest.fixture()
def fake():
    return FakeGpuCloud()


@pytest.fixture()
def provider(fake):
    return TProvider({"type": "gcp", "project_id": "proj",
                      "availability_zone": ZONE, "_rest_client": _rest(fake)},
                     "clusterA")


def _gpu_config(**node_types):
    return {
        "cluster_name": "clusterA",
        "head_node_type": "head",
        "workspace_name": "ws",
        "available_node_types": {"head": {"node_config": {}}, **node_types},
        "provider": {"type": "gcp", "project_id": "p",
                     "availability_zone": ZONE},
    }


CPU_CONFIGS = {
    "defaults": _gpu_config(cpu={"node_config": {}}),
    "explicit": _gpu_config(cpu={"node_config": {
        "machineType": "n2-highmem-16",
        "disks": [{"boot": True, "initializeParams": {"diskSizeGb": "50"}}],
        "labels": {"team": "ml"}}}),
}


# ----------------------------------------------------------- the machines --

@pytest.mark.parametrize("machine,cards", [
    ("a3-highgpu-1g", 1), ("a3-highgpu-2g", 2), ("a3-highgpu-4g", 4),
    ("a3-highgpu-8g", 8), ("a3-megagpu-8g", 8),
    ("zones/us-central1-a/machineTypes/a3-highgpu-8g", 8)])
def test_machine_cards(machine, cards):
    assert gpu.machine_cards(machine) == cards
    assert gpu.machine_model(machine) == "NVIDIA H100 80GB HBM3"
    assert gpu.is_gpu_node_config({"machineType": machine})


@pytest.mark.parametrize("machine", ["a3-ultragpu-8g", "a2-highgpu-1g",
                                     "g2-standard-4"])
def test_unknown_gpu_machine_is_refused_not_guessed(machine):
    assert gpu.is_gpu_node_config({"machineType": machine})
    with pytest.raises(ValueError, match="unknown GPU machine type"):
        gpu.machine_cards(machine)


def test_cpu_machines_are_no_gpu_hosts():
    assert not gpu.is_gpu_node_config({"machineType": "n2-standard-8"})
    assert not gpu.is_gpu_node_config({})
    assert gpu.is_gpu_node_config({"machineType": "n1-standard-8",
                                   "guestAccelerators": [{}]})


# ------------------------------------------ equal to the reference on CPUs --

@pytest.mark.parametrize("name", sorted(CPU_CONFIGS))
def test_cpu_bootstrap_is_the_references(name):
    got = TC.bootstrap_gcp(CPU_CONFIGS[name])
    want = JC.bootstrap_gcp(CPU_CONFIGS[name])
    for key in ("available_node_types", "provider"):
        assert got[key] == want[key]
    assert set(got) - set(want) == {"head_start_commands",
                                    "worker_start_commands"}


@pytest.mark.parametrize("kind", ["head", "worker"])
@pytest.mark.parametrize("name", sorted(CPU_CONFIGS))
def test_cpu_vm_body_is_the_references(name, kind, monkeypatch):
    node_config = TC.bootstrap_gcp(CPU_CONFIGS[name])[
        "available_node_types"]["head" if kind == "head" else "cpu"][
        "node_config"]
    fixed = uuid.UUID(int=7)
    monkeypatch.setattr(uuid, "uuid4", lambda: fixed)
    bodies = []
    for cls, rest_cls in ((TProvider, RestClient), (JProvider, JRest)):
        fake = FakeGpuCloud()
        p = cls({"type": "gcp", "project_id": "proj",
                 "availability_zone": ZONE,
                 "_rest_client": _rest(fake, rest_cls)}, "clusterA")
        created = p.create_node(node_config, {**WORKER_TAGS,
                                              TAG_NODE_KIND: kind}, 1)
        assert list(created) == [f"gce/clustera-{kind}-{fixed.hex[:8]}"]
        (body,) = fake.instances.values()
        bodies.append(body)
        nodes = p.non_terminated_nodes({TAG_NODE_KIND: kind})
        assert [p.node_tags(n) for n in nodes] == [{**WORKER_TAGS,
                                                    TAG_NODE_KIND: kind}]
    assert bodies[0] == bodies[1]


# --------------------------------------------------- GPU node bootstrap ----

def test_gpu_bootstrap_fills_scheduling_image_and_resources():
    out = TC.bootstrap_gcp(_gpu_config(
        gpu={"node_config": {"machineType": "a3-highgpu-8g"}},
        mega={"node_config": {"machineType": "a3-megagpu-8g"},
              "preemptible": True}))
    nt = out["available_node_types"]
    conf = nt["gpu"]["node_config"]
    assert conf["scheduling"] == {"onHostMaintenance": "TERMINATE",
                                  "automaticRestart": True}
    assert conf["disks"][0]["initializeParams"]["sourceImage"] == \
        TC.DEFAULT_GPU_SOURCE_IMAGE
    assert conf["networkInterfaces"] == [
        {"subnetwork": "tik-ws-private-subnet"}]
    assert nt["gpu"]["resources"] == {
        "GPU": 8, "gpu_hosts": 1,
        "accelerator_type:NVIDIA-H100-80GB-HBM3": 1}
    assert nt["mega"]["node_config"]["scheduling"] == {
        "onHostMaintenance": "TERMINATE", "automaticRestart": False,
        "preemptible": True}
    # the head stays the reference's CPU VM
    assert nt["head"] == JC.bootstrap_gcp(_gpu_config())[
        "available_node_types"]["head"]


def test_gpu_bootstrap_keeps_what_the_user_wrote():
    out = TC.bootstrap_gcp({**_gpu_config(gpu={
        "node_config": {"machineType": "a3-ultragpu-8g",
                        "scheduling": {"automaticRestart": False}},
        "resources": {"GPU": 8, "accelerator_type:NVIDIA-H200": 1}}),
        "provider": {"type": "gcp", "project_id": "p", "zone": ZONE,
                     "gpu_source_image": "projects/me/global/images/mine"}})
    nt = out["available_node_types"]["gpu"]
    assert nt["resources"] == {"GPU": 8, "gpu_hosts": 1,
                               "accelerator_type:NVIDIA-H200": 1}
    assert nt["node_config"]["scheduling"] == {
        "automaticRestart": False, "onHostMaintenance": "TERMINATE"}
    assert nt["node_config"]["disks"][0]["initializeParams"][
        "sourceImage"] == "projects/me/global/images/mine"


@pytest.mark.parametrize("node_type,match", [
    ({"node_config": {"machineType": "a3-ultragpu-8g"}},
     "unknown GPU machine type"),
    ({"node_config": {"machineType": "a3-highgpu-8g",
                      "scheduling": {"onHostMaintenance": "MIGRATE"}}},
     "must be TERMINATE"),
    ({"node_config": {"acceleratorType": "v5p-16"}},
     re.escape(TC.REFERENCE_PROVIDER)),
])
def test_gpu_bootstrap_refuses(node_type, match):
    with pytest.raises(ValueError, match=match):
        TC.bootstrap_gcp(_gpu_config(gpu=node_type))


def test_gpu_head_is_refused_with_the_references_reason():
    config = _gpu_config()
    config["available_node_types"]["head"] = {
        "node_config": {"machineType": "a3-highgpu-8g"}}
    with pytest.raises(ValueError, match="cannot be the head: the head "
                       "runs the control plane on a CPU VM"):
        TC.bootstrap_gcp(config)


def test_start_commands_detect_the_hosts_resources():
    out = TC.bootstrap_gcp({**_gpu_config(), "worker_start_commands": [
        "tik node start --daemonize"]})
    assert out["worker_start_commands"] == [
        TC.NODE_RESOURCES_EXPORT + "tik node start --daemonize"]
    assert out["head_start_commands"] == []
    assert TC.bootstrap_gcp(out)["worker_start_commands"] == \
        out["worker_start_commands"]


# ------------------------------------------------------ single GPU hosts --

def test_create_single_gpu_host(provider, fake):
    node_config = TC.bootstrap_gcp(_gpu_config(gpu={"node_config": {
        "machineType": "a3-highgpu-8g"}}))["available_node_types"]["gpu"][
        "node_config"]
    created = provider.create_node(node_config, WORKER_TAGS, 2)
    assert len(created) == 2 and len(fake.instances) == 2
    for body in fake.instances.values():
        assert body["machineType"] == f"zones/{ZONE}/machineTypes/" \
            "a3-highgpu-8g"
        assert body["scheduling"]["onHostMaintenance"] == "TERMINATE"
    nodes = provider.non_terminated_nodes(WORKER_TAGS)
    assert sorted(created) == nodes
    assert provider.list_node_groups({}) == {}
    assert TAG_NODE_GROUP_ID not in provider.node_tags(nodes[0])


def test_single_gpu_host_stockout_is_categorized(provider, fake):
    fake.op_error = "ZONE_RESOURCE_POOL_EXHAUSTED"
    with pytest.raises(NodeLaunchException) as e:
        provider.create_node({"machineType": "a3-highgpu-8g"},
                             WORKER_TAGS, 1)
    assert e.value.category == "stockout"
    assert fake.instances == {}      # the fake made it; the launch removed it


# ----------------------------------------------------------- GPU groups ----

def test_group_is_one_bulk_insert_under_a_placement_policy(provider, fake):
    group_id = provider.create_node_group(
        {"machineType": "a3-megagpu-8g", "scheduling": {
            "onHostMaintenance": "TERMINATE"}}, dict(WORKER_TAGS), 2)
    assert group_id.startswith("gpu/")
    name = group_id[len("gpu/"):]
    posts = [u.split("?")[0] for m, u in fake.calls if m == "POST"]
    assert [u.rsplit("/", 2)[-1] for u in posts] == [
        "resourcePolicies", "bulkInsert"]
    assert fake.policies == {f"{name}-placement": {
        "name": f"{name}-placement", "region": "us-central1",
        "groupPlacementPolicy": {"collocation": "COLLOCATED",
                                 "vmCount": 2}}}
    assert sorted(fake.instances) == [f"{name}-0", f"{name}-1"]
    for body in fake.instances.values():
        assert body["machineType"] == "a3-megagpu-8g"
        assert body["resourcePolicies"] == [f"{name}-placement"]
    groups = provider.list_node_groups({})
    assert groups == {group_id: [f"gce/{name}-0", f"gce/{name}-1"]}
    for index, member in enumerate(groups[group_id]):
        assert provider.node_tags(member) == {
            **WORKER_TAGS, TAG_NODE_GROUP_ID: group_id,
            TAG_NODE_GROUP_WORKER_INDEX: str(index),
            TAG_NODE_GROUP_SIZE: "2"}
    # tags written to one member stay on it
    provider.set_node_tags(groups[group_id][1], {"tik-node-status": "x"})
    assert provider.node_tags(groups[group_id][1])["tik-node-status"] == "x"
    assert "tik-node-status" not in provider.node_tags(groups[group_id][0])
    assert provider.list_node_groups({TAG_NODE_KIND: "head"}) == {}


def test_operations_are_waited_on(provider, fake):
    fake.running_ops = True
    group_id = provider.create_node_group(
        {"machineType": "a3-highgpu-8g"}, dict(WORKER_TAGS), 2)
    waits = [u for m, u in fake.calls if u.endswith("/wait")]
    assert len(waits) == 2 and fake.ops == {}      # the policy, the insert
    assert len(provider.list_node_groups({})[group_id]) == 2
    fake.op_error = "ZONE_RESOURCE_POOL_EXHAUSTED_WITH_DETAILS"
    with pytest.raises(NodeLaunchException) as e:
        provider.create_node({"machineType": "a3-highgpu-8g"},
                             WORKER_TAGS, 1)
    assert e.value.category == "stockout" and fake.ops == {}


def test_an_operation_that_never_ends_fails_the_group(provider, fake,
                                                      monkeypatch):
    monkeypatch.setattr(gpu, "OPERATION_TIMEOUT_S", -1.0)
    fake.running_ops = True
    with pytest.raises(NodeLaunchException) as e:
        provider.create_node_group({"machineType": "a3-highgpu-8g"},
                                   dict(WORKER_TAGS), 2)
    assert e.value.category == "timeout"
    assert fake.instances == {} and fake.policies == {}


def test_one_host_group_needs_no_placement(provider, fake):
    group_id = provider.create_node_group(
        {"machineType": "a3-highgpu-8g"}, dict(WORKER_TAGS), 1)
    assert fake.policies == {}
    (body,) = fake.instances.values()
    assert "resourcePolicies" not in body
    assert list(provider.list_node_groups({})) == [group_id]


@pytest.mark.parametrize("how", ["group", "member"])
def test_terminate_removes_members_then_the_policy(provider, fake, how):
    group_id = provider.create_node_group(
        {"machineType": "a3-highgpu-8g"}, dict(WORKER_TAGS), 3)
    members = provider.list_node_groups({})[group_id]
    fake.calls.clear()
    if how == "group":
        provider.terminate_node_group(group_id)
    else:
        assert provider.terminate_node(members[1]) == {
            members[1]: {"group": group_id}}
    deletes = [u.rsplit("/", 2)[-2:] for m, u in fake.calls
               if m == "DELETE"]
    assert deletes == [["instances", m[len("gce/"):]] for m in members] + [
        ["resourcePolicies", group_id[len("gpu/"):] + "-placement"]]
    assert fake.instances == {} and fake.policies == {}
    assert provider.non_terminated_nodes({}) == []


def test_policy_still_in_use_is_deleted_at_the_next_snapshot(provider,
                                                             fake):
    group_id = provider.create_node_group(
        {"machineType": "a3-highgpu-8g"}, dict(WORKER_TAGS), 2)
    fake.policy_busy = 1
    provider.terminate_node_group(group_id)
    assert fake.instances == {} and len(fake.policies) == 1
    assert provider.non_terminated_nodes({}) == []
    assert fake.policies == {}


@pytest.mark.parametrize("failure,category", [
    ((403, "quota exceeded"), "quota"),
    ((400, "bad request"), "http-400"),
    ("ZONE_RESOURCE_POOL_EXHAUSTED", "stockout"),
    ("QUOTA_EXCEEDED", "quota"),
])
def test_failed_group_leaves_no_instance_and_no_policy(provider, fake,
                                                       failure, category):
    if isinstance(failure, tuple):
        real = fake._route

        def route(method, url, body):   # the bulk insert itself refused
            if url.endswith("/bulkInsert"):
                return RestResponse(failure[0], {"error": {
                    "message": failure[1]}})
            return real(method, url, body)
        fake._route = route
    else:                               # the operation ends in an error,
        fake.op_error = failure         # one member already made
        fake.op_error_partial = 1
    with pytest.raises(NodeLaunchException) as e:
        provider.create_node_group({"machineType": "a3-highgpu-8g"},
                                   dict(WORKER_TAGS), 2)
    assert e.value.category == category
    assert fake.instances == {} and fake.policies == {}
    assert provider.list_node_groups({}) == {}


def test_groups_are_gpu_hosts_only(provider):
    with pytest.raises(ValueError, match="no GPU machine type"):
        provider.create_node_group({"machineType": "n2-standard-8"},
                                   dict(WORKER_TAGS), 2)


def test_group_tags_ride_in_shared_metadata(provider, fake):
    group_id = provider.create_node_group(
        {"machineType": "a3-highgpu-8g",
         "metadata": {"items": [{"key": "startup-script", "value": "x"}]}},
        dict(WORKER_TAGS), 2)
    for body in fake.instances.values():
        items = {i["key"]: i["value"] for i in body["metadata"]["items"]}
        assert items["startup-script"] == "x"
        assert json.loads(items["tik-tags"]) == {
            **WORKER_TAGS, TAG_NODE_GROUP_ID: group_id,
            TAG_NODE_GROUP_SIZE: "2"}
        assert body["labels"] == {"tik-cluster": "clustera"}
