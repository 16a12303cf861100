"""H100 hosts as cluster workers, through the port's control plane.

`cloudtik_tpu_torch.utils.resource_spec` detects a host's cards without
the CUDA runtime and is held to the reference's detection where both do
the same thing (the override, CPU and memory).  Then the reverse of what
the reference does on GPU hosts: with the port's GCP provider given as
`provider.module`, the port's `ResourceDemandScheduler` and launcher
(copies of the reference's) turn one pending job of the port's
`AISliceScalingPolicy` into a GPU host (or an atomic group of two), the AI
runtime exports each member's slice env from the provider's tags, and the
port's `NodeAgent`, started through the bootstrapped start command,
advertises the host's cards.
Fakes only: a fake device root, a fake /proc and a fake REST cloud.
"""

import ast
import json
import queue
import sys

import pytest

from cloudtik_tpu.utils import resource_spec as JR
from cloudtik_tpu_torch.control import cluster_operator
from cloudtik_tpu_torch.control.demand import ResourceDemandScheduler
from cloudtik_tpu_torch.control.launcher import NodeLauncher, PendingLaunches
from cloudtik_tpu_torch.control.node_agent import NodeAgent
from cloudtik_tpu_torch.core.node_provider import NodeLaunchException
from cloudtik_tpu_torch.core.tags import TAG_NODE_GROUP_ID
from cloudtik_tpu_torch.providers.gcp import config as TC
from cloudtik_tpu_torch.providers.gcp.node_provider import GCPNodeProvider
from cloudtik_tpu_torch.providers.gcp.rest import RestClient
from cloudtik_tpu_torch.providers.factory import create_node_provider
from cloudtik_tpu_torch.runtimes.ai import runtime as TA
from cloudtik_tpu_torch.runtimes.ai import scaling as TS
from cloudtik_tpu_torch.utils import resource_spec as R
from tests.test_torch_chip_smoke import _fake_host
from tests.test_torch_gcp_gpu_provider import FakeGpuCloud

MODULE = "cloudtik_tpu_torch.providers.gcp.node_provider:GCPNodeProvider"
H100 = "accelerator_type:NVIDIA-H100-80GB-HBM3"


@pytest.fixture()
def host8(tmp_path):
    return _fake_host(tmp_path, 8)


def _no_nvml(monkeypatch):
    def refuse():
        raise AssertionError("NVML asked on a fake root")
    monkeypatch.setattr(R, "nvml_model", refuse)


# --------------------------------------------- equal to the reference -------

@pytest.mark.parametrize("override", [
    '{"CPU": 4, "GPU": 8, "custom": 2}', '{"TPU": "4"}', "{}"])
def test_override_is_parsed_as_the_reference_parses_it(override, host8):
    env = {"TIK_NODE_RESOURCES": override}
    got = R.detect_node_resources(host8[0], env, host8[1])
    assert got == JR.detect_node_resources(host8[0], env)
    if override != "{}":
        assert got == {k: float(v) for k, v in json.loads(override).items()}


@pytest.mark.parametrize("override", ["{bad", "[1, 2]", '"str"',
                                      '{"GPU": "x"}'])
def test_malformed_override_falls_back_to_detection(override, tmp_path):
    env = {"TIK_NODE_RESOURCES": override}
    got = R.detect_node_resources(str(tmp_path), env, str(tmp_path))
    assert got == JR.detect_node_resources(str(tmp_path), env)
    assert sorted(got) == ["CPU", "memory"]


def test_cpu_and_memory_are_the_references_on_a_plain_host(tmp_path):
    got = R.detect_node_resources(str(tmp_path), {}, str(tmp_path))
    assert got == JR.detect_node_resources(str(tmp_path), {})
    assert got["CPU"] >= 1 and got["memory"] > 0


def test_the_reference_sees_no_card_the_port_sees_eight(host8,
                                                        monkeypatch):
    _no_nvml(monkeypatch)
    want = JR.detect_node_resources(host8[0], {})
    got = R.detect_node_resources(host8[0], {}, host8[1])
    assert sorted(want) == ["CPU", "memory"]
    assert got == {**want, "GPU": 8.0, H100: 1.0}


# ------------------------------------------------------- card counting -----

@pytest.mark.parametrize("env,cards", [
    ({}, 8),
    ({"CUDA_VISIBLE_DEVICES": "0,1,2,3"}, 4),
    ({"CUDA_VISIBLE_DEVICES": ""}, 0),
    ({"CUDA_VISIBLE_DEVICES": "-1"}, 0),
    ({"CUDA_VISIBLE_DEVICES": " NoNe "}, 0),
    ({"CUDA_VISIBLE_DEVICES": "void"}, 0),
    ({"CUDA_VISIBLE_DEVICES": "all"}, 8),
    ({"CUDA_VISIBLE_DEVICES": "0,1,9,2"}, 2),      # ends at the first gap
    ({"CUDA_VISIBLE_DEVICES": "3,3"}, 1),
    ({"CUDA_VISIBLE_DEVICES": "GPU-00000003,GPU-00000005"}, 2),
    ({"CUDA_VISIBLE_DEVICES": "GPU-0000000"}, 1),   # a UUID prefix
    ({"CUDA_VISIBLE_DEVICES": "GPU-ffffffff,GPU-00000001"}, 0),
    ({"CUDA_VISIBLE_DEVICES": "MIG-4a1b"}, 1),
    ({"NVIDIA_VISIBLE_DEVICES": "all"}, 8),
    ({"NVIDIA_VISIBLE_DEVICES": "void"}, 0),
    ({"NVIDIA_VISIBLE_DEVICES": "2,6"}, 2),
    ({"NVIDIA_VISIBLE_DEVICES": "all", "CUDA_VISIBLE_DEVICES": "1"}, 1),
    ({"TPU_CHIPS_PER_HOST_BOUNDS": "2,2,1"}, 8),
])
def test_cards_on_an_eight_card_host(env, cards, host8, monkeypatch):
    _no_nvml(monkeypatch)
    assert R.detect_gpu_cards(host8[0], env, host8[1]) == cards
    res = R.detect_node_resources(host8[0], env, host8[1])
    if cards:
        assert res["GPU"] == cards and res[H100] == 1.0
    else:
        assert sorted(res) == ["CPU", "memory"]


def test_a_container_shows_only_its_cards_node(tmp_path, monkeypatch):
    """The container runtime mounts the listed card's node alone and names
    it by its host index; CUDA inside sees it as ordinal 0."""
    _no_nvml(monkeypatch)
    dev, proc = _fake_host(tmp_path, 0)
    (tmp_path / "dev" / "nvidia3").touch()
    assert R.detect_gpu_cards(dev, {"NVIDIA_VISIBLE_DEVICES": "3"},
                              proc) == 1
    assert R.detect_gpu_cards(dev, {"NVIDIA_VISIBLE_DEVICES": "0"},
                              proc) == 0
    assert R.detect_gpu_cards(dev, {"CUDA_VISIBLE_DEVICES": "0"}, proc) == 1
    assert R.detect_gpu_cards(dev, {"CUDA_VISIBLE_DEVICES": "1"}, proc) == 0
    # no /proc description: the count stands, no model is guessed
    res = R.detect_node_resources(dev, {}, proc)
    assert res["GPU"] == 1.0 and not any(
        k.startswith("accelerator_type:") for k in res)


def test_no_device_node_means_no_card_whatever_the_env_says(tmp_path):
    dev, proc = _fake_host(tmp_path, 0)
    for env in ({}, {"CUDA_VISIBLE_DEVICES": "0,1"},
                {"NVIDIA_VISIBLE_DEVICES": "all"}):
        assert R.detect_gpu_cards(dev, env, proc) == 0


def test_model_of_the_visible_cards(tmp_path, monkeypatch):
    _no_nvml(monkeypatch)
    dev, proc = _fake_host(tmp_path, 2, model="NVIDIA H100 PCIe")
    assert R.gpu_model(proc) == "NVIDIA H100 PCIe"
    assert R.gpu_model(proc, [1]) == "NVIDIA H100 PCIe"
    assert R.gpu_model(proc, [5]) is None
    assert R.accelerator_key(" NVIDIA H100 (80GB) ") == \
        "accelerator_type:NVIDIA-H100-80GB"


def test_nvml_is_asked_only_for_the_live_proc(tmp_path, monkeypatch):
    monkeypatch.setattr(R, "driver_cards", lambda proc_root: {})
    monkeypatch.setattr(R, "nvml_model", lambda: "NVIDIA H100 80GB HBM3")
    assert R.gpu_model("/proc") == "NVIDIA H100 80GB HBM3"
    assert R.gpu_model(str(tmp_path)) is None


def test_command_prints_the_override_json(host8, capsys, monkeypatch):
    _no_nvml(monkeypatch)
    for name in ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES",
                 "TIK_NODE_RESOURCES"):
        monkeypatch.delenv(name, raising=False)
    assert R.main(["--dev-root", host8[0], "--proc-root", host8[1]]) == 0
    printed = capsys.readouterr().out
    assert json.loads(printed) == R.detect_node_resources(*host8[:1], None,
                                                          host8[1])
    # fed back as the override, it is read back unchanged
    assert R.detect_node_resources(
        "/nonexistent", {"TIK_NODE_RESOURCES": printed}) == json.loads(printed)


def test_detection_imports_neither_torch_nor_the_reference():
    tree = ast.parse(open(R.__file__).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "argparse", "ctypes", "glob", "json",
                     "os", "re", "typing"} - {""}, names
    assert set(sys.stdlib_module_names) >= names - {"__future__"}


# --------------------------- the port's control plane on GPU hosts ------

CONFIGS = {
    "single": ({"gpu": {"node_config": {"machineType": "a3-highgpu-8g"},
                        "max_workers": 4}}, {"gpu": 1}),
    "mega": ({"mega": {"node_config": {"machineType": "a3-megagpu-8g"},
                       "max_workers": 4}}, {"mega": 1}),
    "group": ({"pair": {"node_config": {"machineType": "a3-megagpu-8g"},
                        "max_workers": 4,
                        "node_group": {"atomic": True, "group_size": 2}}},
              {"pair": 2}),
}


class FakeState:
    def __init__(self, jobs):
        self.jobs = jobs

    def table_list(self, table):
        assert table == "ai_jobs"
        return self.jobs


def _cluster(node_types, module=MODULE):
    provider = {"type": "gcp", "project_id": "p",
                "availability_zone": "us-central1-a"}
    if module:
        provider["module"] = module
    return {"cluster_name": "gpus", "max_workers": 8,
            "head_node_type": "head", "workspace_name": "ws",
            "provider": provider,
            "worker_start_commands": ["tik node start --daemonize"],
            "available_node_types": {
                "head": {"node_config": {"machineType": "n2-standard-8"}},
                **node_types}}


def _pending_demands(config, jobs=1):
    policy = TS.AISliceScalingPolicy(
        config, "head", {"enabled": True}, state_client=FakeState(
            {f"j{i}": {"status": "pending"} for i in range(jobs)}))
    return policy.get_scaling_state().autoscaling_instructions[
        "resource_demands"]


def _to_launch(config, demands):
    return ResourceDemandScheduler(
        config["available_node_types"], config["max_workers"],
        config["head_node_type"]).get_nodes_to_launch({}, {}, demands, [])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_a_pending_job_launches_gpu_hosts(name):
    node_types, want = CONFIGS[name]
    config = cluster_operator.bootstrap_config(_cluster(node_types))
    demands = _pending_demands(config)
    assert demands == [{"GPU": 8}]
    assert _to_launch(config, demands) == want
    # the reference's own provider, loaded by the port's factory as an
    # external provider, on the same config launches nothing
    ref = cluster_operator.bootstrap_config(
        _cluster(node_types, TC.REFERENCE_PROVIDER))
    assert _to_launch(ref, _pending_demands(ref)) == {}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_reference_launcher_creates_them(name):
    node_types, want = CONFIGS[name]
    config = cluster_operator.bootstrap_config(_cluster(node_types))
    fake = FakeGpuCloud()
    rest = RestClient(transport=fake.transport, token_provider=lambda: "t",
                      sleep=lambda s: None)
    provider = create_node_provider(
        dict(config["provider"], _rest_client=rest), config["cluster_name"])
    assert isinstance(provider, GCPNodeProvider)
    (node_type, count), = _to_launch(config, _pending_demands(config)).items()
    NodeLauncher(provider, config["cluster_name"], config, queue.Queue(),
                 PendingLaunches(), {}).launch(node_type, count)
    nodes = provider.non_terminated_nodes({})
    assert len(nodes) == len(fake.instances) == count
    bulk = [u for m, u in fake.calls if u.endswith("/bulkInsert")]
    groups = provider.list_node_groups({})
    runtime = TA.AIRuntime({})
    if name != "group":
        assert bulk == [] and groups == {}
        env = runtime.with_environment_variables(config, provider, nodes[0])
        assert "TIK_SLICE_ID" not in env
        return
    assert len(bulk) == 1 and len(groups) == 1
    (group_id, members), = groups.items()
    assert sorted(members) == nodes
    for index, member in enumerate(members):
        env = runtime.with_environment_variables(config, provider, member)
        assert env["TIK_SLICE_ID"] == group_id
        assert env["TIK_SLICE_WORKER_INDEX"] == str(index)
        assert provider.node_tags(member)[TAG_NODE_GROUP_ID] == group_id


def test_a_failed_group_reaches_the_reference_launcher_whole():
    node_types, _ = CONFIGS["group"]
    config = cluster_operator.bootstrap_config(_cluster(node_types))
    fake = FakeGpuCloud()
    fake.op_error, fake.op_error_partial = "ZONE_RESOURCE_POOL_EXHAUSTED", 1
    rest = RestClient(transport=fake.transport, token_provider=lambda: "t",
                      sleep=lambda s: None)
    provider = create_node_provider(
        dict(config["provider"], _rest_client=rest), config["cluster_name"])
    with pytest.raises(NodeLaunchException) as e:
        NodeLauncher(provider, config["cluster_name"], config, queue.Queue(),
                     PendingLaunches(), {}).launch("pair", 2)
    assert e.value.category == "stockout" and e.value.launched == 0
    assert fake.instances == {} and fake.policies == {}


def test_the_reference_node_agent_advertises_the_cards(host8, capsys,
                                                       monkeypatch):
    """The bootstrapped worker start command sets TIK_NODE_RESOURCES from
    the detection's output before `tik node start`; the port's
    NodeAgent that command starts takes it as its resources."""
    _no_nvml(monkeypatch)
    config = cluster_operator.bootstrap_config(_cluster(CONFIGS["single"][0]))
    (command,) = config["worker_start_commands"]
    assert command == TC.NODE_RESOURCES_EXPORT + "tik node start --daemonize"
    assert "-m cloudtik_tpu_torch.utils.resource_spec)" in command
    for name in ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES",
                 "TIK_NODE_RESOURCES"):
        monkeypatch.delenv(name, raising=False)
    # the command substitution, on a host whose /dev and /proc are fakes
    assert R.main(["--dev-root", host8[0], "--proc-root", host8[1]]) == 0
    monkeypatch.setenv("TIK_NODE_RESOURCES", capsys.readouterr().out.strip())
    agent = NodeAgent(state_client=None, node_id="gce/gpus-worker-1",
                      node_ip="10.0.0.9")
    want = {"GPU": 8.0, H100: 1.0}
    assert {k: agent.total_resources[k] for k in want} == want
    assert agent.total_resources["CPU"] >= 1
    # what the scheduler asks of that node type, the node offers
    offered = config["available_node_types"]["gpu"]["resources"]
    assert all(agent.total_resources[k] >= v for k, v in offered.items()
               if k != "gpu_hosts")
