"""The port's AI runtime against the reference's, and through the
reference's cluster machinery.

`cloudtik_tpu_torch.runtimes.ai.runtime.AIRuntime` keeps the reference's
hooks for GPU hosts: the same env, services, endpoints, ports, logs and
dependencies; its install list names the port's packages (no JAX); its
runnable command is the port's launcher.  A cluster config names it by
`module:Class`, which the reference's registry loads, orders after `mount`
and hands to delivery and to the operator's runnable lookup.
"""

import sys

import pytest

from cloudtik_tpu.core.tags import (TAG_NODE_GROUP_ID,
                                    TAG_NODE_GROUP_WORKER_INDEX)
from cloudtik_tpu.runtimes import delivery, registry
from cloudtik_tpu.runtimes.ai import runtime as JA
from cloudtik_tpu.runtimes.ai import scaling as JS
from cloudtik_tpu_torch.core import runtime as core_runtime
from cloudtik_tpu_torch.runtimes import installer
from cloudtik_tpu_torch.runtimes.ai import runtime as TA
from cloudtik_tpu_torch.runtimes.ai import scaling as TS

AI_NAME = "cloudtik_tpu_torch.runtimes.ai.runtime:AIRuntime"
CONFIG = {"tracker_port": 5100, "coordinator_port": 9300,
          "shared_memory_ratio": 0.25}


class FakeProvider:
    def __init__(self, tags):
        self.tags = tags

    def node_tags(self, node_id):
        if node_id not in self.tags:
            raise KeyError(node_id)
        return self.tags[node_id]


PROVIDER = FakeProvider({
    "w0": {TAG_NODE_GROUP_ID: "slice-a", TAG_NODE_GROUP_WORKER_INDEX: "3"},
    "w1": {TAG_NODE_GROUP_ID: "slice-b"},
    "plain": {}})


@pytest.mark.parametrize("node_id", ["w0", "w1", "plain", "missing"])
@pytest.mark.parametrize("config", [{}, CONFIG])
def test_environment_variables_are_the_references(node_id, config):
    got = TA.AIRuntime(dict(config)).with_environment_variables(
        {}, PROVIDER, node_id)
    want = JA.AIRuntime(dict(config)).with_environment_variables(
        {}, PROVIDER, node_id)
    assert got == want


@pytest.mark.parametrize("config", [{}, CONFIG])
def test_services_endpoints_ports_logs_and_dependencies(config):
    got, want = TA.AIRuntime(dict(config)), JA.AIRuntime(dict(config))
    for hook in ("get_runtime_services", "get_runtime_endpoints"):
        assert getattr(got, hook)({}, "10.0.0.2") == \
            getattr(want, hook)({}, "10.0.0.2")
    assert got.get_head_service_ports() == want.get_head_service_ports()
    assert got.get_logs() == want.get_logs()
    assert got.get_dependencies() == want.get_dependencies() == ["mount"]
    assert got.get_runtime_shared_memory_ratio({}, "worker") == \
        want.get_runtime_shared_memory_ratio({}, "worker")
    assert got.prepare_config({"a": 1}) == {"a": 1}
    assert got.validate_config({}) is None
    assert isinstance(got, core_runtime.Runtime)


def test_processes_name_the_port_launcher():
    got = TA.AIRuntime({}).get_processes()
    want = JA.AIRuntime({}).get_processes()
    assert got[0] == ("cloudtik_tpu_torch.launch.run", True, "AILauncher",
                      "node")
    assert got[1:] == want[1:]


@pytest.mark.parametrize("options", [None, ["--nproc-per-node", "2"]])
def test_runnable_command_is_the_port_launcher(options):
    rt = TA.AIRuntime({})
    got = rt.get_runnable_command("~/.tik/jobs/train.py", options)
    assert got == ["python3", "-m", "cloudtik_tpu_torch.launch.run",
                   *(options or []), "~/.tik/jobs/train.py"]
    # the reference's is its own launcher over the same options and target
    assert JA.AIRuntime({}).get_runnable_command(
        "~/.tik/jobs/train.py", options)[1:] == got[3:]
    py = TA.AIRuntime({"python": "/opt/py/bin/python3"})
    assert py.get_runnable_command("a.py")[:3] == [
        "/opt/py/bin/python3", "-m", "cloudtik_tpu_torch.launch.run"]


@pytest.mark.parametrize("target", ["job.sh", "train.ipynb", "train.pyc"])
def test_non_python_targets_have_no_runnable_command(target):
    assert TA.AIRuntime({}).get_runnable_command(target) is None
    assert JA.AIRuntime({}).get_runnable_command(target) is None


def test_default_packages_name_no_jax_package():
    jax_family = ("jax", "flax", "optax", "orbax", "chex", "grain",
                  "libtpu")
    for package in TA.AIRuntime.DEFAULT_PACKAGES:
        assert not package.lower().startswith(jax_family), package
    assert "torch" in TA.AIRuntime.DEFAULT_PACKAGES


@pytest.fixture
def recorded_installs(monkeypatch):
    calls = []
    monkeypatch.setattr(installer, "install",
                        lambda name, spec: calls.append((name, spec)))
    return calls


def test_node_install_with_torch_present_installs_nothing(
        recorded_installs):
    TA.AIRuntime({}).node_install({"is_head": True})
    TA.AIRuntime({"install": {"type": "pip", "packages": ["x"]}}
                 ).node_install({"is_head": False})
    assert recorded_installs == []


@pytest.mark.parametrize("override", [None, {"type": "pip",
                                             "packages": ["torch==2.11"]}])
def test_node_install_without_torch_installs_the_spec(
        recorded_installs, monkeypatch, override):
    # a None entry makes `import torch` raise ImportError
    monkeypatch.setitem(sys.modules, "torch", None)
    config = {} if override is None else {"install": override}
    TA.AIRuntime(config).node_install({"is_head": True})
    want = override or {"type": "pip",
                        "packages": list(TA.AIRuntime.DEFAULT_PACKAGES)}
    assert recorded_installs == [("ai", want)]


def test_scaling_policy_asks_for_cards():
    assert TA.AIRuntime({}).get_scaling_policy({}, "h") is None
    policy = TA.AIRuntime({"scaling": {"enabled": True}}).get_scaling_policy(
        {}, "h")
    assert isinstance(policy, TS.AISliceScalingPolicy)
    assert policy.slice_resources == {"GPU": 8}
    assert policy.name() == JS.AISliceScalingPolicy({}, "h").name()

    class Jobs:
        def table_list(self, table):
            assert table == "ai_jobs"
            return {str(i): {"status": s} for i, s in
                    enumerate(["pending"] * 6 + ["running"])}

    for scaling in ({}, {"slice_resources": {"GPU": 4},
                         "max_pending_slices": 2}):
        got = TS.AISliceScalingPolicy({}, "h", scaling, Jobs())
        want = JS.AISliceScalingPolicy(
            {}, "h", dict(scaling, slice_resources=got.slice_resources),
            Jobs())
        g = got.get_scaling_state().autoscaling_instructions
        w = want.get_scaling_state().autoscaling_instructions
        assert g["resource_demands"] == w["resource_demands"]
        assert len(g["resource_demands"]) == scaling.get(
            "max_pending_slices", 4)


def _cluster(extra=None):
    return {"cluster_name": "gpu", "workspace_name": "ws",
            "runtime": {"types": [AI_NAME, "mount"],
                        AI_NAME: dict(extra or {})}}


def test_reference_registry_loads_the_port_runtime_after_mount():
    config = _cluster({"python": "/usr/bin/python3"})
    runtimes = registry.iter_runtimes(config)
    assert [r.registered_name for r in runtimes] == ["mount", AI_NAME]
    ai = runtimes[1]
    assert type(ai) is TA.AIRuntime
    assert ai.runtime_config == {"python": "/usr/bin/python3"}
    direct = registry.create_runtime(AI_NAME, {})
    assert type(direct) is TA.AIRuntime and direct.registered_name == AI_NAME


def test_operator_runnable_lookup_reaches_the_port_launcher():
    """`tik submit train.py`'s lookup (control/cluster_operator.py): the
    first runtime with a runnable command for the uploaded path."""
    runnable = None
    for runtime in registry.iter_runtimes(_cluster()):
        runnable = runtime.get_runnable_command("~/.tik/jobs/train.py", None)
        if runnable:
            break
    assert runnable == ["python3", "-m", "cloudtik_tpu_torch.launch.run",
                        "~/.tik/jobs/train.py"]


def test_reference_delivery_drives_the_port_runtime(
        tmp_path, monkeypatch, recorded_installs):
    monkeypatch.setenv("TIK_HOME", str(tmp_path))
    config = _cluster()
    ctx = delivery.build_node_context(config, is_head=True, node_id="head")
    delivery.install_runtimes(config, ctx, names=[AI_NAME])
    delivery.configure_runtimes(config, ctx, names=[AI_NAME])
    delivery.start_runtime_services(config, ctx, names=[AI_NAME])
    assert recorded_installs == []       # torch is importable here
    status = delivery.read_status(AI_NAME)
    assert status["installed"] and status["configured"] \
        and status["started"]
    assert status["error"] is None
    # without torch the install phase runs the port's installer
    monkeypatch.setitem(sys.modules, "torch", None)
    delivery.install_runtimes(config, ctx, names=[AI_NAME])
    assert recorded_installs == [("ai", {
        "type": "pip", "packages": list(TA.AIRuntime.DEFAULT_PACKAGES)})]
