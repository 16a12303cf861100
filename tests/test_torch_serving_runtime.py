"""The port's serving runtime, registered where the cluster reads it.

`cloudtik_tpu_torch.runtimes.serving.runtime.ServingRuntime` starts the
port's `ServeServer` on the runtime config's backend and registers it in
discovery through the port's copies of the service registry.  Here the
node context carries the REFERENCE's state client, and the reference's
`ServiceRegistry` must find the service on the bound port: the copies
write what the cluster reads.  The answers are held to the port's
`generate` on the backend's params (plain) or to the backend called
in-process (engine); stop deregisters.
"""

import json
import urllib.request

import pytest
import torch

from cloudtik_tpu.control.state import InMemoryStateBackend, StateClient
from cloudtik_tpu.runtimes import registry
from cloudtik_tpu.runtimes.discovery.runtime import ServiceRegistry
from cloudtik_tpu.runtimes.serving import runtime as JR
from cloudtik_tpu_torch.models import generate as G
from cloudtik_tpu_torch.runtimes.serving import runtime as TR

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

SERVING_NAME = "cloudtik_tpu_torch.runtimes.serving.runtime:ServingRuntime"
PROMPT = [5, 6, 7, 11, 13]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


@pytest.fixture
def node_context(tmp_path, monkeypatch):
    # the runtime journals the port's events under TIK_HOME
    monkeypatch.setenv("TIK_HOME", str(tmp_path / "home"))
    monkeypatch.delenv("TIK_EVENTS_PATH", raising=False)
    return {"is_head": True, "node_id": "head", "node_ip": "127.0.0.1",
            "state_client": StateClient(InMemoryStateBackend()),
            "config": {"cluster_name": "gpu1", "workspace_name": "w1"},
            "conf_dir": str(tmp_path)}


@pytest.mark.parametrize("engine", [False, True])
def test_serving_runtime_answers_and_registers_for_the_cluster(
        node_context, engine):
    config = {"model": "tiny", "port": 0, "device": "cpu"}
    if engine:
        config.update(engine=True, slots=2, max_len=64)
    rt = TR.ServingRuntime(config)
    registry_ = ServiceRegistry(node_context["state_client"], "gpu1", "w1")
    try:
        rt.node_services(node_context, "start")
        server = TR._servers[("gpu1", "serving")]
        assert _get(server.port, "/healthz") == (200, {"status": "ok"})
        services = registry_.query("serving")
        assert [(s["node_id"], s["ip"], s["port"], s["protocol"])
                for s in services] == [("head", "127.0.0.1", server.port,
                                        "http")]
        # the configured port stays what the operator wrote
        assert rt.runtime_config["port"] == 0
        payload = {"tokens": [PROMPT], "max_new_tokens": 4}
        status, got = _post(server.port, "/v1/generate", payload)
        assert status == 200
        backend = server.backends[0]
        if engine:
            assert backend.engine is not None
            want, _ = backend.endpoints["generate"](payload)
            assert got["tokens"] == want["tokens"]
        else:
            with torch.no_grad():
                want = G.generate(backend.params, torch.tensor([PROMPT]),
                                  backend.cfg, max_new_tokens=4)
            assert got["tokens"] == want.tolist()
        assert len(got["tokens"][0]) == 4
        # a second start is a no-op: one server a cluster
        rt.node_services(node_context, "start")
        assert TR._servers[("gpu1", "serving")] is server
    finally:
        rt.node_services(node_context, "stop")
    assert ("gpu1", "serving") not in TR._servers
    assert registry_.query("serving") == []


def test_hooks_are_the_references():
    """The reference's hooks, plus the `serving-telemetry` service the
    port's runtime declares (the port's registry on its own port)."""
    got = TR.ServingRuntime({"port": 8300, "tags": {"a": "b"}})
    want = JR.ServingRuntime({"port": 8300, "tags": {"a": "b"}})
    assert got.get_runtime_endpoints({}, "10.0.0.2") == \
        want.get_runtime_endpoints({}, "10.0.0.2")
    assert got.get_runtime_services({}, "10.0.0.2") == {
        **want.get_runtime_services({}, "10.0.0.2"),
        "serving-telemetry": {"protocol": "http", "port": 9104,
                              "node_kind": "head"}}
    assert got.get_head_service_ports() == want.get_head_service_ports()
    assert got.get_processes() == want.get_processes()
    assert got.get_logs() == want.get_logs()
    assert got.get_health_check({}).script == \
        want.get_health_check({}).script == "tcp:8300"
    assert got.get_dependencies() == want.get_dependencies()
    assert not got.runs_on({"is_head": False})


def test_reference_registry_loads_the_serving_runtime(node_context):
    config = {"runtime": {"types": [SERVING_NAME], SERVING_NAME: {
        "model": "tiny", "port": 0, "device": "cpu"}}}
    (rt,) = registry.iter_runtimes(config)
    assert type(rt) is TR.ServingRuntime
    assert rt.registered_name == SERVING_NAME
    # a worker node runs no server
    rt.node_services(dict(node_context, is_head=False), "start")
    assert ("gpu1", "serving") not in TR._servers


def test_device_defaults_to_the_card(node_context, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rt = TR.ServingRuntime({"model": "tiny", "port": 0})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rt.node_services(node_context, "start")
    assert ("gpu1", "serving") not in TR._servers
