"""The control plane's daemons on the port, against the JAX package's.

The port holds a copy of each of the reference's control-plane modules
(`tests/test_torch_copies.py` holds them verbatim): the node agent with
its native sampler and state server, the updater, the launcher, the
demand scheduler, the scaler and the controller, the provider factory and
the virtual provider.  Here the reference's own tests of them
(`tests/test_scaler.py`, `test_control_plane.py`, `test_job_waiters.py`,
`test_native_host_agent.py`, `test_native_state_server.py`) run again on
the copies: each module's source with `cloudtik_tpu` renamed to
`cloudtik_tpu_torch`, its tests collected here under a `TestPort...` or
`test_port_...` name.  `tests/mock_infra.py` is loaded renamed the same
way, so its `MockProvider` is a port `NodeProvider` and raises the port's
`NodeLaunchException`, the one the port's launcher catches.

Then F6: the load-balancer sync daemon the port's runtime starts imports
the provider factory, and starts (`--help`) in a process where `import
jax` and `import cloudtik_tpu` raise; the factory gives the port's
providers, and loads every provider type it registers.
"""

import ast
import importlib
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest

from cloudtik_tpu_torch.core.node_provider import (NodeLaunchException,
                                                   NodeProvider)
from cloudtik_tpu_torch.providers import factory as F
from cloudtik_tpu_torch.providers.gcp.load_balancer_provider import (
    GCPLoadBalancerProvider)
from cloudtik_tpu_torch.providers.virtual.node_provider import (
    VirtualNodeProvider)
from cloudtik_tpu_torch.providers.virtual.workspace_provider import (
    VirtualWorkspaceProvider)
from cloudtik_tpu_torch.train import trainer as TTR

ROOT = Path(__file__).resolve().parents[1]
REFERENCE_TESTS = ("test_scaler", "test_control_plane", "test_job_waiters",
                   "test_native_host_agent", "test_native_state_server")
MOCK = "tests.mock_infra"
PORT_MOCK = "tests.mock_infra_on_the_port"


def _renamed(text):
    return re.sub(r"\bcloudtik_tpu\b", "cloudtik_tpu_torch", text)


def _port_source(name):
    """The reference test module `name`'s source, renamed to the port and
    to the renamed mock infrastructure."""
    text = (ROOT / "tests" / f"{name}.py").read_text()
    return re.sub(rf"\b{re.escape(MOCK)}\b", PORT_MOCK, _renamed(text))


def _load(path, module_name, source):
    module = types.ModuleType(module_name)
    module.__file__ = str(path)
    sys.modules[module_name] = module
    exec(compile(source, str(path), "exec"), module.__dict__)
    return module


PORT_MOCK_MODULE = _load(ROOT / "tests" / "mock_infra.py", PORT_MOCK,
                         _port_source("mock_infra"))
ON_THE_PORT = {name: _load(ROOT / "tests" / f"{name}.py",
                           f"tests.{name}_on_the_port", _port_source(name))
               for name in REFERENCE_TESTS}


def _marked(obj, marks):
    """`obj` under its module's `pytestmark`, which does not follow a test
    collected from another module."""
    for mark in marks if isinstance(marks, list) else [marks]:
        obj = mark(obj)
    return obj


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
# the module-level fixtures of those modules
agent_binary = ON_THE_PORT["test_native_host_agent"].agent_binary
server = ON_THE_PORT["test_native_state_server"].server
client = ON_THE_PORT["test_native_state_server"].client


@pytest.fixture(autouse=True)
def _trainer_on_the_cpu(monkeypatch):
    """The reference's scaler test resumes a trainer without naming a
    device: the JAX trainer runs where JAX runs, the port's on the card
    unless told otherwise (`cloudtik_tpu_torch/device.py`).  The rerun
    asks the port's for the CPU."""
    resolve = TTR.resolve_device
    monkeypatch.setattr(TTR, "resolve_device",
                        lambda device=None: resolve(device or "cpu"))


@pytest.mark.parametrize("name", REFERENCE_TESTS)
def test_the_reruns_import_the_ports_control_plane(name):
    source = _port_source(name)
    assert not re.findall(r"\bcloudtik_tpu\.[\w.]+", source)
    assert "cloudtik_tpu_torch." in source
    loaded = {v.__name__ if isinstance(v, types.ModuleType)
              else getattr(v, "__module__", "")
              for v in vars(ON_THE_PORT[name]).values()}
    loaded = {m for m in loaded if m.startswith(
        ("cloudtik_tpu", "tests.mock_infra"))}
    assert loaded and all(m.startswith("cloudtik_tpu_torch.")
                          or m == PORT_MOCK for m in loaded), loaded
    collected = [k for k, v in COLLECTED.items() if v == name]
    assert collected


def test_the_mock_infrastructure_is_the_ports():
    """A launch failure the mock raises is the one the port's launcher
    and availability tracker take as a categorised failure."""
    assert issubclass(PORT_MOCK_MODULE.MockProvider, NodeProvider)
    provider = PORT_MOCK_MODULE.MockProvider()
    provider.fail_creates = True
    with pytest.raises(NodeLaunchException) as e:
        provider.create_node({}, {}, 1)
    assert e.value.category == "quota"
    assert ON_THE_PORT["test_scaler"].MockProvider is \
        PORT_MOCK_MODULE.MockProvider


def test_every_reference_test_is_rerun():
    want = sum(1 for name in REFERENCE_TESTS for line in
               (ROOT / "tests" / f"{name}.py").read_text().splitlines()
               if re.match(r"\s*def test_", line))
    got = 0
    for attr in COLLECTED:
        obj = globals()[attr]
        got += sum(1 for k in vars(obj) if k.startswith("test_")) \
            if isinstance(obj, type) else 1
    assert (got, want) == (48, 48)


# ------------------------------------------------------------------ F6 -----

# `import jax` and the JAX package raise here: a card host has neither
_NO_JAX = ("import runpy, sys\n"
           "sys.modules['jax'] = None\n"
           "sys.modules['cloudtik_tpu'] = None\n"
           "sys.argv = [sys.argv[1]] + sys.argv[2:]\n"
           "runpy.run_module(sys.argv[0], run_name='__main__')\n")


def test_loadbalancer_sync_starts_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX,
         "cloudtik_tpu_torch.runtimes.loadbalancer.sync", "--help"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "--provider-config" in out.stdout


def test_factory_gives_the_ports_providers(tmp_path):
    lb = F.create_load_balancer_provider(
        {"type": "gcp", "project_id": "p", "region": "us-central1",
         "_rest_client": object()}, "ws")
    assert type(lb) is GCPLoadBalancerProvider
    assert lb.network == "projects/p/global/networks/tik-ws-vpc"
    assert lb.subnetwork == ("projects/p/regions/us-central1/subnetworks/"
                             "tik-ws-private-subnet")
    node = F.create_node_provider(
        {"type": "virtual", "root_dir": str(tmp_path)}, "c")
    assert type(node) is VirtualNodeProvider
    assert F.get_workspace_provider_cls({"type": "virtual"}) is \
        VirtualWorkspaceProvider
    gcp = F.get_node_provider_cls({"type": "gcp"})
    assert gcp.__module__ == "cloudtik_tpu_torch.providers.gcp.node_provider"


# The provider types whose port modules are missing: none since the other
# providers were copied (ROADMAP A17), so every registered type loads
MISSING = {kind: () for kind in ("node", "workspace", "storage", "database",
                                 "load_balancer")}
_REGISTRIES = {"node": F._NODE_PROVIDERS,
               "workspace": F._WORKSPACE_PROVIDERS,
               "storage": F._STORAGE_PROVIDERS,
               "database": F._DATABASE_PROVIDERS,
               "load_balancer": F._LOAD_BALANCER_PROVIDERS}


@pytest.mark.parametrize("kind", sorted(MISSING))
def test_factory_names_the_module_a_provider_lacks(kind):
    registry = _REGISTRIES[kind]
    missing = []
    for ptype, spec in sorted(registry.items()):
        if ptype == "mock":
            continue
        module = spec.partition(":")[0]
        try:
            F._load(spec)
        except ModuleNotFoundError as e:
            assert module == e.name or module.startswith(
                e.name + "."), (ptype, e)
            missing.append(ptype)
    assert sorted(missing) == sorted(MISSING[kind])


# The lazy imports of the copies that name a module the port does not have
# (F7 until the operator surface was copied: the lifecycle commands reached
# four missing modules)
LAZY_MISSING = set()


def _lazy_imports(path):
    """(module, name) of every `from cloudtik_tpu_torch... import name`
    inside a function of `path`."""
    tree = ast.parse(path.read_text())
    for func in ast.walk(tree):
        if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(func):
            if isinstance(node, ast.ImportFrom) and not node.level and \
                    node.module.split(".")[0] == "cloudtik_tpu_torch":
                for alias in node.names:
                    yield node.module, alias.name


def test_lazy_imports_resolve():
    unresolved = set()
    for path in sorted((ROOT / "cloudtik_tpu_torch").rglob("*.py")):
        for module, name in _lazy_imports(path):
            try:
                if hasattr(importlib.import_module(module), name):
                    continue
                importlib.import_module(f"{module}.{name}")
            except ModuleNotFoundError as e:
                unresolved.add(e.name)
    assert unresolved == LAZY_MISSING
