"""Every built-in runtime on the port, against the JAX package's.

The port holds a copy of each runtime the reference names
(`tests/test_torch_copies.py` holds them verbatim).  Here the reference's
own runtime tests (`tests/test_golden_configs.py`,
`test_runtimes_lb_dns.py`, `test_runtimes_stateful.py`,
`test_observability_runtimes.py`) run again on the port's copies: each
module's source with `cloudtik_tpu` renamed to `cloudtik_tpu_torch`, its
test classes and fixtures collected here under a `TestPort...` name, so
every golden render, grammar check and registry check of the reference
holds for the copies.  The renders are also compared output for output,
and the port's prometheus runtime renders the reference's targets for a
cluster that declares the port's `serving` beside other runtimes (F4),
with the one recorded difference, the `serving-telemetry` job.
"""

import importlib
import importlib.util
import json
import re
import types
from pathlib import Path

import pytest

from cloudtik_tpu.runtimes import registry as JREG
from cloudtik_tpu.runtimes.prometheus import runtime as JP
from cloudtik_tpu.telemetry import core as JC
from cloudtik_tpu_torch.runtimes import registry as TREG
from cloudtik_tpu_torch.runtimes.prometheus import runtime as TP
from cloudtik_tpu_torch.telemetry import core as TC

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "cloudtik_tpu_torch"
REFERENCE_TESTS = ("test_golden_configs", "test_runtimes_lb_dns",
                   "test_runtimes_stateful", "test_observability_runtimes")


def _renamed(text):
    return re.sub(r"\bcloudtik_tpu\b", "cloudtik_tpu_torch", text)


def _port_source(name):
    """The reference test module `name`'s source, renamed to the port: the
    dashboard test reads the metric names the port's controller emits."""
    return _renamed((ROOT / "tests" / f"{name}.py").read_text())


def _on_the_port(name):
    """The reference test module `name`, run on the port's modules."""
    path = ROOT / "tests" / f"{name}.py"
    module = types.ModuleType(f"tests.{name}_on_the_port")
    module.__file__ = str(path)
    exec(compile(_port_source(name), str(path), "exec"), module.__dict__)
    return module


ON_THE_PORT = {name: _on_the_port(name) for name in REFERENCE_TESTS}
for _name, _module in ON_THE_PORT.items():
    _prefix = "".join(w.title() for w in _name[len("test_"):].split("_"))
    for _attr, _obj in vars(_module).items():
        if _attr.startswith("Test") and isinstance(_obj, type):
            globals()[f"TestPort{_prefix}{_attr[len('Test'):]}"] = _obj
# the one module-level fixture of those modules
registry = ON_THE_PORT["test_runtimes_lb_dns"].registry


@pytest.mark.parametrize("name", REFERENCE_TESTS)
def test_the_reruns_import_the_ports_runtimes(name):
    source = _port_source(name)
    assert "cloudtik_tpu_torch.runtimes." in source
    assert not re.findall(r"\bcloudtik_tpu\.[\w.]+", source)
    loaded = {v.__module__ for v in vars(ON_THE_PORT[name]).values()
              if callable(v) and getattr(v, "__module__", "")
              .startswith("cloudtik_tpu")}
    assert all(m.startswith("cloudtik_tpu_torch.") for m in loaded)
    classes = [k for k, v in globals().items() if k.startswith("TestPort")
               and v.__module__ == ON_THE_PORT[name].__name__]
    assert classes


# ----------------------------------------------- renders, output for output --

PEERS = ON_THE_PORT["test_golden_configs"].PEERS
ROUTES = [{"name": "serving", "path": "/serve",
           "servers": [{"ip": "10.0.0.2", "port": 8200},
                       {"ip": "10.0.0.3", "port": 8200}]}]
RENDERS = {
    "kafka": ("kafka.runtime", "render_server_properties",
              ("w-2", "10.0.0.2", PEERS), {}),
    "zookeeper": ("zookeeper.runtime", "render_zoo_cfg", (PEERS,), {}),
    "etcd": ("etcd.runtime", "render_etcd_config",
             ("w-1", "10.0.0.1", PEERS), {}),
    "hdfs_core": ("hdfs.runtime", "render_core_site", ("10.0.0.1",), {}),
    "hdfs_site": ("hdfs.runtime", "render_hdfs_site", (True,),
                  {"replication": 2}),
    "nginx": ("nginx.runtime", "render_nginx_conf", (ROUTES,), {}),
    "haproxy": ("haproxy.runtime", "render_haproxy_cfg", ([
        {"name": "postgres", "bind_port": 15432,
         "backends": [{"name": "n1", "ip": "10.0.0.1", "port": 5432}]}],),
        {}),
    "redis": ("redis.runtime", "render_redis_conf", (),
              {"primary_ip": "10.0.0.1", "password": "s3cret",
               "maxmemory_mb": 256}),
    "postgres": ("postgres.runtime", "render_postgresql_conf", (),
                 {"is_primary": True, "synchronous": True}),
    "pg_hba": ("postgres.runtime", "render_pg_hba", (["10.0.0.0/8"],), {}),
    "mysql": ("mysql.runtime", "render_my_cnf", (),
              {"server_id": 3, "is_source": False, "source_ip": "10.0.0.1"}),
    "mongod": ("mongodb.runtime", "render_mongod_conf", (), {}),
    "trino": ("trino.runtime", "render_trino_config", (True, "10.0.0.1"),
              {}),
    "pgpool": ("pgpool.runtime", "render_pgpool_conf", ([
        {"ip": "10.0.0.2", "port": 5432, "role": "replica"},
        {"ip": "10.0.0.1", "port": 5432, "role": "primary"}],), {}),
    "pgbouncer": ("pgbouncer.runtime", "render_pgbouncer_ini",
                  ("10.0.0.1",), {}),
    "kong": ("kong.runtime", "render_kong_declarative", ([
        {"name": "serving", "path": "/serve",
         "targets": [{"ip": "10.0.0.2", "port": 8200}]}],), {}),
    "flink": ("flink.runtime", "render_flink_conf", ("10.0.0.1",), {}),
    "consul": ("consul.runtime", "render_consul_config",
               ("w-1", "10.0.0.1", True, ["10.0.0.1", "10.0.0.2"]), {}),
    "elasticsearch": ("elasticsearch.runtime", "render_elasticsearch_yml",
                      ("w-1", "10.0.0.1", PEERS), {}),
}


def _call(package, module, fn, args, kwargs):
    mod = importlib.import_module(f"{package}.runtimes.{module}")
    return getattr(mod, fn)(*args, **kwargs)


@pytest.mark.parametrize("case", sorted(RENDERS))
def test_render_is_the_references(case):
    module, fn, args, kwargs = RENDERS[case]
    want = _call("cloudtik_tpu", module, fn, args, kwargs)
    got = _call("cloudtik_tpu_torch", module, fn, args, kwargs)
    assert got == want


# ---------------------------------------------------------- the registry --

@pytest.mark.parametrize("name", sorted(JREG._BUILT_IN))
def test_registry_knows_every_built_in_name(name):
    """Copies and the port's own counterparts (ai, serving, profiler) at
    the reference's module path and class name."""
    cls = TREG.get_runtime_cls(name)
    ref = JREG.get_runtime_cls(name)
    assert cls.__module__ == _renamed(ref.__module__)
    assert cls.__name__ == ref.__name__


def test_registry_orders_every_runtime_as_the_reference():
    config = {"runtime": {"types": sorted(JREG._BUILT_IN)}}
    assert [r.registered_name for r in TREG.iter_runtimes(config)] == \
        [r.registered_name for r in JREG.iter_runtimes(config)]
    assert set(TREG._BUILT_IN) == set(JREG._BUILT_IN)


# ------------------------------------------------ module targets in strings --

# the provider factory's registries, whose entries name providers still to
# come as well, are held by tests/test_torch_control.py
FACTORY = PORT / "providers" / "factory.py"


def _module_targets():
    found = set()
    for path in PORT.rglob("*.py"):
        if path == FACTORY:
            continue
        for m in re.finditer(r"[\"'](cloudtik_tpu_torch(?:\.\w+)+"
                             r"(?::\w+)?)[\"']", path.read_text()):
            found.add((str(path.relative_to(ROOT)), m.group(1)))
    return sorted(found)


@pytest.mark.parametrize("where,target", _module_targets())
def test_module_named_in_a_string_is_the_ports(where, target):
    """Service commands (`-m` targets), registry entries and process
    keywords name modules of the port that exist: the rename reached the
    strings the copies build commands from."""
    module, _, cls = target.partition(":")
    while importlib.util.find_spec(module) is None:
        # a keyword or dotted attribute: its longest importable prefix
        module, _, _ = module.rpartition(".")
        assert module.count(".") >= 1, (where, target)
    if cls:
        assert hasattr(importlib.import_module(module), cls), (where, target)


def test_loadbalancer_controller_runs_the_ports_sync(monkeypatch):
    from cloudtik_tpu_torch.runtimes.common import process_runner
    from cloudtik_tpu_torch.runtimes.loadbalancer import runtime as LB

    calls = []
    monkeypatch.setattr(process_runner, "spawn_service",
                        lambda name, cmd: calls.append(cmd))
    LB.LoadBalancerRuntime({}).node_services(
        {"is_head": True, "config": {}}, "start")
    (cmd,) = calls
    assert cmd[1:3] == ["-m", "cloudtik_tpu_torch.runtimes.loadbalancer.sync"]
    assert importlib.util.find_spec(cmd[2]) is not None


# -------------------------------------------- the prometheus runtime (F4) --

@pytest.fixture
def telemetry_on():
    was = (JC.STATE.enabled, TC.STATE.enabled)
    for core in (JC, TC):
        core.enable()
    try:
        yield
    finally:
        for core, on in zip((JC, TC), was):
            core.STATE.enabled = on


def _http_runtimes():
    out = []
    for name in sorted(JREG._BUILT_IN):
        services = JREG.create_runtime(name, {}).get_runtime_services(
            {"cluster_name": "c"}, "10.0.0.2") or {}
        if any(s.get("protocol") == "http" for s in services.values()):
            out.append(name)
    return out


def _rendered(mod, types_, tmp):
    config = {"cluster_name": "c", "telemetry_port": 9103,
              "runtime": {"types": types_}}
    ctx = {"is_head": True, "config": config, "head_ip": "10.0.0.2",
           "conf_dir": str(tmp)}
    mod.PrometheusRuntime({}).node_configure(ctx)
    return {name: (tmp / name).read_text().replace(str(tmp), "<conf>")
            for name in ("targets.json", "prometheus.yml", "alerts.yml")}


@pytest.mark.parametrize("declared", ["serving_consul", "every_http"])
def test_port_renders_the_references_targets(declared, tmp_path,
                                             telemetry_on):
    """F4: a cluster declaring the port's `serving` beside runtimes the
    port once lacked gets the reference's targets.json and prometheus.yml;
    the port's serving runtime adds its `serving-telemetry` job."""
    types_ = ["serving", "consul"] if declared == "serving_consul" \
        else _http_runtimes()
    assert {"serving", "consul"} <= set(types_)
    ref = _rendered(JP, types_, tmp_path / "ref")
    got = _rendered(TP, types_, tmp_path / "port")
    assert got["prometheus.yml"] == ref["prometheus.yml"]
    assert got["alerts.yml"] == ref["alerts.yml"]
    want = json.loads(ref["targets.json"])
    groups = json.loads(got["targets.json"])
    extra = [g for g in groups if g["labels"]["job"] == "serving-telemetry"]
    assert extra == [{"targets": ["10.0.0.2:9104"],
                      "labels": {"job": "serving-telemetry",
                                 "cluster": "c"}}]
    assert [g for g in groups if g not in extra] == want
    jobs = {g["labels"]["job"] for g in want}
    assert {"serving", "consul", "telemetry"} <= jobs
    if declared == "every_http":
        assert len(jobs) >= 15
