"""The operator surface on the port: `tik start` through `tik stop`.

The port holds a copy of each of the reference's operator modules
(`tests/test_torch_copies.py` holds them verbatim): the lifecycle's
event system and timer, the config pipeline with its templates, the
public API, the node-services process, cluster dumps, workspaces,
proxies, chaos drills and the whole CLI.  Here the reference's own tests
of them (`tests/test_e2e_virtual_cluster.py`, `test_cluster_dump_head.py`,
`test_config.py`, `test_delivery.py`, `test_logs_cli.py`, three classes of
`test_utils_misc.py` and the three drills of `test_chaos_drills.py` that
reach only the scaler and the providers) run again on the copies, each
module's source with `cloudtik_tpu` renamed to `cloudtik_tpu_torch`,
collected here under a `TestPort...` or `test_port_...` name.

Then F7, the parity of every cluster example and template, a lifecycle on
the CPU through the port's CLI, where the head's node services serve
`tiny` through the port's `ServingRuntime`, every command's `--help` in a
process where `import jax` and `import cloudtik_tpu` raise, and so the
other providers' entry points and `chaos run` on an `onpremise` cluster.
"""

from __future__ import annotations

import json
import os
import re
import signal
import socket
import subprocess
import sys
import tarfile
import time
import urllib.request
from pathlib import Path

import pytest
import torch
import yaml

from cloudtik_tpu.config import loader as JL
from cloudtik_tpu.config import schema as JS
from cloudtik_tpu_torch.config import loader as TL
from cloudtik_tpu_torch.config import schema as TS
from cloudtik_tpu_torch.control import cluster_operator
from cloudtik_tpu_torch.control.state import StateClient, TcpStateBackend
from cloudtik_tpu_torch.providers.factory import create_node_provider
from cloudtik_tpu_torch.runtimes.serving import runtime as SR
from tests.test_torch_control import (PORT_MOCK, _load, _marked,
                                      _renamed)

ROOT = Path(__file__).resolve().parents[1]
# reference test module -> the names of it rerun (None: every test)
REFERENCE_TESTS = {
    "test_e2e_virtual_cluster": None,
    "test_cluster_dump_head": None,
    "test_config": None,
    "test_delivery": None,
    "test_logs_cli": None,
    "test_utils_misc": ("TestConcurrentObjectCache", "TestEventSummarizer",
                        "TestFateSharing"),
    "test_chaos_drills": (
        "test_drill_heartbeat_blackout_under_grace_is_not_condemned",
        "test_chaos_cli_validate_and_run",
        "test_run_drill_surfaces_injected_launch_failures"),
}
# cases of those left out, with their reason (ROADMAP A17): the reference
# ships TPU slice templates, the port their A3 counterparts (the
# counterparts' own tests follow below)
LEFT_OUT = {
    ("test_config", "TestBuiltInTemplates", "test_templates_exist"):
        "names gcp/tpu-v5p-small, which the port ships as gcp/h100-small",
    ("test_config", "TestBuiltInTemplates",
     "test_tpu_template_declares_atomic_slice"):
        "reads the v5p-128 slice of gcp/tpu-v5p-pod, which the port ships "
        "as the A3 group gcp/h100-pod",
}
# the reference's test helpers the reruns import, loaded renamed
HELPERS = {"tests.fake_infra": "tests.fake_infra_on_the_port",
           "tests.test_scaler": "tests.test_scaler_on_the_port",
           "tests.mock_infra": PORT_MOCK}


def _port_source(name):
    text = _renamed((ROOT / "tests" / f"{name}.py").read_text())
    for ref, port in HELPERS.items():
        text = re.sub(rf"\b{re.escape(ref)}\b", port, text)
    return text.replace("from tests import fake_infra\n",
                        "from tests import fake_infra_on_the_port as "
                        "fake_infra\n")


for _ref, _port in HELPERS.items():
    if _port not in sys.modules:
        _name = _ref.split(".")[-1]
        _load(ROOT / "tests" / f"{_name}.py", _port, _port_source(_name))
ON_THE_PORT = {name: _load(ROOT / "tests" / f"{name}.py",
                           f"tests.{name}_on_the_port", _port_source(name))
               for name in REFERENCE_TESTS}


def _without(cls, names):
    """`cls` with the test methods `names` left out."""
    return type(cls.__name__, (cls,), {n: None for n in names})


COLLECTED = {}
for _name, _module in ON_THE_PORT.items():
    _prefix = "".join(w.title() for w in _name[len("test_"):].split("_"))
    _marks = getattr(_module, "pytestmark", [])
    _only = REFERENCE_TESTS[_name]
    for _attr, _obj in list(vars(_module).items()):
        if _only is not None and _attr not in _only:
            continue
        if _attr.startswith("Test") and isinstance(_obj, type):
            _as = f"TestPort{_prefix}{_attr[len('Test'):]}"
            _left = [m for (n, c, m) in LEFT_OUT if (n, c) == (_name, _attr)]
            if _left:
                _obj = _without(_obj, _left)
        elif _attr.startswith("test_") and callable(_obj):
            _as = f"test_port_{_name[len('test_'):]}_{_attr[len('test_'):]}"
        else:
            continue
        globals()[_as] = _marked(_obj, _marks)
        COLLECTED[_as] = _name
# the module-level fixtures of those modules (the two `tik_home_tmp` are
# the same fixture)
tik_home_tmp = ON_THE_PORT["test_delivery"].tik_home_tmp
head_state = ON_THE_PORT["test_delivery"].head_state
isolated_home = ON_THE_PORT["test_e2e_virtual_cluster"].isolated_home
wired = ON_THE_PORT["test_logs_cli"].wired
_disarmed = ON_THE_PORT["test_chaos_drills"]._disarmed


def test_every_named_reference_test_is_rerun():
    want = 0
    for name, only in REFERENCE_TESTS.items():
        module = ON_THE_PORT[name]
        for attr in (only or vars(module)):
            obj = getattr(module, attr)
            if isinstance(obj, type) and attr.startswith("Test"):
                want += sum(1 for k in vars(obj) if k.startswith("test_"))
            elif attr.startswith("test_") and callable(obj):
                want += 1
    got = 0
    for attr in COLLECTED:
        obj = globals()[attr]
        got += sum(1 for k in dir(obj) if k.startswith("test_")
                   and callable(getattr(obj, k))) \
            if isinstance(obj, type) else 1
    assert (got, want - len(LEFT_OUT)) == (51, 51)


@pytest.mark.parametrize("name", sorted(REFERENCE_TESTS))
def test_the_reruns_import_the_ports_operator_surface(name):
    source = _port_source(name)
    assert not re.findall(r"\bcloudtik_tpu\.[\w.]+", source)
    assert not re.findall(r"\btests\.(fake_infra|mock_infra|test_scaler)\b"
                          r"(?!_on_the_port)", source)
    assert [k for k, v in COLLECTED.items() if v == name]


# ------------------------------------------------------------------ F7 -----

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pid_alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _wait(what, predicate, timeout_s=60.0, poll_s=0.1):
    deadline = time.time() + timeout_s
    while True:
        got = predicate()
        if got:
            return got
        assert time.time() < deadline, f"no {what} within {timeout_s} s"
        time.sleep(poll_s)


def test_f7_the_ports_operator_boots_its_own_node_services(isolated_home,
                                                           tmp_path,
                                                           monkeypatch):
    """F7: the port's `create_or_update_cluster` on the virtual provider
    boots the head with `cloudtik_tpu_torch.scripts.cli node start --head
    --daemonize`, which the port's CLI had no `node` group for, and its
    `up`, hard teardown and dump imported four modules the port lacked.
    The head's node services are the port's own process; a dump and a
    hard teardown run; nothing of the cluster is left."""
    from cloudtik_tpu_torch.control import services

    # the run dir as a process started under this TIK_HOME reads it (the
    # constant is taken at import)
    monkeypatch.setattr(services, "TIK_RUN_DIR",
                        str(tmp_path / ".tik" / "run"))
    state_port = _free_port()
    config = ON_THE_PORT["test_e2e_virtual_cluster"]._config(tmp_path,
                                                            state_port)
    config["telemetry_port"] = 0
    cluster_operator.create_or_update_cluster(dict(config))
    pid_file = tmp_path / ".tik" / "run" / "node-services-e2e.pid"
    try:
        pid = int(_wait("pidfile", lambda: pid_file.exists()
                        and pid_file.read_text().strip()))
        argv = Path(f"/proc/{pid}/cmdline").read_bytes().split(b"\0")
        assert b"cloudtik_tpu_torch.scripts.cli" in argv and \
            b"--head" in argv, argv
        client = StateClient(TcpStateBackend("127.0.0.1", state_port,
                                             timeout=3.0))
        info = _wait("cluster info", lambda: _table_get(client, "cluster",
                                                        "info"))
        assert info["cluster_name"] == "e2e"
        out = str(tmp_path / "dump.tar.gz")
        assert cluster_operator.dump_cluster(dict(config),
                                             output_path=out) == out
        with tarfile.open(out) as tar:
            names = tar.getnames()
        assert any(n.endswith("/node-services.log") for n in names)
        assert any(n.endswith("/events/events.jsonl") for n in names)
    finally:
        cluster_operator.teardown_cluster(dict(config), hard=True)
    _wait("the node services gone", lambda: not _pid_alive(pid))
    assert not pid_file.exists()
    provider = create_node_provider(config["provider"], "e2e")
    assert provider.non_terminated_nodes({}) == []


def _table_get(client, table, key):
    try:
        return client.table_get(table, key)
    except Exception:
        return None


# -------------------------------------------------- examples, templates ----

EXAMPLES = sorted(p.name for p in (ROOT / "examples").glob("*-cluster.yaml"))
TEMPLATES = sorted(
    str(p.relative_to(ROOT / "cloudtik_tpu_torch" / "templates"))[:-5]
    for p in (ROOT / "cloudtik_tpu_torch" / "templates").glob("*/*.yaml")
    if p.stem != "defaults")
# what a template's user config names (ids and zones of each provider)
_USER = {"cluster_name": "t", "provider": {
    "project_id": "p", "availability_zone": "us-central1-a",
    "subscription_id": "s"}}
A3 = ("gcp/h100-1g-small", "gcp/h100-small", "gcp/h100-pod")


@pytest.mark.parametrize("example", EXAMPLES)
def test_examples_prepare_and_validate_as_the_references(example):
    path = str(ROOT / "examples" / example)
    got = TL.prepare_config(TL.load_yaml(path),
                            search_dirs=[str(ROOT / "examples")])
    want = JL.prepare_config(JL.load_yaml(path),
                             search_dirs=[str(ROOT / "examples")])
    TS.validate_cluster_config(got)
    JS.validate_cluster_config(want)
    assert got == want


@pytest.mark.parametrize("template", TEMPLATES)
def test_templates_prepare_and_validate_as_the_references(template):
    got = TL.prepare_config({"from": template, **_USER})
    TS.validate_cluster_config(got)
    assert got["head_node_type"] in got["available_node_types"]
    if template in A3:
        return
    want = JL.prepare_config({"from": template, **_USER})
    JS.validate_cluster_config(want)
    assert got == want


@pytest.mark.parametrize("template,cards,hosts", [
    ("gcp/h100-1g-small", 1, 1), ("gcp/h100-small", 8, 1),
    ("gcp/h100-pod", 8, 16)])
def test_a3_templates_bootstrap_on_the_ports_gcp_provider(template, cards,
                                                          hosts):
    """Each A3 counterpart takes the reference template's role on the
    port's GCP provider: a CPU head, one worker type of H100 hosts whose
    cards the machine type gives, and for the pod one atomic group of
    `hosts` made by one bulk insert."""
    from cloudtik_tpu_torch.providers.gcp import config as GC
    from cloudtik_tpu_torch.providers.gcp import gpu

    config = GC.bootstrap_gcp(TL.prepare_config({"from": template,
                                                 **_USER}))
    workers = {k: v for k, v in config["available_node_types"].items()
               if k != config["head_node_type"]}
    (worker,) = workers.values()
    machine = worker["node_config"]["machineType"]
    assert gpu.machine_cards(machine) == cards
    assert worker["resources"]["GPU"] == cards
    assert worker["min_workers"] == worker["max_workers"] == hosts
    group = worker.get("node_group") or {}
    assert (group.get("atomic", False), group.get("group_size", 1)) == \
        (hosts > 1, hosts)
    assert not gpu.is_gpu_node_config(
        config["available_node_types"][config["head_node_type"]][
            "node_config"])
    if hosts > 1:
        from cloudtik_tpu_torch.core.tags import TAG_CLUSTER_NAME
        from cloudtik_tpu_torch.providers.gcp.node_provider import (
            GCPNodeProvider)
        from tests.test_torch_gcp_gpu_provider import FakeGpuCloud, _rest
        fake = FakeGpuCloud()
        provider = GCPNodeProvider(
            {**config["provider"], "_rest_client": _rest(fake)}, "t")
        group = provider.create_node_group(
            worker["node_config"], {TAG_CLUSTER_NAME: "t"}, hosts)
        assert len(provider.list_node_groups({})[group]) == hosts
        bulk = [u for m, u in fake.calls
                if m == "POST" and "bulkInsert" in u]
        assert len(bulk) == 1 and len(fake.instances) == hosts


# ------------------------------------------------------- the lifecycle -----

# `import jax` and the JAX package raise in every process of the lifecycle
_SITE_NO_JAX = ('import sys\nsys.modules["jax"] = None\n'
                'sys.modules["cloudtik_tpu"] = None\n')


def _no_jax_env(tmp_path):
    """The environment of a process where `import jax` and `import
    cloudtik_tpu` raise, with `tmp_path/home` as its home."""
    site = tmp_path / "site"
    site.mkdir(exist_ok=True)
    (site / "sitecustomize.py").write_text(_SITE_NO_JAX)
    return dict(os.environ, HOME=str(tmp_path / "home"),
                TIK_HOME=str(tmp_path / "home" / ".tik"),
                PYTHONPATH=os.pathsep.join([str(site), str(ROOT)]),
                OMP_NUM_THREADS="1")


def _cli(env, *args, timeout=180):
    out = subprocess.run(
        [sys.executable, "-m", "cloudtik_tpu_torch.scripts.cli", *args],
        cwd=str(ROOT), env=env, capture_output=True, text=True,
        timeout=timeout)
    assert out.returncode == 0, (args, out.stdout[-2000:],
                                 out.stderr[-3000:])
    return out.stdout + out.stderr


def _scrape(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.read().decode()


def _request_count(text):
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith("tik_serve_requests_total"))


def test_lifecycle_on_the_cpu(tmp_path):
    """`validate`, `start -y`, `status`, one traced request to the head's
    `ServingRuntime` (tiny, on the CPU), `cluster trace export`,
    `cluster-dump` and `stop`, each a `python -m
    cloudtik_tpu_torch.scripts.cli` process where `import jax` raises.
    The request's spans come once and its counter counts one, though the
    head's process serves its registry as the `telemetry` job and the
    runtime would otherwise serve it again as `serving-telemetry`."""
    from cloudtik_tpu_torch.models import generate as G
    from cloudtik_tpu_torch.serve.server import engine_backend

    home = tmp_path / "home"
    env = _no_jax_env(tmp_path)
    env.pop("TIK_EVENTS_PATH", None)
    serve_port, telemetry_port, state_port, prom_port = (
        _free_port() for _ in range(4))
    config = yaml.safe_load((ROOT / "examples" /
                             "serving-cluster.yaml").read_text())
    config.update({
        "cluster_name": "life", "state_port": state_port,
        "telemetry_port": telemetry_port,
        "provider": {"type": "virtual", "root_dir": str(tmp_path / "v")},
        "auth": {"executor": "local"}})
    config["runtime"] = {
        "types": ["prometheus", "serving"],
        "prometheus": {"port": prom_port, "scrape_interval_s": 60},
        "serving": {"model": "tiny", "device": "cpu", "engine": True,
                    "slots": 2, "max_len": 64, "port": serve_port}}
    path = tmp_path / "life.yaml"
    path.write_text(yaml.safe_dump(config))
    prompt, new = [5, 6, 7, 8, 9], 4

    # the served tokens: the port's `generate` on the seed-0 params
    backend = engine_backend("tiny", slots=2, max_len=64, device="cpu")
    backend.engine.stop()
    want = G.generate(backend.params, torch.tensor([prompt]), backend.cfg,
                      max_new_tokens=new)[0].tolist()

    assert "valid" in _cli(env, "validate", str(path))
    _cli(env, "start", str(path), "-y")
    pid_file = home / ".tik" / "run" / "node-services-life.pid"
    try:
        pid = int(_wait("pidfile", lambda: pid_file.exists()
                        and pid_file.read_text().strip()))
        assert "up-to-date" in _cli(env, "status", str(path))
        base = f"http://127.0.0.1:{serve_port}"
        _wait("the server", lambda: _ok(base + "/healthz"), 120)
        trace_id = "ab" * 16
        req = urllib.request.Request(
            base + "/v1/generate",
            data=json.dumps({"tokens": [prompt],
                             "max_new_tokens": new}).encode(),
            headers={"Content-Type": "application/json",
                     "traceparent": f"00-{trace_id}-{'1' * 16}-01"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert json.loads(resp.read())["tokens"] == [want]

        # one endpoint serves the registry: the spans come once, the
        # counter counts one
        conf = home / ".tik" / "prometheus"
        targets = json.loads((conf / "targets.json").read_text())
        jobs = sorted(g["labels"]["job"] for g in targets)
        assert "telemetry" in jobs and SR.TELEMETRY_SERVICE not in jobs
        exported = tmp_path / "trace.json"
        _cli(env, "cluster", "trace", "export", "--trace-id", trace_id,
             "-o", str(exported))
        trace = json.loads(exported.read_text())
        spans = [(e["name"], e["ts"], e["dur"]) for e in
                 trace["traceEvents"] if e.get("ph") == "X"]
        names = sorted(n for n, _, _ in spans)
        assert {"serve.enqueue", "serve.prefill", "serve.decode"} <= \
            set(names)
        assert len(spans) == len(set(spans))
        assert names.count("serve.enqueue") == 1
        scraped = [_scrape(f"http://{g['targets'][0]}/metrics")
                   for g in targets if g["labels"]["job"] == "telemetry"]
        assert sum(_request_count(t) for t in scraped) == 1

        # the dump holds the bootstrap config, the node-services log and
        # the journal with the boot and the request's events
        out = tmp_path / "dump.tar.gz"
        _cli(env, "cluster-dump", str(path), "-o", str(out))
        with tarfile.open(out) as tar:
            members = {m.name: m for m in tar.getmembers()}
            journal = [n for n in members if n.endswith(
                "/events/events.jsonl")]
            assert len(journal) == 1
            lines = tar.extractfile(members[journal[0]]).read().decode()
        assert any(n.endswith("/config/bootstrap-config.yaml")
                   for n in members)
        assert any(n.endswith("/node-services.log") for n in members)
        recorded = {json.loads(line)["name"] for line in lines.splitlines()}
        assert {"tik_node_services_start", "tik_serve_admission"} <= recorded

        _cli(env, "stop", str(path), "-y")
        _wait("the node services gone", lambda: not _pid_alive(pid), 60)
        assert not _ok(base + "/healthz")
    finally:
        if pid_file.exists():
            os.kill(int(pid_file.read_text()), signal.SIGTERM)
        subprocess.run([sys.executable, "-m",
                        "cloudtik_tpu_torch.scripts.cli", "stop", str(path),
                        "-y", "--hard"], cwd=str(ROOT), env=env,
                       capture_output=True, timeout=120)
    provider = create_node_provider(config["provider"], "life")
    assert provider.non_terminated_nodes({}) == []


def _ok(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return resp.status == 200
    except OSError:
        return False


# ----------------------------------------------------------- --help --------

def _commands(group, prefix=()):
    import click
    for name, cmd in sorted(group.commands.items()):
        yield prefix + (name,)
        if isinstance(cmd, click.Group):
            yield from _commands(cmd, prefix + (name,))


def test_every_commands_help_runs_without_jax():
    """Every command of the port's CLI prints its help in one process
    where `import jax` and `import cloudtik_tpu` raise, and the commands
    are the reference's."""
    from cloudtik_tpu.scripts import cli as JCLI
    from cloudtik_tpu_torch.scripts import cli as TCLI

    commands = list(_commands(TCLI.cli))
    assert commands == list(_commands(JCLI.cli))
    code = (_SITE_NO_JAX + "import io, json, contextlib\n"
            "from cloudtik_tpu_torch.scripts.cli import cli\n"
            "out = {}\n"
            f"for args in {commands!r}:\n"
            "    buf = io.StringIO()\n"
            "    with contextlib.redirect_stdout(buf):\n"
            "        try:\n"
            "            cli.main(list(args) + ['--help'], prog_name='tik')\n"
            "        except SystemExit as e:\n"
            "            out[' '.join(args)] = (e.code, buf.getvalue())\n"
            "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    helps = json.loads(proc.stdout)
    assert len(helps) == len(commands) >= 60
    for args, (code, text) in helps.items():
        assert code == 0 and text.startswith(f"Usage: tik {args}"), args


@pytest.mark.parametrize("module", ["providers.onpremise.simulator",
                                    "providers.kubernetes.operator"])
def test_provider_entry_points_help_runs_without_jax(module, tmp_path):
    """`tik-simulator` and `tik-operator` with `--help`, the port's where
    `import jax` and `import cloudtik_tpu` raise: neither main parses
    options (the simulator opens its first argument as the machine file,
    the operator needs the `kubernetes` client), so each ends as the
    reference's does, and nothing of JAX is reached on the way."""
    outs = {}
    for package, env in (("cloudtik_tpu", dict(os.environ)),
                         ("cloudtik_tpu_torch", _no_jax_env(tmp_path))):
        proc = subprocess.run(
            [sys.executable, "-m", f"{package}.{module}", "--help"],
            cwd=str(ROOT), env=env, capture_output=True, text=True,
            timeout=60)
        last = proc.stderr.strip().splitlines()[-1] if proc.stderr else ""
        outs[package] = (proc.returncode, last)
        assert "jax" not in proc.stderr, proc.stderr[-2000:]
    assert outs["cloudtik_tpu_torch"] == outs["cloudtik_tpu"]


def test_chaos_run_drills_an_onpremise_cluster_without_jax(tmp_path):
    """The port's `chaos run` on an `onpremise` cluster
    (`templates/onpremise/defaults.yaml`) against a `tik-simulator` pool of
    two machines, each its own process where `import jax` and `import
    cloudtik_tpu` raise: the planted launch failure fires once, the
    launcher's retry brings both workers up, and the pool holds them."""
    env = _no_jax_env(tmp_path)
    (tmp_path / "machines.json").write_text(json.dumps(
        [{"ip": "127.0.0.1"}, {"ip": "127.0.0.2"}]))
    sim = subprocess.Popen(
        [sys.executable, "-u", "-m",
         "cloudtik_tpu_torch.providers.onpremise.simulator",
         str(tmp_path / "machines.json"), "0"],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = sim.stdout.readline()
        assert line.startswith("tik-simulator serving 2 machines on :"), (
            line, sim.stderr.read() if sim.poll() is not None else "")
        port = int(line.rsplit(":", 1)[1])
        (tmp_path / "plan.yaml").write_text(
            "seed: 3\nname: onpremise-drill\nfaults:\n"
            "  - seam: provider.create_node\n    kind: raise\n"
            "    times: 1\n")
        (tmp_path / "cluster.yaml").write_text(yaml.safe_dump({
            "cluster_name": "drill", "from": "onpremise/defaults",
            "provider": {"type": "onpremise",
                         "cloud_simulator_address": f"127.0.0.1:{port}"},
            "auth": {"executor": "local"}, "runtime": {"types": []},
            "available_node_types": {
                "head": {"node_config": {}, "resources": {"CPU": 2}},
                "worker": {"node_config": {}, "resources": {"CPU": 2},
                           "min_workers": 2, "max_workers": 2}},
            "head_node_type": "head", "max_workers": 2}))
        out = subprocess.run(
            [sys.executable, "-m", "cloudtik_tpu_torch.scripts.cli",
             "chaos", "run", str(tmp_path / "plan.yaml"), "--config",
             str(tmp_path / "cluster.yaml"), "--passes", "3",
             "--interval", "1.0", "--json"],
            cwd=str(ROOT), env=env, capture_output=True, text=True,
            timeout=120)
        assert out.returncode == 0, out.stderr[-3000:]
        result = json.loads(out.stdout)
        assert [(e["seam"], e["fired"]) for e in result["trace"]] == [
            ("provider.create_node", 1)]
        assert result["errors"] == []
        assert result["summary"]["workers_by_type"] == {"worker": 2}
        request = urllib.request.Request(
            f"http://127.0.0.1:{port}", method="POST",
            data=json.dumps({"op": "list", "cluster": "drill"}).encode())
        with urllib.request.urlopen(request, timeout=10) as resp:
            machines = json.loads(resp.read())["machines"]
        assert sorted(m["ip"] for m in machines) == ["127.0.0.1",
                                                     "127.0.0.2"]
        assert {m["tags"]["tik-node-kind"] for m in machines} == {"worker"}
    finally:
        sim.kill()
        sim.wait(timeout=10)


# ------------------------------------------------ the card by default ------

@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is "
                    "present")
def test_serving_runtime_runs_on_the_card_unless_asked_for_the_cpu():
    """The head's `ServingRuntime` without a `device` serves on the card,
    so off the card its start raises; the lifecycle above asks for the
    CPU."""
    from cloudtik_tpu_torch.control.state import InMemoryStateBackend

    context = {"is_head": True, "node_id": "head", "node_ip": "127.0.0.1",
               "state_client": StateClient(InMemoryStateBackend()),
               "config": {"cluster_name": "card", "workspace_name": "w"}}
    runtime = SR.ServingRuntime({"model": "tiny", "engine": True,
                                 "port": 0, "telemetry_port": 0})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runtime.node_services(context, "start")
    assert runtime.instance_key(context) not in SR._servers
