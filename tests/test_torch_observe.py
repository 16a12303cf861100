"""The port's serving metrics on the cluster's scrape path.

The serving runtime serves the port's telemetry registry on a port of its
own (`serving-telemetry`) and installs the port's flight recorder beside
the reference's journal; the port's discovery sync renders its registry;
the port's prometheus runtime, collector, SLO engine, scaling policies,
registry and tokenizer give the reference's answers on the same inputs.
The one recorded difference is the `serve-demand` policy's default
resource, `{"GPU": 1}` where the reference asks for `{"TPU": 4}`.
"""

import json
import socket
import subprocess
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import quote

import pytest
import torch

from cloudtik_tpu.control import scaling_policies as JSP
from cloudtik_tpu.control.state import InMemoryStateBackend as JBackend
from cloudtik_tpu.control.state import StateClient as JClient
from cloudtik_tpu.runtimes.discovery import sync as JSY
from cloudtik_tpu.runtimes.discovery.runtime import ServiceRegistry as JSR
from cloudtik_tpu.runtimes.prometheus import collector as JCO
from cloudtik_tpu.runtimes.prometheus import runtime as JP
from cloudtik_tpu.serve import replicas as JRP
from cloudtik_tpu.telemetry import core as JC
from cloudtik_tpu.telemetry import events as JEV
from cloudtik_tpu.telemetry import slo as JSLO
from cloudtik_tpu.train import tokenizer as JTK
from cloudtik_tpu_torch.control import scaling_policies as TSP
from cloudtik_tpu_torch.control.state import InMemoryStateBackend as TBackend
from cloudtik_tpu_torch.control.state import StateClient as TClient
from cloudtik_tpu_torch.runtimes import registry as TREG
from cloudtik_tpu_torch.runtimes.discovery import sync as TSY
from cloudtik_tpu_torch.runtimes.discovery.runtime import (
    ServiceRegistry as TSR)
from cloudtik_tpu_torch.runtimes.nodex.runtime import NodexRuntime
from cloudtik_tpu_torch.runtimes.prometheus import collector as TCO
from cloudtik_tpu_torch.runtimes.prometheus import runtime as TP
from cloudtik_tpu_torch.runtimes.serving import runtime as SR
from cloudtik_tpu_torch.serve import replicas as TRP
from cloudtik_tpu_torch.telemetry import core as TC
from cloudtik_tpu_torch.telemetry import events as TEV
from cloudtik_tpu_torch.telemetry import export as TX
from cloudtik_tpu_torch.telemetry import instruments as TI
from cloudtik_tpu_torch.telemetry import names as TN
from cloudtik_tpu_torch.telemetry import slo as TSLO
from cloudtik_tpu_torch.train import tokenizer as TTK

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SERVING_NAME = "cloudtik_tpu_torch.runtimes.serving.runtime:ServingRuntime"
PROMPT = [5, 6, 7, 11, 13]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read()


@pytest.fixture
def telemetry_on():
    was = (JC.STATE.enabled, TC.STATE.enabled)
    for core in (JC, TC):
        core.enable()
        core.reset()
    try:
        yield
    finally:
        for core, on in zip((JC, TC), was):
            core.STATE.enabled = on


@pytest.fixture
def tik_home(tmp_path, monkeypatch):
    home = tmp_path / "home"
    monkeypatch.setenv("TIK_HOME", str(home))
    monkeypatch.delenv("TIK_EVENTS_PATH", raising=False)
    return home


# ------------------------------------------------ the serving process (F1) --

@pytest.fixture
def node_context(tmp_path):
    return {"is_head": True, "node_id": "head", "node_ip": "127.0.0.1",
            "state_client": TClient(TBackend()),
            "config": {"cluster_name": "gpu1", "workspace_name": "w1"},
            "conf_dir": str(tmp_path)}


def test_serving_runtime_serves_the_ports_metrics_and_journal(
        node_context, telemetry_on, tik_home):
    """F1: the reference's node-services process runs the port's
    ServeServer; the port's engine records in the port's registry and
    journals through the port's flight recorder, which only the serving
    runtime itself can expose and install in that process."""
    port = _free_port()
    rt = SR.ServingRuntime({"model": "tiny", "engine": True, "slots": 2,
                            "max_len": 64, "port": 0, "device": "cpu",
                            "telemetry_port": port})
    registry = TSR(node_context["state_client"], "gpu1", "w1")
    assert TEV.installed() is None
    try:
        rt.node_services(node_context, "start")
        server = SR._servers[("gpu1", "serving")]
        journal = TEV.installed()
        assert journal is not None
        assert Path(journal.path) == tik_home / "logs" / "events-torch.jsonl"
        # never the file the reference's own journal appends to
        assert Path(journal.path) != Path(JEV.default_path())
        assert [(s["port"], s["protocol"]) for s in registry.query(
            SR.TELEMETRY_SERVICE)] == [(port, "http")]
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/generate",
            data=json.dumps({"tokens": [PROMPT],
                             "max_new_tokens": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
        status, body = _get(f"http://127.0.0.1:{port}/metrics")
        text = body.decode()
        assert status == 200
        assert "tik_serve_ttft_seconds_count 1" in text
        assert 'tik_serve_requests_total{result="ok"} 1' in text
        # the serving port itself still answers no /metrics (as the
        # reference's server): the telemetry port is the scrape target
        with pytest.raises(urllib.error.HTTPError):
            _get(f"http://127.0.0.1:{server.port}/metrics")
    finally:
        rt.node_services(node_context, "stop")
    assert TEV.installed() is None
    assert registry.query(SR.TELEMETRY_SERVICE) == []
    with pytest.raises(OSError):
        _get(f"http://127.0.0.1:{port}/metrics", timeout=2)
    # the reference's reader takes the port's records (`tik events dump
    # --path`): the admission of the one request
    names = [r["name"] for r in JEV.read_events(journal.path)]
    assert names.count("tik_serve_admission") == 1


def test_stitched_trace_holds_the_ports_serve_spans(node_context,
                                                    telemetry_on, tik_home):
    """F3: the port's collector scrapes `serving-telemetry` for traces, so
    the stitched trace of one answered request holds its serve.* spans
    under the one trace id of its `x-tik-traceparent`, in the serving
    process's lane; the head's telemetry job on the same host is a lane of
    its own."""
    from cloudtik_tpu_torch.runtimes.prometheus.trace_collector import (
        TraceCollector)
    from cloudtik_tpu_torch.telemetry import http as THTTP

    port = _free_port()
    rt = SR.ServingRuntime({"model": "tiny", "engine": True, "slots": 2,
                            "max_len": 64, "port": 0, "device": "cpu",
                            "telemetry_port": port})
    head = THTTP.start_server(0, host="127.0.0.1")
    config = {"cluster_name": "gpu1", "telemetry_port": head.port,
              "runtime": {"types": ["serving"], "serving": {
                  "telemetry_port": port}}}
    conf = Path(node_context["conf_dir"]) / "prometheus"
    TP.PrometheusRuntime({}).node_configure({
        "is_head": True, "config": config, "head_ip": "127.0.0.1",
        "conf_dir": str(conf)})
    try:
        rt.node_services(node_context, "start")
        server = SR._servers[("gpu1", "serving")]
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/generate",
            data=json.dumps({"tokens": [PROMPT],
                             "max_new_tokens": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            trace_id = resp.headers["x-tik-traceparent"].split("-")[1]
        collector = TraceCollector(str(conf))
        trace, sources = collector.export(trace_id=trace_id)
        summary = {r["trace_id"]: r for r in collector.summary()}
    finally:
        rt.node_services(node_context, "stop")
        head.stop()
    assert {s["labels"]["job"]: s["address"] for s in sources} == {
        "serving-telemetry": f"127.0.0.1:{port}",
        "telemetry": f"127.0.0.1:{head.port}"}
    assert not [s["error"] for s in sources if s["error"]]
    lanes = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M"}
    assert len(set(lanes.values())) == len(lanes) == 2
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert {e["args"]["trace_id"] for e in spans} == {trace_id}
    serving = [e for e in spans
               if lanes[e["pid"]].startswith("serving-telemetry ")]
    assert {"serve.enqueue", "serve.prefill", "serve.decode"} <= {
        e["name"] for e in serving}
    assert summary[trace_id]["spans"] >= 3
    assert any(n.startswith("serving-telemetry ")
               for n in summary[trace_id]["nodes"])


def test_telemetry_port_0_turns_it_off(node_context, telemetry_on,
                                       tik_home):
    rt = SR.ServingRuntime({"model": "tiny", "port": 0, "device": "cpu",
                            "telemetry_port": 0})
    assert "serving-telemetry" not in rt.get_runtime_services({}, "10.0.0.2")
    try:
        rt.node_services(node_context, "start")
        assert TEV.installed() is None
        assert ("gpu1", "serving") not in SR._telemetry
        assert TSR(node_context["state_client"], "gpu1", "w1").query(
            SR.TELEMETRY_SERVICE) == []
    finally:
        rt.node_services(node_context, "stop")


def test_journal_path_keeps_the_events_override_apart(monkeypatch,
                                                      tmp_path):
    monkeypatch.setenv("TIK_EVENTS_PATH", str(tmp_path / "ev.jsonl"))
    assert SR.journal_path() == str(tmp_path / "ev-torch.jsonl")
    assert SR.journal_path({"events_path": "~/x.jsonl"}) == \
        str(Path("~/x.jsonl").expanduser())


@pytest.mark.parametrize("side,name", [
    ("reference", SERVING_NAME), ("port", SERVING_NAME), ("port", "serving")])
def test_serving_telemetry_is_a_declared_scrape_target(side, name,
                                                       telemetry_on):
    """F1: both prometheus runtimes render the serving process's telemetry
    port as a target (the reference's registry loads the port's class by
    module and class; the port's also by its short name)."""
    config = {"cluster_name": "c", "runtime": {"types": [name], name: {
        "port": 8300, "telemetry_port": 9200}}}
    mod = JP if side == "reference" else TP
    services = mod._declared_http_services(config, "10.0.0.2")
    node = [{"node_id": "head", "ip": "10.0.0.2"}]
    assert services == {
        "serving": {"port": 8300, "protocol": "http", "cluster": "c",
                    "nodes": node},
        "serving-telemetry": {"port": 9200, "protocol": "http",
                              "cluster": "c", "nodes": node}}


# ------------------------------------------------- the discovery sync (F2) --

def _registry(client, SRcls):
    registry = SRcls(client, "c", "w")
    registry.register("serving-telemetry", "head", "10.0.0.2", 9104,
                      protocol="http")
    registry.register("discovery", "head", "10.0.0.2", 6879,
                      protocol="tcp")
    return registry


def test_discovery_sync_renders_targets_and_hosts(tmp_path, telemetry_on,
                                                  capsys):
    """F2: the port's sync imported a prometheus runtime the port did not
    have, so every pass failed; now targets.json lists the http service
    only and hosts.tik both, as the reference's sync writes them."""
    registry = _registry(TClient(TBackend()), TSR)
    TSY.render_once(registry, str(tmp_path / "port"))
    targets = json.loads(
        (tmp_path / "port" / "prometheus" / "targets.json").read_text())
    assert targets == [{"targets": ["10.0.0.2:9104"],
                        "labels": {"job": "serving-telemetry",
                                   "cluster": "c"}}]
    hosts = (tmp_path / "port" / "dns" / "hosts.tik").read_text()
    assert hosts.splitlines() == ["10.0.0.2 discovery.c.w.tik",
                                  "10.0.0.2 serving-telemetry.c.w.tik"]
    JSY.render_once(_registry(JClient(JBackend()), JSR),
                    str(tmp_path / "ref"))
    for rel in ("prometheus/targets.json", "dns/hosts.tik"):
        assert (tmp_path / "port" / rel).read_text() == \
            (tmp_path / "ref" / rel).read_text()
    TSY.run_loop(registry, str(tmp_path / "loop"), 1.0, max_iterations=1)
    assert TI.DISCOVERY_SYNCS.value(result="ok") == 1
    assert not TI.DISCOVERY_SYNCS.value(result="failed")
    assert "render failed" not in capsys.readouterr().out


# -------------------------------------------------- the prometheus runtime --

def test_prometheus_runtimes_write_equal_files(tmp_path, telemetry_on):
    config = {"cluster_name": "c", "telemetry_port": 9103, "runtime": {
        "types": ["nodex", "prometheus", "discovery", "profiler",
                  SERVING_NAME],
        SERVING_NAME: {"port": 8300},
        "prometheus": {"alert_thresholds": {"cpu_threshold": 90.0}}}}
    written = {}
    for side, mod in (("ref", JP), ("port", TP)):
        conf = tmp_path / side
        ctx = {"is_head": True, "config": config, "head_ip": "10.0.0.2",
               "conf_dir": str(conf)}
        rt = mod.PrometheusRuntime(config["runtime"]["prometheus"])
        rt.node_configure(ctx)
        written[side] = {
            name: (conf / name).read_text().replace(str(conf), "<conf>")
            for name in ("targets.json", "prometheus.yml", "alerts.yml")}
        written[side]["cmd"] = rt.service_command(ctx)
    assert written["port"]["cmd"][1:3] == [
        "-m", "cloudtik_tpu_torch.runtimes.prometheus.collector"]
    for name in ("targets.json", "prometheus.yml", "alerts.yml"):
        assert written["port"][name] == written["ref"][name], name
    jobs = {g["labels"]["job"]
            for g in json.loads(written["port"]["targets.json"])}
    assert jobs == {"nodex", "prometheus", "profiler", "serving",
                    "serving-telemetry", "telemetry"}


def test_telemetry_target_follows_the_ports_switch(tmp_path, telemetry_on):
    config = {"cluster_name": "c", "runtime": {"types": []}}
    ctx = {"is_head": True, "config": config, "conf_dir": str(tmp_path)}
    TC.disable()
    TP.PrometheusRuntime({}).node_configure(ctx)
    assert json.loads((tmp_path / "targets.json").read_text()) == []
    TC.enable()
    TP.PrometheusRuntime({}).node_configure(ctx)
    assert [g["labels"]["job"] for g in json.loads(
        (tmp_path / "targets.json").read_text())] == ["telemetry"]


# ---------------------------------------------------- the runtime registry --

@pytest.mark.parametrize("name", ["ai", "serving", "discovery",
                                  "prometheus", "nodex", "profiler"])
def test_registry_maps_the_ports_runtimes(name):
    cls = TREG.get_runtime_cls(name)
    assert cls.__module__.startswith("cloudtik_tpu_torch.runtimes.")
    assert cls.__name__ == TREG._BUILT_IN[name].rsplit(":", 1)[1]


@pytest.mark.parametrize("name", ["spark", "etcd", "mount"])
def test_registry_refuses_what_the_port_lacks(name):
    """The port has every built-in runtime now (F4); what it lacks is the
    JAX package's classes, which an external name must not load."""
    from cloudtik_tpu.runtimes import registry as JREG

    external = JREG._BUILT_IN[name]
    assert external.startswith("cloudtik_tpu.runtimes.")
    with pytest.raises(TREG.UnknownRuntimeError, match="JAX package"):
        TREG.get_runtime_cls(external)
    assert TREG.get_runtime_cls(name).__module__ == \
        external.split(":")[0].replace("cloudtik_tpu.", "cloudtik_tpu_torch.")
    with pytest.raises(TREG.UnknownRuntimeError):
        TREG.get_runtime_cls("no-such-runtime")


def test_registry_loads_module_and_class_and_orders_as_the_reference():
    (rt,) = TREG.iter_runtimes({"runtime": {"types": [SERVING_NAME],
                                            SERVING_NAME: {"port": 1}}})
    assert type(rt) is SR.ServingRuntime
    assert rt.registered_name == SERVING_NAME
    from cloudtik_tpu.runtimes import registry as JREG

    names = ["prometheus", "nodex", "discovery", "ai"]
    config = {"runtime": {"types": names}}
    assert [r.registered_name for r in TREG.iter_runtimes(config)] == \
        [r.registered_name for r in JREG.iter_runtimes(config)]
    assert TREG.DEFAULT_RUNTIMES == JREG.DEFAULT_RUNTIMES


# ---------------------------------------------------------- the collectors --

class _FakeTarget:
    """One /metrics whose exposition the test sets cycle by cycle."""

    def __init__(self):
        target = self
        self.text = ""

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                data = target.text.encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.address = f"127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def _recorded_expositions(cycles: int = 12):
    """A serving process's expositions, one a scrape cycle: the port's
    registry after each cycle's requests (fast TTFTs, then a slow spell
    and an error)."""
    out = []
    for cycle in range(cycles):
        slow = 4 <= cycle < 9
        for i in range(3):
            TI.SERVE_TTFT.observe(3.1 + i if slow and i else 0.2 + 0.1 * i)
            TI.SERVE_TPOT.observe(0.02)
            TI.SERVE_REQUESTS.inc(result="error" if slow and i == 2
                                  else "ok")
        out.append(TX.render_prometheus())
    return out


QUERIES = ("tik_serve_ttft_seconds_count",
           'tik_serve_requests_total{result="ok"}',
           'tik_serve_requests_total{result!="ok",job=~"serv.*"}',
           'tik_serve_ttft_seconds_bucket{le="2.5"}', "no_such_metric")


def test_collectors_answer_alike(tmp_path, telemetry_on, monkeypatch):
    """Both collectors scrape one fake target through the same cycles on
    one fake clock: their /api/v1/query, query_range, slos and alerts
    answers are equal."""
    texts = _recorded_expositions()
    target = _FakeTarget()
    (tmp_path / "targets.json").write_text(json.dumps([{
        "targets": [target.address],
        "labels": {"job": "serving-telemetry", "cluster": "c"}}]))
    clock = [1_000_000.0]
    fake_time = types.SimpleNamespace(time=lambda: clock[0],
                                      perf_counter=time.perf_counter)
    servers = {}
    try:
        for side, mod in (("ref", JCO), ("port", TCO)):
            monkeypatch.setattr(mod, "time", fake_time)
            c = mod.Collector(str(tmp_path), scrape_interval_s=1.0,
                              window_cycles=10)
            http = ThreadingHTTPServer(("127.0.0.1", 0),
                                       mod.make_handler(c))
            threading.Thread(target=http.serve_forever, daemon=True).start()
            servers[side] = (c, http)
        slos = []
        for text in texts:
            target.text = text
            clock[0] += 1.0
            for c, _ in servers.values():
                c.scrape_once()
                c.evaluate_alerts()
            answers = {}
            for side, (c, http) in servers.items():
                base = f"http://127.0.0.1:{http.server_address[1]}"
                got = {q: json.loads(_get(
                    f"{base}/api/v1/query?query={quote(q)}")[1])
                    for q in QUERIES}
                got["range"] = json.loads(_get(
                    f"{base}/api/v1/query_range?window=4&query="
                    + quote("tik_serve_ttft_seconds_count"))[1])
                for path in ("/api/v1/slos", "/api/v1/alerts"):
                    got[path] = json.loads(_get(base + path)[1])
                answers[side] = got
            assert answers["port"] == answers["ref"]
            slos.append({r["name"]: r for r in
                         answers["port"]["/api/v1/slos"]["data"]["slos"]})
        # the slow spell fired serve-ttft and its burns stayed finite
        assert any(s["serve-ttft"]["state"] == "firing" for s in slos)
        assert slos[-1]["serve-ttft"]["burn_fast"] is not None
    finally:
        target.close()
        for _, http in servers.values():
            http.shutdown()
            http.server_close()


def test_slo_evaluation_of_one_exposition_matches(telemetry_on):
    text = _recorded_expositions(6)[-1]

    def untimed(rows):
        return [{k: v for k, v in r.items() if k not in ("since",
                                                          "last_eval")}
                for r in rows]

    got = untimed(TSLO.evaluate_exposition(text))
    assert got == untimed(JSLO.evaluate_exposition(text))
    assert got[0]["state"] == "firing"
    assert [s.name for s in TSLO.default_slos()] == \
        [s.name for s in JSLO.default_slos()]


# ----------------------------------------------------- the scaling policies --

def _policy_inputs(side):
    client = JClient(JBackend()) if side == "ref" else TClient(TBackend())
    client.table_put("metrics", "n1", {
        "cpu_percent": 95.0, "memory_percent": 10.0, "node_ip": "10.0.0.3",
        "time": 100.0, "total_resources": {"CPU": 8},
        "available_resources": {"CPU": 1}})
    client.table_put("metrics", "n2", {
        "cpu_percent": 5.0, "memory_percent": 20.0, "node_ip": "10.0.0.4",
        "time": 100.0})
    return client


POLICIES = {
    "scaling-with-resources": None,
    "scaling-with-load": {"scaling_step_resource": {"GPU": 8}},
    "scaling-with-time": {"scaling_periods": [
        {"start": "00:00", "end": "24:00", "min_workers": 2}],
        "resource_per_worker": {"GPU": 8}},
    "scaling-by-node-type": {"node_type_counts": {"a3": 2, "cpu": 1}},
    "serve-demand": {"resource_per_replica": {"GPU": 8}},
}
CONFIG = {"available_node_types": {
    "a3": {"resources": {"GPU": 8, "CPU": 208}},
    "cpu": {"resources": {"CPU": 4}}}}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_create_scaling_policy_gives_the_references_demands(name):
    got = {}
    for side, mod in (("ref", JSP), ("port", TSP)):
        client = _policy_inputs(side)
        policy = mod.create_scaling_policy(
            name, CONFIG, "head", state_client=client,
            scaling_config=POLICIES[name])
        assert policy.name() == name
        if name == "scaling-with-resources":
            policy.set_requests([{"GPU": 8}, {"CPU": 2}])
        state = policy.get_scaling_state()
        got[side] = (state.autoscaling_instructions["resource_demands"],
                     state.node_resource_states)
    assert got["port"] == got["ref"]
    assert TSP.create_scaling_policy("none", {}, "head") is None
    with pytest.raises(ValueError):
        TSP.create_scaling_policy("nope", {}, "head")


@pytest.mark.parametrize("roles", [False, True])
def test_serve_demand_on_one_registry_state(roles):
    """tests/test_fabric.py's role-split fleet (and a monolithic one) on
    both policies: equal demands with an explicit resource, role tags
    included; by default the port asks one GPU a replica."""
    got = {}
    for side, mod, RP in (("ref", JSP, JRP), ("port", TSP, TRP)):
        client = _policy_inputs(side)
        registry = RP.ReplicaRegistry(client)
        if roles:
            registry.register("p0", None, role=RP.ROLE_PREFILL, slots=2)
            registry.register("d0", None, role=RP.ROLE_DECODE, slots=4)
            registry.register("d1", None, role=RP.ROLE_DECODE, slots=4)
        else:
            registry.register("e0", "http://e0", slots=4)
        demands = {}
        for label, sc in (("explicit", {"resource_per_replica": {"TPU": 8}}),
                          ("default", {})):
            policy = mod.create_scaling_policy(
                "serve-demand", {}, "head", state_client=client,
                scaling_config=sc)
            demands[label] = policy.get_scaling_state() \
                .autoscaling_instructions["resource_demands"]
        got[side] = demands
    assert got["port"]["explicit"] == got["ref"]["explicit"]
    if roles:
        assert got["port"]["explicit"] == (
            [{"TPU": 8, "tik-serve-role-decode": 1}] * 2
            + [{"TPU": 8, "tik-serve-role-prefill": 1}])
        assert got["port"]["default"] == (
            [{"GPU": 1, "tik-serve-role-decode": 1}] * 2
            + [{"GPU": 1, "tik-serve-role-prefill": 1}])
    else:
        assert got["port"]["default"] == [{"GPU": 1}]
        assert got["ref"]["default"] == [{"TPU": 4}]


def test_serve_demand_reads_the_burn_from_the_collector(tmp_path):
    """`slo_url` wires the port's burn source to a collector's
    /api/v1/slos, as the reference's does."""
    rows = {"status": "success", "data": {"slos": [
        {"name": "serve-ttft", "burn_fast": 3.0, "burn_slow": 2.5}]}}
    target = _FakeTarget()
    target.text = json.dumps(rows)
    try:
        url = f"http://{target.address}"
        assert TRP.slo_burn_source(url)() == {"fast": 3.0, "slow": 2.5}
        policy = TSP.create_scaling_policy(
            "serve-demand", {}, "head", state_client=TClient(TBackend()),
            scaling_config={"slo_url": url})
        assert policy.autoscaler.burn_source() == {"fast": 3.0, "slow": 2.5}
    finally:
        target.close()


# ---------------------------------------------------------- the exporter --

def test_node_exporter_serves_the_node_gauges_under_the_ports_names():
    port = _free_port()
    cmd = NodexRuntime({"port": port, "interval_s": 0.5}).service_command(
        {"is_head": True})
    from cloudtik_tpu.runtimes.nodex.runtime import NodexRuntime as JN

    ref = JN({"port": port, "interval_s": 0.5}).service_command({})
    assert cmd[:2] + cmd[3:] == ref[:2] + ref[3:]
    assert cmd[2] == "cloudtik_tpu_torch.runtimes.nodex.exporter"
    proc = subprocess.Popen(cmd, cwd=str(ROOT), stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                text = _get(f"http://127.0.0.1:{port}/metrics",
                            timeout=2)[1].decode()
                if "tik_node_net_recv_bytes" in text:
                    break
            except OSError:
                pass
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.1)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    names = {line.split("{")[0].split(" ")[0] for line in text.splitlines()
             if line and not line.startswith("#")}
    assert {"tik_node_cpu_percent", "tik_node_memory_percent",
            "tik_node_disk_percent", "tik_node_net_sent_bytes",
            "tik_node_net_recv_bytes"} <= names
    assert names <= set(TN.METRICS)


# ---------------------------------------------------------- the tokenizer --

@pytest.mark.parametrize("suffix", [".npy", ".bin"])
def test_encode_corpus_writes_the_references_file(tmp_path, suffix):
    text = "\n\n".join(
        ["the first document", "", "  ", "ünïcode — and ✓ marks",
         "x" * 5000] + [f"doc {i} " * (i % 7 + 1) for i in range(300)])
    (tmp_path / "corpus.txt").write_text(text)
    counts = {}
    for side, mod in (("ref", JTK), ("port", TTK)):
        counts[side] = mod.encode_corpus(
            str(tmp_path / "corpus.txt"), str(tmp_path / f"{side}{suffix}"),
            chunk_chars=1000)
    assert counts["port"] == counts["ref"] > 0
    assert (tmp_path / f"port{suffix}").read_bytes() == \
        (tmp_path / f"ref{suffix}").read_bytes()
    tok = TTK.get_tokenizer()
    ids = tok.encode("ünïcode", add_bos=True, add_eos=True)
    assert ids == JTK.get_tokenizer().encode("ünïcode", add_bos=True,
                                              add_eos=True)
    assert tok.decode(ids) == "ünïcode"
