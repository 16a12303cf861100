"""The port's operator CLI (`python -m cloudtik_tpu_torch.scripts.cli`)
against the reference's `tik`, on the same records.

A port fabric on the CPU (one prefill replica, one decode replica, the
port's router in front, `tiny` in f32) serves requests with the port's
request ledger, router ledger and flight recorder installed, and the
port's telemetry server exposing its spans.  Each ported command (`serve
requests|replicas|explain`, `cluster trace export|summary`, `events
dump|tail`) then runs through click's `CliRunner` in both packages over
those records, and its output and exit code must be the reference's.  The
one difference is recorded (F3): the port's trace collector also scrapes
the `serving-telemetry` job.  A subprocess in which `import jax` raises
runs the port's `serve requests --stats`.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import types
import urllib.request
from pathlib import Path

import pytest
import torch
from click.testing import CliRunner

from cloudtik_tpu.scripts import cli as JCLI
from cloudtik_tpu_torch.models import transformer as TT
from cloudtik_tpu_torch.scripts import cli as TCLI
from cloudtik_tpu_torch.serve import reqlog, routerlog
from cloudtik_tpu_torch.serve import router as TRT
from cloudtik_tpu_torch.telemetry import core as TC
from cloudtik_tpu_torch.telemetry import events
from cloudtik_tpu_torch.telemetry import http as THTTP
from tests.test_torch_fabric import (make_decode, make_fabric_router,
                                     make_prefill)

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# heavy prompts take the fabric hop, short ones go direct (threshold 16)
PROMPTS = [(list(range(3, 30)), "acme"), ([5, 6, 7, 8, 9], "acme"),
           ([i * 7 % 250 + 1 for i in range(20)], "beta"),
           ([11, 12, 13], "beta")]


def _post(url, payload, trace_id):
    """One request through the router's front door, in the caller's trace
    `trace_id` (which its `x-tik-traceparent` must carry): its answer."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={
                                     "Content-Type": "application/json",
                                     "traceparent": f"00-{trace_id}-"
                                                    f"{'1' * 16}-01"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        answer = json.loads(resp.read())
        assert resp.headers["x-tik-traceparent"].split("-")[1] == trace_id
    answer["trace_id"] = trace_id
    return answer


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Records and live endpoints of one port fabric run: the paths, the
    router's URL, the answers, and a conf dir per trace job."""
    out = tmp_path_factory.mktemp("cli")
    paths = {k: str(out / f"{k}.jsonl") for k in ("reqlog", "router",
                                                  "events")}
    was = TC.STATE.enabled
    TC.enable()
    TC.reset()
    reqlog.install(paths["reqlog"])
    routerlog.install(paths["router"])
    events.install(paths["events"])
    params = TT.init_params(torch.Generator().manual_seed(0),
                            TT.config("tiny", dtype=torch.float32), "cpu")
    prefill, decode = make_prefill(params), make_decode(params)
    router = make_fabric_router([prefill], [decode])
    front = TRT.RouterServer(router, host="127.0.0.1", port=0)
    front.start()
    spans = THTTP.start_server(0, host="127.0.0.1")
    try:
        answers = [_post(f"http://127.0.0.1:{front.port}/v1/generate",
                         {"tokens": p, "max_new_tokens": 4,
                          "request_id": 100 + i, "tenant": t},
                         f"{i + 1:x}" * 32)
                   for i, (p, t) in enumerate(PROMPTS)]
        prefill.stop()
        decode.stop()
        conf = {}
        for job in ("telemetry", "serving-telemetry"):
            conf[job] = out / job
            conf[job].mkdir()
            (conf[job] / "targets.json").write_text(json.dumps([{
                "targets": [f"127.0.0.1:{spans.port}"],
                "labels": {"job": job, "cluster": "c"}}]))
        yield {**paths, "url": f"http://127.0.0.1:{front.port}",
               "answers": answers, "conf": conf}
    finally:
        front.stop()
        spans.stop()
        events.uninstall()
        routerlog.uninstall()
        reqlog.uninstall()
        TC.STATE.enabled = was


def _both(args):
    """(reference result, port result) of one command line."""
    got = []
    for mod in (JCLI, TCLI):
        result = CliRunner().invoke(mod.cli, args)
        got.append((result.exit_code, result.output))
    return got


def _same(args):
    ref, port = _both(args)
    assert port == ref, args
    return port


def _ledger_count(records):
    """The request ledger's records: one a request, and the prefill
    replica's `migrated` milestone of each migrated one."""
    return len(PROMPTS) + sum(a.get("fabric_path") == "migrated"
                              for a in records["answers"])


def test_answers_took_both_fabric_paths(records):
    paths = [a.get("fabric_path", "direct") for a in records["answers"]]
    assert sorted(set(paths)) == ["direct", "migrated"]
    assert all(len(a["tokens"][0]) == 4 for a in records["answers"])


@pytest.mark.parametrize("args", [
    [], ["--stats"], ["--stats", "--json"], ["--json"],
    ["--stats", "--fleet"], ["--stats", "--fleet", "--json"],
    ["--stats", "--by", "path"], ["--stats", "--by", "tenant", "--json"],
    ["--stats", "--by", "replica"], ["--finish", "done"],
    ["--finish", "error"], ["--tail", "2"], ["--since", "3600", "--json"],
    ["--by", "tenant"], ["--finish", "nope"],
], ids=lambda a: " ".join(a) or "list")
def test_serve_requests_is_the_references(records, args):
    code, output = _same(["serve", "requests", "--path", records["reqlog"]]
                         + args)
    if args == ["--stats", "--json"]:
        assert code == 0
        assert json.loads(output)["count"] == _ledger_count(records)
    if args in (["--by", "tenant"], ["--finish", "nope"]):
        assert code == 2


def test_serve_requests_default_ledger_is_the_references(records,
                                                         monkeypatch):
    monkeypatch.setenv("TIK_REQLOG_PATH", records["reqlog"])
    code, output = _same(["serve", "requests", "--stats"])
    assert code == 0 and f"requests: {_ledger_count(records)}" in output


@pytest.mark.parametrize("args", [[], ["--json"]], ids=["text", "json"])
def test_serve_explain_is_the_references(records, args):
    for i, answer in enumerate(records["answers"]):
        code, output = _same(["serve", "explain", str(100 + i), "--path",
                              records["router"], "--reqlog",
                              records["reqlog"]] + args)
        assert code == 0
        if args:
            built = json.loads(output)
            assert built["route"]["client_request_id"] == 100 + i
            assert built["records"]


def test_serve_explain_through_the_ports_router(records):
    code, output = _same(["serve", "explain", "100", "--url",
                          records["url"], "--json"])
    assert code == 0
    assert json.loads(output)["route"]["client_request_id"] == 100
    assert _same(["serve", "explain", "404", "--path", records["router"],
                  "--reqlog", records["reqlog"]])[0] == 0


def test_serve_explain_narrows_a_trace_export(records, tmp_path):
    trace = tmp_path / "trace.json"
    assert _same(["cluster", "trace", "export", "--conf-dir",
                  str(records["conf"]["telemetry"]), "-o",
                  str(trace)])[0] == 0
    rid = "100"
    narrowed = {}
    for mod, name in ((JCLI, "ref"), (TCLI, "port")):
        out = tmp_path / f"{name}.trace.json"
        result = CliRunner().invoke(mod.cli, [
            "serve", "explain", rid, "--path", records["router"],
            "--reqlog", records["reqlog"], "--trace", str(trace),
            "--trace-out", str(out)])
        assert result.exit_code == 0, result.output
        narrowed[name] = json.loads(out.read_text())
    assert narrowed["port"] == narrowed["ref"]
    assert narrowed["port"]["traceEvents"]


@pytest.mark.parametrize("args", [[], ["--json"]], ids=["text", "json"])
def test_serve_replicas_is_the_references(records, args, monkeypatch):
    # the view's beat ages read the router's clock: frozen, so both CLIs
    # read the same view
    import time

    now = time.time()
    monkeypatch.setattr(TRT, "time", types.SimpleNamespace(
        time=lambda: now, monotonic=time.monotonic,
        perf_counter=time.perf_counter, sleep=time.sleep))
    code, output = _same(["serve", "replicas", "--url", records["url"]]
                         + args)
    assert code == 0
    if args:
        roles = sorted(r["role"] for r in json.loads(output)["replicas"])
        assert roles == ["decode", "prefill"]


def test_serve_replicas_needs_a_url():
    assert _same(["serve", "replicas"])[0] == 2


@pytest.mark.parametrize("args", [
    [], ["--json"], ["--trace-id", "TRACE"], ["--json", "--trace-id",
                                               "TRACE"]],
    ids=["text", "json", "trace", "json-trace"])
def test_events_dump_is_the_references(records, args):
    trace_id = _a_trace_id(records)
    args = [trace_id if a == "TRACE" else a for a in args]
    code, output = _same(["events", "dump", "--path", records["events"]]
                         + args)
    assert code == 0
    if args == ["--json", "--trace-id", trace_id]:
        names = [r["name"] for r in json.loads(output)]
        assert names.count("tik_serve_admission") == 1


@pytest.mark.parametrize("lines", ["1", "3", "50"])
def test_events_tail_is_the_references(records, lines):
    code, output = _same(["events", "tail", "--path", records["events"],
                          "-n", lines])
    assert code == 0 and output.count("\n") == min(
        int(lines), len(events.read_events(records["events"])))


def test_events_of_an_empty_journal(tmp_path):
    code, output = _same(["events", "dump", "--path",
                          str(tmp_path / "none.jsonl")])
    assert code == 0 and "No events recorded." in output


def _a_trace_id(records):
    """The trace id of the first request, from its router record, which
    is the one its answer carried."""
    (route,) = [r for r in routerlog.read_routes(records["router"])
                if r["client_request_id"] == 100]
    assert route["traceparent"].split("-")[1] == \
        records["answers"][0]["trace_id"]
    return records["answers"][0]["trace_id"]


@pytest.mark.parametrize("args", [
    ["export"], ["export", "--trace-id", "TRACE"], ["summary"],
    ["summary", "--trace-id", "TRACE"], ["summary", "--trace-id", "0"]],
    ids=["export", "export-trace", "summary", "summary-trace",
         "summary-none"])
def test_cluster_trace_is_the_references(records, args):
    trace_id = _a_trace_id(records)
    args = [trace_id if a == "TRACE" else a for a in args]
    code, output = _same(["cluster", "trace"] + args + [
        "--conf-dir", str(records["conf"]["telemetry"])])
    assert code == 0
    if args[:1] == ["export"] and len(args) > 1:
        spans = [e for e in json.loads(output)["traceEvents"]
                 if e["ph"] == "X"]
        assert {e["args"]["trace_id"] for e in spans} == {trace_id}
        assert {"serve.enqueue", "serve.prefill", "serve.decode"} <= {
            e["name"] for e in spans}


def test_cluster_trace_scrapes_the_serving_process_f3(records):
    """F3: the port's collector reads `serving-telemetry`, which the
    reference's never scrapes (it finds no target and exits 1)."""
    trace_id = _a_trace_id(records)
    args = ["cluster", "trace", "export", "--trace-id", trace_id,
            "--conf-dir", str(records["conf"]["serving-telemetry"])]
    (ref_code, ref_out), (code, output) = _both(args)
    assert ref_code == 1 and "no trace targets discovered" in ref_out
    assert code == 0
    trace = json.loads(output)
    lanes = [e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M"]
    assert lanes and all(n.startswith("serving-telemetry ") for n in lanes)
    assert {"serve.enqueue", "serve.prefill", "serve.decode"} <= {
        e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    code, output = _both(["cluster", "trace", "summary", "--conf-dir",
                          str(records["conf"]["serving-telemetry"])])[1]
    assert code == 0 and trace_id in output


def test_cluster_trace_without_targets(tmp_path):
    code, output = _same(["cluster", "trace", "export", "--conf-dir",
                          str(tmp_path)])
    assert code == 1 and "no trace targets discovered" in output
    code, output = _same(["cluster", "trace", "summary", "--conf-dir",
                          str(tmp_path)])
    assert code == 0


def test_root_group_is_the_references():
    for args in (["--version"], ["--help"], ["serve", "--help"],
                 ["events", "--help"], ["cluster", "trace", "--help"]):
        ref, port = _both(args)
        assert port[0] == ref[0] == 0
        if args == ["--version"]:
            assert port == ref
    ref_help, port_help = (out for _, out in _both(["--help"]))
    assert re.findall(r"^  ([\w-]+) ", port_help, re.M) == \
        re.findall(r"^  ([\w-]+) ", ref_help, re.M)
    assert {"start", "stop", "submit", "status", "cluster-dump", "node",
            "chaos", "cluster", "events", "serve"} <= set(
        re.findall(r"^  ([\w-]+) ", port_help, re.M))


def test_serve_requests_runs_where_jax_cannot_import(records):
    """The card host has no JAX: the port's CLI imports none of it (nor
    the JAX package)."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['cloudtik_tpu'] = None\n"
            "sys.argv = ['tik', 'serve', 'requests', '--stats', '--path', "
            f"{records['reqlog']!r}]\n"
            "runpy.run_module('cloudtik_tpu_torch.scripts.cli', "
            "run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith(f"requests: {_ledger_count(records)}   "
                                 "availability: 100.00%")
