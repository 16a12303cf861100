"""The decode engine times its own steps (serve/engine.py,
telemetry/devtime.py), and the benchmark reads those times.

`tiny` in fp32 on the CPU.  With telemetry on, every `serve.decode_step`
holds three children on the engine thread (`serve.decode.prepare`,
`.launch`, `.wait`) and the device-time attributes (`device_ms`,
`attn_device_ms`; `device_ms` on `serve.prefill`), None on the CPU and
read from a stand-in event class here; with telemetry off neither a span
record nor an event is made.  The spans' `ts` lies on the profiler's
clock.  The four readers of `portbench/metrics/` that take the engine's
spans from the ring read nothing outside a traced serving run and the
right numbers from a planted ring.
"""

import importlib.util
import re
import threading
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cloudtik_tpu_torch import telemetry
from cloudtik_tpu_torch.models import transformer as TT
from cloudtik_tpu_torch.serve import engine as TE
from cloudtik_tpu_torch.telemetry import core, devtime, goodput, names
from cloudtik_tpu_torch.telemetry import instruments as ti
from cloudtik_tpu_torch.telemetry import port_names

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = TT.config("tiny", dtype=torch.float32)
EC = dict(slots=3, max_len=96, prefill_buckets=(8, 16, 32))
# distinct ids (no prefix hit); the 40-token prompt takes two chunks
# (32 + 8)
PROMPTS = [list(range(s, s + n)) for s, n in ((5, 7), (40, 20), (90, 40))]
NEW = 6
CHILDREN = ("serve.decode.prepare", "serve.decode.launch",
            "serve.decode.wait")
SLACK_S = 2e-3      # span `ts` is the wall clock, `dur` perf_counter's


@pytest.fixture(scope="module")
def params():
    return TT.init_params(torch.Generator().manual_seed(0), CFG, "cpu")


@pytest.fixture
def telemetry_on():
    was = core.STATE.enabled
    core.enable()
    core.reset()
    try:
        yield
    finally:
        core.reset()
        core.STATE.enabled = was


def _serve(params):
    """Every request submitted before start, so one pass admits them
    all; returns the outputs, each waited for."""
    eng = TE.DecodeEngine(params, CFG, TE.EngineConfig(**EC), device="cpu")
    reqs = [eng.submit(TE.Request(p, max_new_tokens=NEW)) for p in PROMPTS]
    eng.start()
    try:
        return [r.wait(timeout=60) for r in reqs], eng
    finally:
        eng.stop()


def _named(spans, name):
    return [s for s in spans if s["name"] == name]


class _StubEvent:
    """A CPU stand-in for a CUDA timing event: the host clock at
    `record()`, passed at once."""

    made = 0

    def __init__(self):
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def query(self):
        return self.t is not None

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


# ------------------------------------------------------------- engine --

def test_decode_step_children_nest_on_the_engine_thread(params,
                                                         telemetry_on):
    outs, _ = _serve(params)
    assert [len(o) for o in outs] == [NEW] * len(PROMPTS)
    spans = telemetry.spans()
    steps = _named(spans, "serve.decode_step")
    assert steps
    tids = {s["tid"] for s in steps}
    assert len(tids) == 1 and threading.get_ident() not in tids
    children = {}
    for s in spans:
        if s["name"] in CHILDREN:
            children.setdefault(s["parent"], []).append(s)
    for step in steps:
        kids = {c["name"]: c for c in children.pop(step["id"])}
        assert sorted(kids) == sorted(CHILDREN)
        start, end = step["ts"], step["ts"] + step["dur"]
        for c in kids.values():
            assert c["tid"] == step["tid"] and c["trace"] == step["trace"]
            assert start - SLACK_S <= c["ts"]
            assert c["ts"] + c["dur"] <= end + SLACK_S
        prep, launch, wait = (kids[n] for n in CHILDREN)
        assert prep["ts"] <= launch["ts"] <= wait["ts"]
        assert launch["dur"] + wait["dur"] <= step["dur"]
        assert 1 <= step["attrs"]["active"] <= EC["slots"]
        # the CPU keeps no device times
        assert step["attrs"]["device_ms"] is None
        assert step["attrs"]["attn_device_ms"] is None
    assert not children             # no child outside a decode step
    for chunk in _named(spans, "serve.prefill"):
        assert chunk["attrs"]["device_ms"] is None
    assert sum(c["attrs"]["chunk_len"] for c in _named(
        spans, "serve.prefill")) == sum(len(p) for p in PROMPTS)
    # every span the serve path emits is in one of the two catalogs
    assert {s["name"] for s in spans} <= set(names.SPANS) | set(
        port_names.SPANS)


def test_slot_idle_split_takes_the_decode_spans_duration(params,
                                                         telemetry_on):
    _serve(params)
    ledger = goodput.get_ledger("serve")
    booked = ledger.total(goodput.BUCKET_STEP_COMPUTE) + ledger.total(
        goodput.BUCKET_SLOT_IDLE)
    want = sum(s["dur"] for s in _named(telemetry.spans(),
                                        "serve.decode_step"))
    assert booked == pytest.approx(want, rel=1e-9)


def test_stub_events_put_device_time_on_steps_and_chunks(
        params, telemetry_on, monkeypatch):
    monkeypatch.setattr(devtime, "event_maker",
                        lambda device: _StubEvent)
    _StubEvent.made = 0
    outs, eng = _serve(params)
    assert [len(o) for o in outs] == [NEW] * len(PROMPTS)
    assert eng._timers == []        # every pair read by the stop
    spans = telemetry.spans()
    steps = _named(spans, "serve.decode_step")
    chunks = _named(spans, "serve.prefill")
    launches = {s["parent"]: s
                for s in _named(spans, "serve.decode.launch")}
    assert steps and len(chunks) == 4
    for step in steps:
        device, attn = (step["attrs"][k]
                        for k in ("device_ms", "attn_device_ms"))
        assert isinstance(device, float) and isinstance(attn, float)
        assert 0 < attn <= device
        # the stand-in's pair brackets the launches, inside the span
        assert device <= 1e3 * launches[step["id"]]["dur"]
    for chunk in chunks:
        assert 0 < chunk["attrs"]["device_ms"] <= 1e3 * chunk["dur"]
    # one pair a step, one a layer's attention in it, one a chunk
    assert _StubEvent.made == 2 * (len(steps) * (1 + CFG.n_layers)
                                   + len(chunks))


def test_telemetry_off_makes_no_span_record_and_no_event(params,
                                                         monkeypatch):
    hits = []

    def tripwire(*args, **kwargs):
        hits.append(args)
        raise AssertionError("reached with telemetry off")

    monkeypatch.setattr(core, "_finish_span", tripwire)
    monkeypatch.setattr(devtime, "event_maker", lambda device: tripwire)
    monkeypatch.setattr(devtime, "DeviceTimer", tripwire)
    monkeypatch.setattr(devtime, "settle", tripwire)
    was = core.STATE.enabled
    core.disable()
    try:
        outs, eng = _serve(params)
    finally:
        core.STATE.enabled = was
    assert not hits
    assert [len(o) for o in outs] == [NEW] * len(PROMPTS)
    assert eng._timers == []


def test_span_clock_is_the_profilers(telemetry_on):
    """An event at `time_range.start` us lies at `trace_start_ns() +
    1000 * start` ns on the spans' clock (both CLOCK_REALTIME)."""
    a = torch.randn(96, 96)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        time.sleep(0.02)
        with telemetry.span("test.clock"):
            for _ in range(4):
                a @ a
        time.sleep(0.02)
    span, = _named(telemetry.spans(), "test.clock")
    base = prof.profiler.kineto_results.trace_start_ns()
    mms = [e for e in prof.events() if e.name == "aten::mm"]
    assert len(mms) == 4
    lo_ns = span["ts"] * 1e9 - 0.5e6
    hi_ns = (span["ts"] + span["dur"]) * 1e9 + 0.5e6
    for e in mms:
        assert lo_ns <= base + 1000 * e.time_range.start
        assert base + 1000 * e.time_range.end <= hi_ns


# ------------------------------------------------------------ catalog --

def _port_span_literals():
    pattern = re.compile(r'(?:\bspan|add_span)\(\s*"([^".]+\.[^"]+)"')
    found = set()
    for path in (ROOT / "cloudtik_tpu_torch").rglob("*.py"):
        found.update(pattern.findall(path.read_text()))
    return found


def test_every_port_span_is_catalogued_once():
    assert not set(port_names.SPANS) & set(names.SPANS)
    emitted = _port_span_literals()
    assert emitted <= set(names.SPANS) | set(port_names.SPANS)
    assert set(port_names.SPANS) <= emitted


def test_docs_describe_the_port_spans_and_attributes():
    doc = (ROOT / "docs" / "observability.md").read_text()
    for name in port_names.SPANS:
        assert f"| `{name}` |" in doc, name
    for span, attr in port_names.SPAN_ATTRIBUTES:
        assert f"| `{span}` | `{attr}` |" in doc, (span, attr)
    assert "trace_start_ns()" in doc


# ------------------------------------------------------------ readers --

READERS = {
    "decode_launch_ms.chat": 25.0,
    "decode_device_ms.chat": 110.0,
    "decode_attn_ms.chat": 80.0,
    "prefill_us_per_token.batch": 1e3 * 50.0 / 320,
}
RECORD = {"kind": "serve",
          "spans": [{"name": "serve.decode_step", "dur": 0.1, "active": 3}]}


def _reader(name, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _plant(spans):
    core.reset()
    for i, (name, dur, attrs) in enumerate(spans):
        core.SPAN_RING.append({
            "name": name, "ts": 1000.0 + i, "dur": dur, "id": f"s{i}",
            "parent": None, "trace": "t", "tid": 1, "attrs": attrs})


RING = [
    ("serve.decode_step", 0.15, {"active": 3, "device_ms": 100.0,
                                 "attn_device_ms": 70.0}),
    ("serve.decode.launch", 0.02, {}),
    ("serve.decode_step", 0.16, {"active": 2, "device_ms": 120.0,
                                 "attn_device_ms": 90.0}),
    ("serve.decode.launch", 0.03, {}),
    ("serve.prefill", 0.05, {"chunk_len": 256, "device_ms": 40.0}),
    ("serve.prefill", 0.01, {"chunk_len": 64, "device_ms": 10.0}),
    # read by no reader: its events were never read
    ("serve.prefill", 0.01, {"chunk_len": 32, "device_ms": None}),
]
# a program without the spans and attributes this reads
PARENT_RING = [("serve.decode_step", 0.15, {"active": 3}),
               ("serve.prefill", 0.05, {"chunk_len": 256})]


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_outside_a_traced_serving_run(
        name, monkeypatch, telemetry_on):
    read = _reader(name, monkeypatch)
    _plant(RING)
    assert read({}) is None
    assert read(dict(RECORD, kind="train")) is None
    assert read(dict(RECORD, spans=[])) is None     # an untraced run


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_planted_ring(name, monkeypatch, telemetry_on):
    read = _reader(name, monkeypatch)
    _plant(RING)
    assert read(RECORD) == pytest.approx(READERS[name])
    _plant(PARENT_RING)
    assert read(RECORD) is None
    _plant(RING)
    ti.SPANS_DROPPED._record(1.0, {})       # the ring overwrote a span
    assert read(RECORD) is None
