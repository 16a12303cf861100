#!/usr/bin/env python3
"""One run of a serving cell of the benchmark, then the decode engine's
own spans checked and summarised (needs a CUDA card).

    python3 tools/engine_trace_check.py --workload mistral7b-serve-chat \
        --seed <n> --seconds 51 --mode trace|spans|off [--out <file>]
    python3 tools/engine_trace_check.py --mode cost

`--mode trace` is `portbench/run.py --trace 1` (the profiled stretch and
the per-layer metrics); after it, in the same process, the engine's
spans are taken from the ring and checked: for every decode step
`launch + wait <= dur`, `device_ms <= launch + wait + 0.5 ms` and
`attn_device_ms <= device_ms`; every step carries one and the same
nonzero `paged_attn_launches` (the paged-attention kernel's launches,
one or two a layer); with no request preempted, the prefill
chunks' `chunk_len` summed over the window equals `prompt_len -
prefix_tokens` summed over the requests whose first token came.  The
profiled stretch's kernels are laid over the spans through the one
clock (a profiler event at `time_range.start` us lies at
`trace_start_ns() + 1000 * start` ns of `time.time()`): for the decode
steps and prefill chunks inside the stretch, the card's busy time (the
union of its kernels) beside their `device_ms`, the host's time inside
CUDA runtime calls during each step's `serve.decode.launch` (a launch
blocked on a full command buffer shows there), and the kernel time that
falls inside some engine span.  `spans`
is an untraced run with the program's telemetry on (spans and device
events, no profiler); `off` is the untraced run as the benchmark makes
it.  Every mode prints one JSON line last: the run's end-to-end metrics
(read from its record by the benchmark's own readers), its per-layer
metrics where traced, and the checks.  `cost` runs no cell: it times the
host's work for one traced decode step's events (the step's pair and
one a layer for Mistral-7B's 32 layers, recorded on an idle stream, then
read after a sync), in us a step.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLACK_MS = 0.5


def _mean(xs):
    return statistics.fmean(xs) if xs else None


def check_spans(spans, record) -> dict:
    """The decode steps' anatomy and the prefill chunks' token count."""
    by_parent = {}
    for s in spans:
        if s["name"].startswith("serve.decode."):
            by_parent.setdefault(s["parent"], {})[s["name"]] = s
    steps = [s for s in spans if s["name"] == "serve.decode_step"]
    bad = {"launch_wait": 0, "device": 0, "attn": 0, "no_device": 0}
    launches = [st["attrs"].get("paged_attn_launches") for st in steps]
    bad["paged_launches"] = sum(
        1 for n in launches if not n or n != launches[0])
    worst_device_over_ms = None
    rows = {k: [] for k in ("dur", "prepare", "launch", "wait",
                            "device_ms", "attn_device_ms")}
    for st in steps:
        kids = by_parent.get(st["id"], {})
        launch = kids["serve.decode.launch"]["dur"]
        wait = kids["serve.decode.wait"]["dur"]
        rows["dur"].append(1e3 * st["dur"])
        rows["prepare"].append(1e3 * kids["serve.decode.prepare"]["dur"])
        rows["launch"].append(1e3 * launch)
        rows["wait"].append(1e3 * wait)
        if launch + wait > st["dur"]:
            bad["launch_wait"] += 1
        device = st["attrs"].get("device_ms")
        attn = st["attrs"].get("attn_device_ms")
        if device is None or attn is None:
            bad["no_device"] += 1
            continue
        rows["device_ms"].append(device)
        rows["attn_device_ms"].append(attn)
        over = device - 1e3 * (launch + wait)
        worst_device_over_ms = over if worst_device_over_ms is None \
            else max(worst_device_over_ms, over)
        if over > SLACK_MS:
            bad["device"] += 1
        if attn > device:
            bad["attn"] += 1
    chunks = [s for s in spans if s["name"] == "serve.prefill"]
    timed = [c for c in chunks if c["attrs"].get("device_ms") is not None]
    chunk_tokens = sum(c["attrs"]["chunk_len"] for c in chunks)
    want_tokens = sum(r["prompt_len"] - r["prefix_tokens"]
                      for r in record["requests"] if r["first"] is not None)
    return {
        "steps": len(steps), "bad": bad,
        "paged_attn_launches": sorted({n for n in launches
                                       if n is not None}),
        "worst_device_over_launch_wait_ms": worst_device_over_ms,
        "means_ms": {k: _mean(v) for k, v in rows.items()},
        "chunks": len(chunks), "chunks_timed": len(timed),
        "chunk_tokens": chunk_tokens, "first_token_prompt_tokens":
            want_tokens,
        "prefill_device_ms": sum(c["attrs"]["device_ms"] for c in timed),
        "prefill_timed_tokens": sum(c["attrs"]["chunk_len"]
                                    for c in timed),
    }


def _union_ms(intervals, lo, hi) -> float:
    """Length (ms) of the union of (start, end) ns intervals within
    [lo, hi] ns; `intervals` sorted by start."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is not None and s <= cur_e:
            cur_e = max(cur_e, e)
        else:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def overlay(prof, spans, is_annotation) -> dict:
    """The profiled kernels laid over the engine's spans (one clock)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    base = prof.profiler.kineto_results.trace_start_ns()
    events = list(prof.events())
    kernels = sorted(
        (base + 1000 * e.time_range.start, base + 1000 * e.time_range.end)
        for e in events
        if e.device_type == cuda and not is_annotation(e.name)
        and e.time_range.end > e.time_range.start)
    runtime = sorted(
        (base + 1000 * e.time_range.start, base + 1000 * e.time_range.end)
        for e in events
        if e.device_type != cuda and e.name.startswith(("cuda", "cu"))
        and e.time_range.end > e.time_range.start)
    if not kernels:
        return {"kernels": 0}
    lo, hi = kernels[0][0], kernels[-1][1]
    out = {"kernels": len(kernels),
           "kernel_union_ms": _union_ms(kernels, lo, hi)}
    inside = []
    for name, key in (("serve.decode_step", "steps"),
                      ("serve.prefill", "chunks")):
        rows = []
        for s in spans:
            if s["name"] != name:
                continue
            a, b = s["ts"] * 1e9, (s["ts"] + s["dur"]) * 1e9
            inside.append((a, b))
            if a >= lo and b <= hi and s["attrs"].get("device_ms"):
                rows.append((_union_ms(kernels, a, b),
                             s["attrs"]["device_ms"], 1e3 * s["dur"]))
        out[key] = {"n": len(rows),
                    "busy_ms": _mean([r[0] for r in rows]),
                    "device_ms": _mean([r[1] for r in rows]),
                    "dur_ms": _mean([r[2] for r in rows])}
    launches = [s for s in spans if s["name"] == "serve.decode.launch"
                and s["ts"] * 1e9 >= lo
                and (s["ts"] + s["dur"]) * 1e9 <= hi]
    out["launch"] = {
        "n": len(launches),
        "dur_ms": _mean([1e3 * s["dur"] for s in launches]),
        "runtime_ms": _mean([_union_ms(runtime, s["ts"] * 1e9,
                                       (s["ts"] + s["dur"]) * 1e9)
                             for s in launches])}
    # kernel time that falls inside some decode step or prefill chunk
    covered = sum(_union_ms(kernels, max(a, lo), min(b, hi))
                  for a, b in inside if b > lo and a < hi)
    out["kernel_ms_inside_engine_spans"] = covered
    return out


def event_cost(layers: int = 32, steps: int = 500) -> dict:
    """Host us a step spent making, recording and reading the events of
    one traced decode step (the engine's own timer code)."""
    import time
    import torch
    from cloudtik_tpu_torch.telemetry import devtime
    make = devtime.event_maker(torch.device("cuda", 0))
    record_s = read_s = 0.0
    for i in range(steps + 20):
        attrs = {}
        t0 = time.perf_counter()
        step = devtime.DeviceTimer(make, attrs, "device_ms")
        attn = devtime.DeviceTimer(make, attrs, "attn_device_ms")
        step.begin()
        for _ in range(layers):
            attn.begin()
            attn.end()
        step.end()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        devtime.settle([step, attn], True)
        t3 = time.perf_counter()
        if i >= 20:                     # the first rounds warm up
            record_s += t1 - t0
            read_s += t3 - t2
    return {"layers": layers, "steps": steps,
            "record_us": 1e6 * record_s / steps,
            "read_us": 1e6 * read_s / steps}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    p.add_argument("--seconds", type=float, default=51)
    p.add_argument("--mode", choices=("trace", "spans", "off", "cost"),
                   default="trace")
    p.add_argument("--out", default=None,
                   help="also write the spans' summary and the record here")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    if args.mode == "cost":
        print(json.dumps(event_cost()), flush=True)
        return 0
    if args.workload is None or args.seed is None:
        p.error("--workload and --seed are needed to run a cell")
    sys.path.insert(0, os.path.join(ROOT, "portbench"))
    import run as bench_run

    if args.mode == "spans":
        environment = bench_run._environment

        def spans_on(trace):
            environment(trace)
            os.environ["TIK_TELEMETRY"] = "on"
        bench_run._environment = spans_on
    from portbench import harness
    profiles = []
    summarize = harness.summarize_profile

    def keep(prof, window_s, *a, **kw):
        profiles.append(prof)
        return summarize(prof, window_s, *a, **kw)
    harness.summarize_profile = keep
    fd, record_path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    rc = bench_run.main([
        "--workload", args.workload, "--seed", str(args.seed),
        "--seconds", str(args.seconds),
        "--trace", "1" if args.mode == "trace" else "0",
        "--record", record_path])
    if rc != 0:
        return rc
    with open(record_path) as f:
        saved = json.load(f)
    os.unlink(record_path)
    line, record = saved["line"], saved["record"]
    from cloudtik_tpu_torch import telemetry
    bench = harness.benchmark()
    e2e = harness.read_metrics(
        harness.cell_metrics(bench, args.workload, "end_to_end"), record)
    out = {"workload": args.workload, "seed": args.seed,
           "mode": args.mode, "correct": line["correct"],
           "device": line["device"].get("kind"),
           "power": line["device"].get("power"),
           "end_to_end": {k: v["value"] for k, v in e2e.items()},
           "per_layer": {k: v["value"]
                         for k, v in line["metrics"].items()}
           if args.mode == "trace" else {}}
    if args.mode == "trace":
        dropped = telemetry.REGISTRY.get("tik_spans_dropped_total").value()
        preempted = sum(v for _, v in telemetry.REGISTRY.get(
            "tik_serve_preemptions_total").samples())
        spans = telemetry.spans()
        out["spans"] = dict(check_spans(spans, record),
                            dropped=dropped, preemptions=preempted)
        out["breakdown"] = line.get("breakdown")
        out["busy_s"] = line["device"].get("busy_s")
        out["window_s"] = line["device"].get("window_s")
        if profiles:
            out["overlay"] = overlay(profiles[0], spans,
                                     harness._is_annotation)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
