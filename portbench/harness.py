"""The run: load a cell by name, drive it, check it, print one line.

A cell is `workloads/<name>.json` (its configuration, its kind, its
traffic and engine or trainer settings); its configuration is
`configs/<config>.json`; its kind is the runner `traffic/<kind>.py`,
whose `run(ctx)` builds the program from the seed, warms it, drives the
window, and compares what the window produced with the reference.  Each
metric `BENCHMARK.json` lists for the cell is read from the run's record
by `metrics/<metric>.py`.  Nothing here names a cell.

The last line of standard output is the result:
{"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
 "checks"}, `checks` last: each compared number beside its limit.
"""

from __future__ import annotations

import contextlib
import gc
import heapq
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

PB = Path(__file__).resolve().parent
ROOT = PB.parent
# compared whole, by the part of each module name before the first dot:
# the program's own name begins with the last one
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cloudtik_tpu")


class RunError(RuntimeError):
    """The run cannot produce a result (no card, a missing file)."""


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_cell(name: str) -> Dict:
    cell = load_json(PB / "workloads" / f"{name}.json")
    cell["config_file"] = load_json(PB / "configs" / f"{cell['config']}.json")
    return cell


def forbidden_modules() -> List[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def load_module(path: Path):
    """A file of the benchmark by path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: Dict, cell: str, section: str) -> List[Dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") a cell
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


# ------------------------------------------------------------ profiling --

def _device_time_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _is_annotation(name: str) -> bool:
    # the program's profiler ranges show on the device timeline as spans
    # of their own: not device work
    return name.startswith(("train.", "moe.", "serve.", "ProfilerStep",
                            "portbench."))


def summarize_profile(prof, window_s: float,
                      ranges=("train.optimizer",)) -> Dict:
    """Device work of a profiled stretch: every kernel, copy and set on
    the card (name, start, duration), their union (busy), its gaps named
    by the innermost host operation running at their middle, and the
    device time of kernels launched inside each named program range."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kernels, cpu = [], []
    range_us = {r: 0.0 for r in ranges}
    range_n = {r: 0 for r in ranges}
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if not _is_annotation(e.name) and end > start:
                kernels.append((e.name, start, end))
        else:
            if e.name in range_us:
                range_us[e.name] += _device_time_us(e)
                range_n[e.name] += 1
            cpu.append((e.name, start, end))
    kernels.sort(key=lambda k: k[1])
    merged: List[List[float]] = []
    for _, s, e in kernels:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_us = sum(e - s for s, e in merged)
    by_name: Dict[str, List[float]] = {}
    for name, s, e in kernels:
        slot = by_name.setdefault(name, [0, 0.0])
        slot[0] += 1
        slot[1] += (e - s) / 1e6
    gaps: Dict[str, float] = {}
    edges = sorted((c for c in cpu if c[2] > c[1]), key=lambda c: c[1])
    if merged:
        lo = edges[0][1] if edges else merged[0][0]
        hi = max(c[2] for c in edges) if edges else merged[-1][1]
        bounds = [lo] + [x for s, e in merged for x in (s, e)] + [hi]
        # a sweep over the gaps' middles in order: every host operation
        # that has started waits in a heap by duration; one that ended
        # before the middle leaves it when it reaches the top
        heap: List = []
        i = 0
        for a, b in zip(bounds[0::2], bounds[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            while i < len(edges) and edges[i][1] <= mid:
                name, start, end = edges[i]
                heapq.heappush(heap, (end - start, end, name))
                i += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            name = heap[0][2] if heap else "host: no operation"
            gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    return {
        "window_s": window_s,
        "busy_s": min(busy_us / 1e6, window_s),
        "kernels": {n: {"count": c, "seconds": s}
                    for n, (c, s) in by_name.items()},
        "ranges": {r: {"count": range_n[r], "device_s": range_us[r] / 1e6}
                   for r in ranges},
        "device_ops": sorted(([n, s] for n, (c, s) in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(([n, s] for n, s in gaps.items()),
                            key=lambda x: -x[1])[:10],
    }


# ------------------------------------------------------------------ run --

class Context:
    """What a runner is handed: the cell, the seed, the window's length,
    whether this run traces, the device, and the stamps it sets."""

    def __init__(self, cell_name: str, seed: int, seconds: float,
                 trace: bool, device, t_start: float,
                 cell: Optional[Dict] = None):
        self.cell_name = cell_name
        self.cell = cell if cell is not None else load_cell(cell_name)
        self.config = self.cell["config_file"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t_start = t_start
        self.setup_s: Optional[float] = None
        self.memory_peak_bytes = 0
        self.profile: Optional[Dict] = None
        self._profiled = None

    def transformer(self, **overrides) -> Dict:
        t = dict(self.config["transformer"])
        t.update(overrides)
        return t

    def setup_done(self) -> None:
        """The first timed operation starts now."""
        self.setup_s = time.monotonic() - self.t_start

    def window_closed(self) -> None:
        """Read the peak before anything after the window runs."""
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(self.device))

    def warm_profiler(self) -> None:
        """Pay the profiler's first start (CUPTI's set-up, some seconds)
        in set-up, so that starting it in the window stalls nothing."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        if not self.trace or self.device.type != "cuda":
            return
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device=self.device).add_(1)
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def profiled(self):
        """Profile a short stretch of the window (traced runs only)."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        if not self.trace:
            yield
            return
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        prof = profile(activities=acts)
        prof.start()
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window = time.perf_counter() - t0
        prof.stop()
        # read after the run's traffic has ended (`summarize`): reading
        # the events holds the interpreter for seconds
        self._profiled = (prof, window)

    def summarize(self) -> Optional[Dict]:
        """The profiled stretch's summary (`summarize_profile`), read once
        the window and everything after it is over."""
        if self.profile is None and self._profiled is not None:
            self.profile = summarize_profile(*self._profiled)
            self._profiled = None
        return self.profile

    def free(self) -> None:
        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def check_line(checks: List[Dict]) -> Dict:
    return {c["name"]: {"value": c["value"], "limit": c["limit"]}
            for c in checks}


def passes(c: Dict) -> bool:
    v = c["value"]
    return v is not None and not math.isnan(v) and v <= c["limit"]


def drive(ctx: Context) -> Dict:
    """Run the cell's runner; returns its outcome dict."""
    runner = load_module(PB / "traffic" / f"{ctx.cell['kind']}.py")
    return runner.run(ctx)


def read_metrics(specs: List[Dict], record: Dict) -> Dict:
    out = {}
    for m in specs:
        reader = load_module(PB / "metrics" / f"{m['name']}.py")
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(args) -> int:
    import torch

    t_start = args.t_start
    bench = benchmark()
    names = [w["name"] for w in bench["workloads"]]
    if args.workload not in names:
        raise RunError(f"no workload {args.workload!r} in BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        raise RunError(
            f"needs {entry['chips']} CUDA card(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
            f"device_count() = {torch.cuda.device_count()}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.reset_peak_memory_stats(device)
    ctx = Context(args.workload, args.seed, args.seconds, bool(args.trace),
                  device, t_start)
    outcome = drive(ctx)
    return finish(ctx, outcome, bench, args.record)


def finish(ctx: Context, outcome: Dict, bench: Dict,
           record_path: Optional[str] = None) -> int:
    """After the window: the import check, the metrics, the checks on
    standard error and the result line last on standard output."""
    import torch

    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded modules it must not: {bad}",
              file=sys.stderr)
        return 3
    record = outcome["record"]
    record["setup_s"] = ctx.setup_s
    record["profile"] = ctx.summarize()
    section = "per_layer" if ctx.trace else "end_to_end"
    metrics = read_metrics(cell_metrics(bench, ctx.cell_name, section),
                           record)
    checks = outcome["checks"]
    correct = (outcome["failed"] == 0 and bool(checks)
               and all(passes(c) for c in checks))
    cuda = ctx.device.type == "cuda"
    device_info = {"platform": "gpu" if cuda else ctx.device.type,
                   "kind": torch.cuda.get_device_name(ctx.device)
                   if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": ctx.memory_peak_bytes,
                   "power": power_limit() if cuda else None}
    line = {"correct": correct, "attempted": outcome["attempted"],
            "failed": outcome["failed"], "metrics": metrics,
            "device": device_info}
    if ctx.trace and ctx.profile is not None:
        device_info["busy_s"] = ctx.profile["busy_s"]
        device_info["window_s"] = ctx.profile["window_s"]
        line["breakdown"] = {"device_ops": ctx.profile["device_ops"],
                             "idle_gaps": ctx.profile["idle_gaps"]}
    line["checks"] = check_line(checks)
    if record_path:
        with open(record_path, "w") as f:
            json.dump({"line": line, "record": record}, f, default=str)
    for c in checks:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if passes(c) else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
