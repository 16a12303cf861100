#!/usr/bin/env python3
"""The knee of an open-loop serving cell: one sweep of fixed rates.

    python3 portbench/sweep.py --workload <cell> --rates 2,4,6,8 \
        --seconds 40 --seed 1 [--out file.json]

One engine serves the cell's mix at each rate in turn, each for the same
window, after the same warm-up a run makes.  For each rate it prints the
requests due and finished, the tails, the mean queue wait, how many were
still waiting for a slot when the window closed, and how late the
generator ran.  The knee is the highest rate whose backlog does not grow
through the window; the cell's rate is set at about four fifths of it.
Not part of a benchmark run.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=40.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    os.environ.pop("TIK_COMPILE_CACHE_DIR", None)
    os.environ["TIK_TELEMETRY"] = "off"
    sys.path.insert(0, ROOT)
    import torch
    from portbench import harness, weights
    from portbench.traffic import serve as SV
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    ctx = harness.Context(args.workload, args.seed, args.seconds, False,
                          dev, T_START)
    cell = ctx.cell
    t = ctx.transformer(max_seq_len=cell["engine"]["max_len"])
    V = t["vocab_size"]
    params = weights.make_params(t, args.seed, dev,
                                 weights.dtype_of(t["param_dtype"]))
    engine = SV._engine(ctx, t, params)
    SV.warm(engine, cell, args.seed, V)
    ttft = harness.load_module(harness.PB / "metrics" / "ttft_p95_ms.py")
    tpot = harness.load_module(harness.PB / "metrics" / "tpot_p95_ms.py")
    wait = harness.load_module(harness.PB / "metrics"
                               / "queue_wait_ms.chat.py")
    results = []
    for rate in [float(r) for r in args.rates.split(",")]:
        cell["mix"]["rate_per_s"] = rate
        sent, rows, extra = SV.open_window(ctx, engine, V)
        rec = {"kind": "serve", "loop": "open", "requests": rows}
        backlog = sum(1 for r in rows if r["admitted"] is None
                      or r["admitted"] > args.seconds)
        done_in = sum(1 for r in rows if r["done"] is not None
                      and r["done"] <= args.seconds)
        firsts = sorted((r["first"] - r["due"]) * 1e3 for r in rows
                        if r["first"] is not None)
        res = {"rate_per_s": rate, "due": len(rows),
               "finished": sum(r["ok"] for r in rows),
               "finished_in_window": done_in,
               "waiting_at_close": backlog,
               "ttft_p50_ms": firsts[len(firsts) // 2] if firsts else None,
               "ttft_p95_ms": ttft.read(rec), "tpot_p95_ms": tpot.read(rec),
               "queue_wait_ms": wait.read(rec),
               "generator_late_s": extra["generator_late_s"]}
        results.append(res)
        print(json.dumps(res), flush=True)
    engine.stop()
    out = {"workload": args.workload, "seconds": args.seconds,
           "device": torch.cuda.get_device_name(dev),
           "power": harness.power_limit(), "rates": results}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
