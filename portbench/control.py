#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the chip, in one process.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 20] [--out file.json]

For each seed of `--seeds` the program is driven as a run drives it and
its compared numbers are read (the lower readings).  For each seed of
`--control-seeds` the control is read: the reference put in the
program's place a precision lower (reference/lowp.py).  A training cell
also reads the program with faults planted in its step on those seeds:
half of each batch left out (the mean over the rest), and the labels one
position off (an answer altered where it is produced).  A step that
returns its state unchanged reads 1 on `change` by construction.

Not part of a benchmark run; `tests/test_control.py` runs it at a tiny
size on the CPU.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeds(s):
    return [int(x) for x in s.split(",") if x]


def train_readings(ctx, seeds, control_seeds, faults=True):
    import torch
    from portbench.reference import lowp
    from portbench.traffic import train as TR

    cell = ctx.cell
    B, S = cell["batch"], cell["seq_len"]
    t = ctx.transformer(max_seq_len=S, **cell.get("transformer", {}))
    V, dev, n = t["vocab_size"], ctx.device, cell["check_steps"]
    b1 = cell["optimizer"]["b1"]
    out = {"program": [], "control": [], "half_batch": [],
           "labels_shifted": []}

    def program(seed, feed):
        ctx.seed = seed
        trainer = TR._build(ctx, t)
        prog = {"losses": [], "first_grad": {}, "change": {}}
        for step in range(n):
            m = trainer.train_step(feed(TR.batch(seed, step, B, S, V, dev)))
            prog["losses"].append(float(m["loss"]))
            if step == 0:
                prog["first_grad"] = {
                    k: TR._norm(mu) / (1 - b1) for k, mu in
                    TR._named_leaves(trainer.opt_state[TR.MU_KEY])}
        with torch.no_grad():
            prog["change"] = {k: TR._norm(p - TR.initial(ctx, t, k, p.dtype))
                              for k, p in TR._named_leaves(trainer.params)}
        del trainer
        ctx.free()
        return prog

    def reference(seed, quant=None):
        ctx.seed = seed
        return TR.reference(ctx, t, quant)

    def half(b):
        return {k: v[: max(v.shape[0] // 2, 1)] for k, v in b.items()}

    def shifted(b):
        return {"tokens": b["tokens"],
                "labels": torch.roll(b["labels"], 1, dims=1)}

    def numbers(prog, ref):
        return {c["name"]: c["value"]
                for c in TR.compare(prog, ref, cell["limits"])}

    for seed in sorted(set(seeds) | set(control_seeds)):
        ref = reference(seed)
        if seed in seeds:
            out["program"].append(
                {"seed": seed, **numbers(program(seed, lambda b: b), ref)})
        if seed in control_seeds:
            out["control"].append(
                {"seed": seed, **numbers(reference(seed, lowp.e4m3), ref)})
            if faults:
                out["half_batch"].append(
                    {"seed": seed, **numbers(program(seed, half), ref)})
                out["labels_shifted"].append(
                    {"seed": seed, **numbers(program(seed, shifted), ref)})
        print(json.dumps({"seed": seed, "done": True}), flush=True)
    return out


def serve_readings(ctx, seeds, control_seeds):
    import torch
    from portbench import weights
    from portbench.reference import lowp, serve_check
    from portbench.traffic import serve as SV

    cell = ctx.cell
    t = ctx.transformer(max_seq_len=cell["engine"]["max_len"])
    V = t["vocab_size"]
    out = {"program": [], "control": []}
    for seed in sorted(set(seeds) | set(control_seeds)):
        ctx.seed = seed
        params = weights.make_params(t, seed, ctx.device,
                                     weights.dtype_of(t["param_dtype"]))
        engine = SV._engine(ctx, t, params)
        SV.warm(engine, cell, seed, V)
        if cell["mix"]["loop"] == "open":
            sent, rows, _ = SV.open_window(ctx, engine, V)
        else:
            sent, rows, _ = SV.closed_window(ctx, engine, V)
        engine.stop()
        picked = SV.sample(sent, seed, cell["check"]["sample_tokens"])
        del engine, sent
        ctx.free()
        if seed in seeds:
            g = serve_check.served_gaps(params, t, picked)
            out["program"].append({"seed": seed, **g})
        if seed in control_seeds:
            g = serve_check.served_gaps(params, t, picked, quant=lowp.e4m3)
            out["control"].append({"seed": seed, **g})
        del params
        ctx.free()
        print(json.dumps({"seed": seed, "done": True}), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    os.environ.pop("TIK_COMPILE_CACHE_DIR", None)
    os.environ["TIK_TELEMETRY"] = "off"
    sys.path.insert(0, ROOT)
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    ctx = harness.Context(args.workload, 0, args.seconds, False, dev,
                          T_START)
    kind = ctx.cell["kind"]
    if kind == "train":
        out = train_readings(ctx, args.seeds, args.control_seeds)
    else:
        out = serve_readings(ctx, args.seeds, args.control_seeds)
    out = {"workload": args.workload, "device":
           torch.cuda.get_device_name(dev), "power": harness.power_limit(),
           **out}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
