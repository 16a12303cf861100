"""Reproduce an intermittent error of torch's CPU float32 `exp`.

In a fresh process, the first multi-threaded `torch.exp` over the score
tiles of an attention forward (einsum, causal mask at -1e30, minus the row
max) can return one worker thread's chunk with a relative error near 1e-4;
the same call again, or the same call on one thread, is exact to 1 ulp.  The
port's CPU parity tests hold its plain versions to 2e-5 of the JAX kernels,
so they run torch on one intra-op thread.

    python tools/repro_torch_cpu_exp.py [--procs 6] [--rounds 5]

Each round starts `--procs` processes at once (the load matters) for each
thread count, and each process compares its first f32 `exp` with the f64
`exp` of the same input.  Prints one JSON line: per thread count, how many
processes saw an error above 1e-6 and the largest error seen.  Uses the CPU
only; imports torch and numpy.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def child(threads: int) -> None:
    import numpy as np
    import torch

    torch.set_num_threads(threads)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 2, 256, 64), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 256, 64), np.float32))
    s = torch.einsum("bhsd,bhtd->bhst", q, k) * 64 ** -0.5
    mask = torch.arange(256)[:, None] >= torch.arange(256)[None, :]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    x = s - s.amax(-1, keepdim=True)
    first = torch.exp(x)
    exact = torch.exp(x.double()).float()
    again = torch.exp(x)
    print(json.dumps({"first": (first - exact).abs().max().item(),
                      "again": (again - exact).abs().max().item()}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        child(args.child)
        return 0
    report = {}
    for threads in (1, 2):
        errors = []
        for _ in range(args.rounds):
            procs = [subprocess.Popen(
                [sys.executable, __file__, "--child", str(threads)],
                stdout=subprocess.PIPE, text=True)
                for _ in range(args.procs)]
            for p in procs:
                out, _ = p.communicate()
                if p.returncode:
                    raise SystemExit(f"child exited {p.returncode}")
                errors.append(json.loads(out))
        report[f"threads_{threads}"] = {
            "processes": len(errors),
            "first_call_bad": sum(e["first"] > 1e-6 for e in errors),
            "first_call_max_err": max(e["first"] for e in errors),
            "second_call_bad": sum(e["again"] > 1e-6 for e in errors),
        }
    import torch

    report["torch"] = torch.__version__
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
