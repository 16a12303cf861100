#!/usr/bin/env python3
"""The benchmark of the port: one cell, one seed, one window.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds `cloudtik_tpu_torch/`, on a
machine with a CUDA card.  With `--trace 0` the result line carries the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics, read
from a profiled stretch of the window and the program's spans.  A run
that finds no card fails (exit 2); it never falls back to the CPU.

The first run in a checkout builds the port's kernels into its fixed
cache inside the checkout (`build/torch_kernels/`); later runs load them.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _environment(trace: bool) -> None:
    """Caches at fixed paths inside the checkout; the program's own
    kernel cache in its in-tree default; its spans on only when traced."""
    build = os.path.join(ROOT, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ.pop("TIK_COMPILE_CACHE_DIR", None)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    os.environ["TIK_TELEMETRY"] = "on" if trace else "off"
    os.environ["TIK_TELEMETRY_RING"] = "65536"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--record", default=None,
                   help="also write the run's record (JSON) to this file")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    args.t_start = T_START
    _environment(bool(args.trace))
    sys.path.insert(0, ROOT)
    from portbench import harness
    try:
        return harness.main(args)
    except harness.RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
