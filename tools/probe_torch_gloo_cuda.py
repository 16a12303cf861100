#!/usr/bin/env python3
"""Probe: does the gloo backend take CUDA tensors for every collective the
port's parallel layer issues?

    python3 tools/probe_torch_gloo_cuda.py

For each collective the port issues (all_reduce, all_gather_into_tensor,
reduce_scatter_tensor, batch_isend_irecv: the ring's P2P) it launches two
ranks of its own (parallel/launch.py) that share card 0 over gloo and try
it on CUDA tensors, with a 30 s group timeout: a collective that aborts
its processes takes only its own launch down.  Prints one JSON line:
{"probe": "gloo_cuda", "torch": ..., "results": {collective: "ok" or the
error}}.  NCCL would refuse two ranks on one card, so gloo is the only way
one card could run a multi-rank step.  It exits 0 once every collective
was tried, whatever each gave.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _try(fn) -> str:
    try:
        fn()
        return "ok"
    except Exception as e:  # the probe records the error, it passes nothing
        return f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"


def rank_main() -> int:
    import torch
    import torch.distributed as dist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        "gloo", init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
        f"{os.environ['MASTER_PORT']}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=30))
    dev = torch.device("cuda", 0)
    x = torch.full((4, 8), float(rank + 1), device=dev)

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        assert float(y[0, 0]) == 3.0, y

    def all_gather():
        out = torch.empty((8, 8), device=dev)
        dist.all_gather_into_tensor(out, x)
        assert float(out[4, 0]) == 2.0, out

    def reduce_scatter():
        out = torch.empty((2, 8), device=dev)
        dist.reduce_scatter_tensor(out, x)
        assert float(out[0, 0]) == 3.0, out

    def p2p():
        out = torch.empty_like(x)
        peer = 1 - rank
        ops = [dist.P2POp(dist.isend, x, peer),
               dist.P2POp(dist.irecv, out, peer)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        assert float(out[0, 0]) == float(peer + 1), out

    fns = {"all_reduce": all_reduce, "all_gather_into_tensor": all_gather,
           "reduce_scatter_tensor": reduce_scatter,
           "batch_isend_irecv": p2p}
    result = _try(fns[os.environ["TIK_PROBE_COLLECTIVE"]])
    torch.cuda.synchronize()
    print(json.dumps({"result": result}), flush=True)
    dist.destroy_process_group()
    return 0


COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
               "reduce_scatter_tensor", "batch_isend_irecv")


def main() -> int:
    import torch

    from cloudtik_tpu_torch.parallel.launch import RankFailure, run_ranks

    if not torch.cuda.is_available():
        print("probe_torch_gloo_cuda: CUDA is not available", file=sys.stderr)
        return 1
    results = {}
    for name in COLLECTIVES:
        try:
            outs = run_ranks([str(Path(__file__).resolve())], 2, 120, env={
                **os.environ, "TIK_PROBE_RANK": "1",
                "TIK_PROBE_COLLECTIVE": name})
            line = [ln for ln in outs[0].splitlines() if ln.startswith("{")]
            results[name] = json.loads(line[-1])["result"]
        except RankFailure as e:
            # the ranks aborted: keep the first line that says why
            why = [ln.strip() for ln in str(e).splitlines()
                   if "what()" in ln or "Error" in ln]
            results[name] = "aborted: " + (why[0] if why else
                                           str(e).splitlines()[0])
    print(json.dumps({"probe": "gloo_cuda", "torch": torch.__version__,
                      "cuda": torch.version.cuda, "results": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(rank_main() if os.environ.get("TIK_PROBE_RANK") else main())
