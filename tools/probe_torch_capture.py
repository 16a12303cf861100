"""Repeat `chip_smoke.py` observe's profile capture on the card and count
the flash kernel events of each trace.

    python3 tools/probe_torch_capture.py 12

tpu_1b at B=8 x 2048 in bf16; each trial requests a 3-step capture of a
4-step fit and prints one JSON line: the events of each flash kernel
(48 expected), the forward kernels a captured step (16 each), the
trace's kernel events and its first kernels; the last line counts the
trials whose trace lacks an event.  Imports no JAX."""
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402

from cloudtik_tpu_torch.models import transformer as T  # noqa: E402
from cloudtik_tpu_torch.ops import _kernels  # noqa: E402
from cloudtik_tpu_torch.telemetry import stepprof  # noqa: E402
from cloudtik_tpu_torch.train import data as TD  # noqa: E402
from cloudtik_tpu_torch.train.optim import OptimizerConfig  # noqa: E402
from cloudtik_tpu_torch.train.trainer import (  # noqa: E402
    Trainer, TrainerConfig, transformer_spec)

KINDS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
_kernels.build_all()
torch.backends.cuda.matmul.allow_tf32 = False
cfg = T.config("tpu_1b", max_seq_len=2048, param_dtype=torch.bfloat16)
tmp = Path(tempfile.mkdtemp())
trainer = Trainer(transformer_spec(cfg), TrainerConfig(
    global_batch_size=8, seq_len=2048,
    optimizer=OptimizerConfig(moment_dtype="bfloat16"), log_every=1),
    device="cuda")
trainer.init_state(torch.Generator(device="cuda").manual_seed(0))
results = []
for trial in range(int(sys.argv[1])):
    run = tmp / f"run{trial}"
    request = tmp / f"req{trial}.json"
    stepprof.request_capture(3, str(run), path=str(request))
    os.environ[stepprof.REQUEST_ENV] = str(request)
    t0 = time.perf_counter()
    trainer.fit(TD.synthetic_lm_batches(8, 2048, cfg.vocab_size, seed=trial),
                4)
    fit_s = time.perf_counter() - t0
    trace = json.loads((run / "trace.json").read_text())
    events = trace["traceEvents"]
    kernels = sorted((e for e in events if e.get("ph") == "X"
                      and e.get("cat") == "kernel"), key=lambda e: e["ts"])
    seq = []
    for e in kernels:
        for i, k in enumerate(KINDS):
            if k in e.get("name", ""):
                seq.append("fqk"[i])
    counts = {k: seq.count("fqk"[i]) for i, k in enumerate(KINDS)}
    # runs of forward kernels between backward groups: one run a step
    runs, cur = [], 0
    for c in seq:
        if c == "f":
            cur += 1
        elif cur:
            runs.append(cur)
            cur = 0
    cpu = sorted(e["ts"] for e in events if e.get("ph") == "X"
                 and e.get("cat") != "kernel" and "ts" in e)
    first_kernel = kernels[0]["ts"] if kernels else None
    results.append({"trial": trial, "counts": counts, "fwd_runs": runs,
                    "kernels": len(kernels), "fit_s": fit_s,
                    "first_kernel_minus_first_cpu_us":
                    first_kernel - cpu[0] if kernels and cpu else None,
                    "first_kernels": [e["name"][:40] for e in kernels[:3]],
                    "trace_keys": sorted(k for k in trace
                                         if k != "traceEvents")})
    print(json.dumps(results[-1]), flush=True)
bad = [r for r in results if set(r["counts"].values()) != {48}]
print(json.dumps({"trials": len(results), "bad": len(bad)}))
