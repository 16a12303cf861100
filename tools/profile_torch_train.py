#!/usr/bin/env python3
"""Where the time goes in one training step of the PyTorch port, on one card.

    python3 tools/profile_torch_train.py [--batch 8] [--seq 2048] [--steps 2]

Runs `Trainer` on tpu_1b at [batch, seq] in bench.py's configuration (bf16
params and Adam moments, save_attn remat), warms up for two steps, then
profiles (torch.profiler, CPU + CUDA activity) `--steps` steps and prints one
JSON line: wall time and device time per step, the device's busy share of
the wall, kernel launches per step, device time per step grouped by kind
(the flash forward, dq and dk/dv kernels, bf16 matmuls, f32 matmuls -- the
logits products --, everything else), the optimizer's span on the device
timeline (the trainer's `train.optimizer` range), launches per step by
kind, and the top kernels by name.  Needs a CUDA card; weights are random
from seed 0.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

_GEMM = re.compile(r"gemm|cutlass|xmma|nvjet|cublas|sm90_", re.I)
# cuBLAS f32 GEMMs (FP32 cores): the logits products of the chunked loss
_F32_GEMM = re.compile(r"f32f32|sgemm|ffma|_sss", re.I)
_FLASH = (("flash_bwd_dkv_kernel", "flash_bwd_dkv"),
          ("flash_bwd_dq_kernel", "flash_bwd_dq"),
          ("flash_fwd_kernel", "flash_fwd"))


def _kind(name: str) -> str:
    for marker, kind in _FLASH:
        if marker in name:
            return kind
    if _GEMM.search(name):
        return "matmul_f32" if _F32_GEMM.search(name) else "matmul_bf16"
    return "other"


def _device_us(evt, total: bool = False) -> float:
    prefix = "" if total else "self_"
    for attr in (f"{prefix}device_time_total", f"{prefix}cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--steps", type=int, default=2)
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA card", file=sys.stderr)
        return 1
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.train.data import synthetic_lm_batches
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import (
        Trainer, TrainerConfig, transformer_spec)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "torch": torch.__version__}),
          flush=True)
    B, S, n = args.batch, args.seq, args.steps
    cfg = T.config("tpu_1b", max_seq_len=S, param_dtype=torch.bfloat16)
    trainer = Trainer(transformer_spec(cfg), TrainerConfig(
        global_batch_size=B, seq_len=S,
        optimizer=OptimizerConfig(moment_dtype="bfloat16"), log_every=n),
        device="cuda")
    trainer.init_state(torch.Generator(device="cuda").manual_seed(0))
    data = synthetic_lm_batches(B, S, cfg.vocab_size)
    trainer.fit(data, 2)                  # warm: allocator, cuBLAS, nvcc
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.fit(data, n)              # ends in float() of the metrics
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind: dict = {}
    counts: dict = {}
    kernels = []
    launches = 0
    optimizer_ms = None
    for evt in prof.key_averages():
        if evt.key.startswith("train."):
            # the trainer's ranges also show on the device timeline as
            # spans: not kernels, kept out of the sums
            if evt.key == "train.optimizer":
                optimizer_ms = _device_us(evt, total=True) / 1e3 / n
            continue
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = _device_us(evt)
        if us <= 0:
            continue
        launches += evt.count
        kind = _kind(evt.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3 / n
        counts[kind] = counts.get(kind, 0) + evt.count / n
        kernels.append((us / 1e3 / n, evt.count / n, evt.key[:90]))
    kernels.sort(reverse=True)
    device_ms = sum(by_kind.values())
    tokens = B * S
    out = {"profile": "train_step", "model": "tpu_1b", "batch": B, "seq": S,
           "steps": n, "wall_ms_per_step": wall_ms / n,
           "device_ms_per_step": device_ms,
           "device_busy_share": device_ms / (wall_ms / n),
           "kernel_launches_per_step": launches / n,
           "device_ms_per_step_by_kind": by_kind,
           "launches_per_step_by_kind": counts,
           "optimizer_device_ms_per_step": optimizer_ms,
           "logits_f32_tflop_per_step":
               4 * 2 * tokens * cfg.d_model * cfg.vocab_size / 1e12,
           "model_tflop_per_step": cfg.flops_per_token() * tokens / 1e12,
           "top_kernels": [{"ms_per_step": ms, "count_per_step": c,
                            "name": name} for ms, c, name in kernels[:12]]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
