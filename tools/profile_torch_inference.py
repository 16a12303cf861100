#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's inference path, on one card.

    python3 tools/profile_torch_inference.py [--batch 4] [--seq 2048]
        [--slots 8] [--max-len 1024] [--context 512]

Profiles (torch.profiler, CPU + CUDA activity) one tpu_1b `forward` at
[batch, seq] in bf16, one greedy decode step of `generate` at batch 1 after
a 128-token prompt, and one decode step of the serving engine
(serve/engine.py `decode_step`) with `slots` lanes active over tables of
`max_len` tokens (blocks of 16) at `context` tokens each, with the engine's
own host work around it (table and mask uploads, the one `.tolist()`
sync).  Prints one JSON line for each: wall time, device time summed over
kernels, the device's busy share of the wall, the launch count, and device
time grouped by kind with the top kernels by name.  The engine step's
kinds split the paged attention: `gather` (the table gathers and the K/V
scatter), `copy` (casts to f32 and the einsums' layout copies),
`gemm_f32` (the f32 score and value products and the logits),
`gemm_bf16` (the projections and the MLP), `softmax`, `elementwise`
(RoPE, norms, masks, SwiGLU) and `other`; its host gaps are the wall
less the device time, and it also reports the mean synchronised wall of
20 steps, once with the engine's weights cast to bf16 once and once
reading the f32 weights.  Needs a CUDA card; weights are random from
seed 0.
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


def _kind(name: str) -> str:
    if "flash_fwd_kernel" in name:
        return "flash_attention_fwd"
    if _GEMM.search(name):
        return "matmul"
    return "other"


def _engine_kind(name: str) -> str:
    low = name.lower()
    if _GEMM.search(name) or "gemv" in low:
        # cuBLAS names f32 products by their float template arguments
        if "float" in low or "f32" in low or "sgemm" in low:
            return "gemm_f32"
        return "gemm_bf16"
    if "index" in low or "gather" in low or "scatter" in low:
        return "gather"
    if "copy" in low or "memcpy" in low:
        return "copy"
    if "softmax" in low:
        return "softmax"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile(fn, label: str, kind=_kind, **extra) -> dict:
    """Profile one warm call of fn(); device time grouped by `kind(name)`.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()                                   # warm: allocator, cuBLAS
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind: dict = {}
    kernels = []
    launches = 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = _device_us(evt)
        if us <= 0:
            continue
        launches += evt.count
        k = kind(evt.key)
        by_kind[k] = by_kind.get(k, 0.0) + us / 1e3
        kernels.append((us / 1e3, evt.count, evt.key[:90]))
    kernels.sort(reverse=True)
    device_ms = sum(by_kind.values())
    out = {"profile": label, **extra, "wall_ms": wall_ms,
           "device_ms": device_ms,
           "device_busy_share": device_ms / wall_ms if wall_ms else None,
           "kernel_launches": launches, "device_ms_by_kind": by_kind,
           "top_kernels": [{"ms": ms, "count": n, "name": name}
                           for ms, n, name in kernels[:8]]}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--max-len", type=int, default=1024)
    p.add_argument("--context", type=int, default=512)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_inference: needs a CUDA card", file=sys.stderr)
        return 1
    from cloudtik_tpu_torch.models import generate as G
    from cloudtik_tpu_torch.models import transformer as T

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "torch": torch.__version__}),
          flush=True)
    cfg = T.config("tpu_1b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(gen, cfg, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                           generator=gen, device="cuda")
    with torch.no_grad():
        profile(lambda: T.forward(params, tokens, cfg), "forward",
                batch=args.batch, seq=args.seq)

        prompt = tokens[:1, :128]
        cache = G.init_cache(cfg, 1, 128 + 64, "cuda")
        _, cache = G.forward_step(params, prompt, cache, cfg)
        tok = prompt[:, -1:]

        def step():
            cache["length"] = 128      # rewrite the same position each run
            G.forward_step(params, tok, cache, cfg)

        profile(step, "decode_step", batch=1, context=128)

    engine_step(params, cfg, args.slots, args.max_len, args.context)
    return 0


def engine_step(params, cfg, slots: int, max_len: int, context: int,
                block_size: int = 16) -> dict:
    """The engine's decode step as `DecodeEngine._step` runs it: every
    lane active, each over its own table of max_len // block_size blocks,
    the host uploads and the one sync included."""
    import numpy as np
    import torch

    from cloudtik_tpu_torch.models import generate as G
    from cloudtik_tpu_torch.serve import engine as E

    M = max_len // block_size
    kp, vp = G.init_block_pool(cfg, 1 + slots * M, block_size, "cuda")
    tables_np = np.arange(1, 1 + slots * M, dtype=np.int64).reshape(
        slots, M)
    lengths = torch.full((slots,), context, dtype=torch.long,
                         device="cuda")
    tokens = torch.arange(slots, device="cuda") + 1
    active = [True] * slots

    def step():
        nxt, _, _, _ = E.decode_step(
            params, tokens, kp, vp,
            torch.tensor(tables_np, device="cuda"), lengths,
            torch.tensor(active, device="cuda"), None, None, cfg,
            block_size, 0)
        return nxt.tolist()

    with torch.inference_mode():
        out = profile(step, "engine_decode_step", kind=_engine_kind,
                      slots=slots, max_len=max_len, context=context,
                      block_size=block_size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            step()
        out["wall_ms_mean_20"] = (time.perf_counter() - t0) * 1e3 / 20
    out["host_gap_ms"] = out["wall_ms"] - out["device_ms"]
    print(json.dumps({"profile": "engine_decode_step_summary",
                      "wall_ms_mean_20": out["wall_ms_mean_20"],
                      "host_gap_ms": out["host_gap_ms"]}), flush=True)
    return out


if __name__ == "__main__":
    raise SystemExit(main())
