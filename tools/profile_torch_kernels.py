#!/usr/bin/env python3
"""Kernel time two ways: CUDA events around a run of launches, and the
profiler's kernel durations.

    python3 tools/profile_torch_kernels.py [--iters 20]

At the main shapes of `chip_smoke.py` -- the forward kernel (B1) at
`forward_b4`, the dq (B2) and dk/dv (B3) kernels at `train_b8`, NMS (B4)
at the detect shapes `ssd_b8`, `maskrcnn_b8` and `ssd1200_b8` and at
`all_zero_ssd1200`, ROIAlign (B5) at Mask R-CNN's 7x7 and 14x14 poolings
(`maskrcnn_7`, `maskrcnn_14`) -- times
`iters` back-to-back launches of each wrapper with CUDA events, as
`chip_smoke.time_ms` does (event to event, so host gaps between launches
count), and again under torch.profiler, whose kernel durations are the
device's alone.  Prints one JSON line per kernel: both means, their ratio,
and the host's time to enqueue one launch (wrapper, checks, allocation,
ctypes call).  Needs a CUDA card; inputs random from seed 0 (NMS: each case's own seed).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profiled_ms(fn, marker: str, iters: int):
    """Mean device duration of the kernels whose name holds `marker`, over
    `iters` calls of fn under the profiler, and how many it saw."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if marker in e.key]
    count = sum(e.count for e in hits)
    total_us = sum(_device_us(e) for e in hits)
    return (total_us / count / 1e3 if count else None), count


def enqueue_ms(fn, iters: int) -> float:
    """Host time per call to queue fn (the device runs behind)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return host


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from cloudtik_tpu_torch.ops import detection as D
    from cloudtik_tpu_torch.ops import flash_attention as FA

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = []
    c = cs.ATTN_CASES[0]
    q, k, v = cs.make_qkv(c, gen)
    scale = c.D ** -0.5
    runs.append(("flash_fwd", "flash_fwd_kernel", c, lambda: (
        FA.flash_attention_fwd(q, k, v, causal=c.causal, sm_scale=scale))))
    cb = cs.BWD_CASES[0]
    qb, kb, vb = cs.make_qkv(cb, gen)
    do = cs._rand_heads(cb, gen, cb.H, cb.S)
    sb = cb.D ** -0.5
    ob, lse = FA.flash_attention_fwd(qb, kb, vb, causal=cb.causal,
                                     sm_scale=sb)
    delta = FA._bwd_delta(ob, do)
    runs.append(("flash_bwd_dq", "flash_bwd_dq_kernel", cb, lambda: (
        FA._launch_dq(qb, kb, vb, do, lse, delta, cb.causal, sb))))
    runs.append(("flash_bwd_dkv", "flash_bwd_dkv_kernel", cb, lambda: (
        FA._launch_dkv(qb, kb, vb, do, lse, delta, cb.causal, sb))))
    nms_cases = {c.name: c for c in cs.NMS_CASES}
    for name in cs.NMS_DETECT_SHAPES + ("all_zero_ssd1200",):
        nc = nms_cases[name]
        boxes, scores = cs.make_nms_inputs(nc, "cuda")
        kw = {"iou_threshold": nc.iou_threshold, "max_output": nc.K}
        runs.append(("nms", "nms_kernel", nc,
                     lambda b=boxes, s=scores, kw=kw: D.nms_batched(
                         b, s, **kw)))
    for rc in cs.ROI_CASES[:2]:
        feats, rois = cs.make_roi_inputs(rc, gen, "cuda")
        kw = {"pooled_size": rc.P, "sampling_ratio": rc.sampling,
              "spatial_scale": rc.scale}
        runs.append((f"roi_align_{rc.P}x{rc.P}", "roi_align_", rc,
                     lambda f=feats, r=rois, kw=kw: D.roi_align_batched(
                         f, r, **kw)))
    for name, marker, case, fn in runs:
        event_ms = cs.time_ms(fn, iters=args.iters)
        prof_ms, seen = profiled_ms(fn, marker, args.iters)
        print(json.dumps({
            "kernel": name, "case": case.name, "iters": args.iters,
            "event_ms": event_ms, "profiler_kernel_ms": prof_ms,
            "profiler_launches": seen,
            "event_over_profiler": (event_ms / prof_ms if prof_ms
                                    else None),
            "host_enqueue_ms": enqueue_ms(fn, args.iters),
            "roi_route": (D.LAST_ROI_ROUTE if name.startswith("roi_align")
                          else None),
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
