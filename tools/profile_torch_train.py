#!/usr/bin/env python3
"""Where the time goes in one training step of the PyTorch port, on one card.

    python3 tools/profile_torch_train.py [--model tpu_1b|bert_large|
        tpu_moe_8x1b|resnet50|ssd_resnet34|maskrcnn_resnet50|sdxl_mini|
        criteo_terabyte|rnnt|graphsage] [--batch 8] [--seq 2048]
        [--steps 2] [--layers 8]

Runs `Trainer` on tpu_1b at [batch, seq] in bench.py's configuration (bf16
params and Adam moments, save_attn remat), on bert_large (default B=32,
S=512) as `recipes/bert_large_pretrain.py` builds it (f32 params, bf16
compute, the MLM objective on `synthetic_mlm_batches`), on tpu_moe_8x1b
at full width cut to `--layers` (default 8, as chip_smoke's moe_train:
f32 params and moments, bf16 compute, AdamW without warmup, one
repeated batch), or
on a vision
model or a model-zoo family as its recipe builds it (`resnet50_imagenet`,
`ssd_coco`, `maskrcnn_coco`, `sdxl_fsdp`, `dlrm_criteo`, `rnnt_speech`,
`graphsage_nodes`; default B = 128, 32, 4, the per-card batches of the JAX
recipes' launch lines, 8 for the UNet, 8,192 for DLRM, 8 utterances of 256
frames for RNN-T and 4,096 nodes for GraphSAGE; AdamW without warmup, one
repeated batch), warms up
for two steps, then profiles (torch.profiler, CPU + CUDA activity)
`--steps` steps and prints one JSON line: wall time and device time per
step, the device's busy share of the wall, kernel launches per step,
device time per step grouped by kind (the flash forward, dq and dk/dv
kernels, ROIAlign, convolutions, bf16 matmuls, f32 matmuls -- the logits
products, BERT's MLM head, ROIAlign's backward --, reductions -- batch
norm's and group norm's statistics --, gathers and scatters -- DLRM's
embedding rows and their gradient --, everything else),
the optimizer's span on the device timeline (the trainer's
`train.optimizer` range), for MoE the device time of the forward's
ranges (ops/moe.py: moe.route, moe.dispatch, moe.experts, moe.combine;
the forward and its remat recompute, not the backward), launches per step
by kind, and the top kernels by name.  Needs a CUDA card; weights are random from seed 0.
"""

from __future__ import annotations

import argparse
import importlib
import itertools
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
          ("flash_fwd_kernel", "flash_fwd"),
          ("roi_align_", "roi_align"))
# cuDNN's convolution kernels (forward, data and weight gradients)
_CONV = re.compile(r"fprop|dgrad|wgrad|conv|implicit", re.I)
_REDUCE = re.compile(r"reduce_kernel|welford", re.I)
_INDEX = re.compile(r"index|scatter|gather", re.I)
# models trained through a recipe: recipe module, default batch and the
# recipe's flag that sets it
RECIPES = {"resnet50": ("resnet50_imagenet", 128, "--batch"),
           "ssd_resnet34": ("ssd_coco", 32, "--batch"),
           "maskrcnn_resnet50": ("maskrcnn_coco", 4, "--batch"),
           "sdxl_mini": ("sdxl_fsdp", 8, "--batch"),
           "criteo_terabyte": ("dlrm_criteo", 8192, "--batch"),
           "rnnt": ("rnnt_speech", 8, "--batch"),
           "graphsage": ("graphsage_nodes", 4096, "--nodes")}


def _kind(name: str) -> str:
    for marker, kind in _FLASH:
        if marker in name:
            return kind
    if _CONV.search(name):
        return "conv"
    if _REDUCE.search(name):
        return "reduce"
    if _INDEX.search(name):
        return "index"
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
    p.add_argument("--model", default="tpu_1b",
                   choices=("tpu_1b", "bert_large", "tpu_moe_8x1b",
                            *RECIPES))
    p.add_argument("--batch", type=int, default=None,
                   help="8 for tpu_1b, 32 for bert_large, the recipe "
                        "models' as RECIPES says")
    p.add_argument("--seq", type=int, default=None,
                   help="2048 for tpu_1b, 512 for bert_large")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--layers", type=int, default=8,
                   help="tpu_moe_8x1b's depth (its width is kept)")
    args = p.parse_args(argv)
    bert = args.model == "bert_large"
    recipe_of = RECIPES.get(args.model)
    B = args.batch or (recipe_of[1] if recipe_of else 32 if bert else 8)
    S = args.seq or (512 if bert else 2048)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA card", file=sys.stderr)
        return 1
    from cloudtik_tpu_torch.models import bert as BE
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.train.data import (synthetic_lm_batches,
                                               synthetic_mlm_batches)
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import (
        Trainer, TrainerConfig, bert_spec, transformer_spec)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "torch": torch.__version__}),
          flush=True)
    n = args.steps
    if recipe_of:
        recipe = importlib.import_module(
            f"cloudtik_tpu_torch.recipes.{recipe_of[0]}")
        rargs = recipe.parser().parse_args([recipe_of[2], str(B)])
        rtrainer, rdata, cfg = recipe.build(rargs)
        spec, opt = rtrainer.spec, OptimizerConfig(warmup_steps=0)
        # a "token" is an image, an example, a node or (RNN-T) a frame
        S = rtrainer.config.seq_len
        data = itertools.repeat(next(rdata))
        head_tflop = None
        del rtrainer
    elif bert:
        cfg = BE.config("bert_large", max_seq_len=S)
        spec, opt = bert_spec(cfg), OptimizerConfig()
        data = synthetic_mlm_batches(B, S, cfg.vocab_size)
        P = next(synthetic_mlm_batches(1, S, cfg.vocab_size))[
            "mlm_positions"].shape[1]
        # the head's f32 products over the B*P gathered rows: forward,
        # and the input and weight gradients
        head_tflop = 3 * 2 * B * P * cfg.d_model * (
            cfg.d_model + cfg.vocab_size) / 1e12
    elif args.model == "tpu_moe_8x1b":
        cfg = T.config("tpu_moe_8x1b", n_layers=args.layers, max_seq_len=S)
        spec = transformer_spec(cfg)
        opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                              schedule="constant")
        data = itertools.repeat(next(synthetic_lm_batches(
            B, S, cfg.vocab_size, seed=1)))
        head_tflop = 4 * 2 * B * S * cfg.d_model * cfg.vocab_size / 1e12
    else:
        cfg = T.config("tpu_1b", max_seq_len=S, param_dtype=torch.bfloat16)
        spec = transformer_spec(cfg)
        opt = OptimizerConfig(moment_dtype="bfloat16")
        data = synthetic_lm_batches(B, S, cfg.vocab_size)
        head_tflop = 4 * 2 * B * S * cfg.d_model * cfg.vocab_size / 1e12
    trainer = Trainer(spec, TrainerConfig(
        global_batch_size=B, seq_len=S, optimizer=opt, log_every=n),
        device="cuda")
    trainer.init_state(torch.Generator(device="cuda").manual_seed(0))
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
    moe_ms: dict = {}
    for evt in prof.key_averages():
        if evt.key.startswith("moe."):
            moe_ms[evt.key] = _device_us(evt, total=True) / 1e3 / n
            continue
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
    out = {"profile": "train_step", "model": args.model, "batch": B,
           "seq": S, "steps": n, "wall_ms_per_step": wall_ms / n,
           "device_ms_per_step": device_ms,
           "device_busy_share": device_ms / (wall_ms / n),
           "kernel_launches_per_step": launches / n,
           "device_ms_per_step_by_kind": by_kind,
           "launches_per_step_by_kind": counts,
           "optimizer_device_ms_per_step": optimizer_ms,
           "moe_forward_device_ms_per_step": moe_ms or None,
           "logits_f32_tflop_per_step": head_tflop,
           "model_tflop_per_step": (spec.flops_per_token or 0.0)
           * tokens / 1e12,
           "top_kernels": [{"ms_per_step": ms, "count_per_step": c,
                            "name": name} for ms, c, name in kernels[:12]]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
