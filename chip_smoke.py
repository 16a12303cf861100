#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (cloudtik_tpu_torch).

    python3 chip_smoke.py

Runs on one CUDA card and drives the port only (no JAX, nothing of
cloudtik_tpu).  Phases, each printed as one JSON line; any failure ends the
run with a non-zero exit:

  device   card name, count, `nvidia-smi` name and power limit
  build    builds every kernel from csrc/ (one nvcc per source, in parallel);
           registers and spills of each kernel from ptxas, and no spill
           in the main paths' bf16 D=128 flash kernels
  kernel   the forward kernel against its plain PyTorch version on the
           card, at the main path's shape and a few others, with the
           tolerance; kernel, plain and library (yardstick) times beside the
           bound
  kernel_bwd  the dq and dk/dv kernels against the plain backward, at the
           training path's shape and the same others, likewise; the
           forward's o and lse they read are held first
  serve    the inference path, part 2: `tik-serve`'s backend at tpu_1b
           width answering /v1/generate; greedy answers equal a direct
           `generate`
  engine   `tik-serve --engine`: the continuous-batching paged decode
           engine at tpu_1b width (8 slots, 1,024 tokens a request, blocks
           of 16, bf16) behind ServeServer, 16 concurrent HTTP clients
           (prompts of 32-700 tokens, half behind one shared 256-token
           prefix, one stopping at an EOS), every answer held by the
           tie-aware greedy check and every decode step's logits against
           a teacher-forced `forward_step`; prefix hits, prefill chunks,
           413, cancel, a free pool after; then an oversubscribed engine
           that must preempt, and two engines with a planted fault (block
           tables or lengths rolled one lane on) that the logits check
           must catch in every lane.  Tokens/s,
           TTFT/TPOT p50/p95 from the request ledger, mean decode-step ms
           with 8 lanes, peak memory; no B1-B5 launch on this path
  spec     `tik-serve --engine --spec-model`: `engine_backend(spec_model=,
           spec_k=4)` at tpu_1b behind ServeServer, 8 concurrent clients
           (prompts of 32-384 tokens, 32 new tokens; one sampled, which
           must not speculate; one stopping at an EOS its first round
           accepts), with a tpu_120m draft (random weights: rejection)
           and a tpu_1b self-draft (acceptance >= 0.8), beside a plain
           `--engine` run of the same requests; every greedy answer held
           by the tie-aware check and every verify row at an accepted or
           emitted position (and every plain decode step's row) by the
           logits check; a free pool after; a self-draft engine whose
           verify runs one position on must be flagged in every request.
           Tokens/s, TTFT/TPOT, ms per round and its split, acceptance,
           tokens per verify; no B1-B5 launch on this path
  lora     multi-tenant LoRA: `DecodeEngine(adapters=AdapterPool(...,
           capacity=3))` at tpu_1b, 4 rank-16 adapters on wq and wv:
           12 concurrent requests over the base model and the 4 adapters
           (gathered steps, an eviction, a wait on a pinned slot), a
           homogeneous run (merged steps), prefix isolation between
           adapters, an unknown adapter failing alone, a spec engine with
           one per-adapter tpu_120m draft; every answer and decode step
           against a teacher-forced forward over `merge_lora`, whose
           logits the adapters must move by >= 0.6; adapter indices
           rolled one lane on must be flagged in every changed lane; no
           B1-B5 launch on this path
  disagg   `tik-serve --engine --disagg`: `engine_backend(disagg=True,
           prefill_slots=2)` at the engine phase's configuration and
           traffic behind ServeServer: a prefill-role engine exports each
           finished prompt's KV blocks (gathered on the card, one copy to
           the host) over the in-process migration wire to the decode-role
           engine, which copies them back and scatters them into its pool.
           Every answer tie-aware and every decode-role step against the
           teacher; every record one migration of its whole prompt; prefix
           hits on both roles; one migrated request's blocks equal bit for
           bit in both pools; both pools free after stop; two requests
           torn by a planted `serve.kvcache.migrate` fault answer right
           through the fallback; a pair whose import lands its planes one
           block on must be flagged in every lane.  Tokens/s, TTFT/TPOT,
           and per migration the gather + d2h, pack + send and import ms,
           MB and GB/s, beside a monolithic `--engine` run of the same
           requests; no B1-B5 launch on this path
  fabric   the serving fabric: a PrefillReplica and two DecodeReplicas
           (tpu_1b engines over one set of weights) behind the copied
           prefix-affinity Router and a ReplicaRegistry, KV blocks over
           SocketKVTransport on 127.0.0.1: prompt-heavy requests migrate,
           short ones go direct, a torn migration falls back on the decode
           replica the router chose, and a prefill replica killed
           mid-traffic leaves every request answered (tie-aware, outcomes
           only).  The socket wire's GB/s and ms per handoff; no B1-B5
           launch on this path
  forward  the inference path, part 1: tpu_1b `forward` at B=4, S=2048 in
           bf16, held against the same forward on the reference attention
  train    the training path: `Trainer.fit` on tpu_1b at full width and
           depth, B=8, S=2048, bf16 params and moments, save_attn remat: 2
           warm-up steps, then 5 measured steps with 16 launches of each
           kernel per step; ms/step, tokens/s, MFU, peak memory
  checkpoint  the train path's configuration with checkpoints: 2 steps run
           twice from one state (with prefetch depth 0 and 2: whether the
           losses are bitwise equal, and data_wait per step), then 4 steps
           saving every 2 off the step loop into a temporary directory (it
           must have room for max_to_keep + 1 steps), step 4 torn by a
           planted `checkpoint.save` fault; a fresh Trainer resumes at
           step 2 past it, every leaf equal to the state saved, and runs
           steps 3-4 to the uninterrupted losses (bitwise when the probe
           was, else within twice its gap) with 16 launches of each flash
           kernel a step; `restore_latest_good` past the torn step
           removes it; `tik-serve`'s plain backend and engine serve the
           restored weights (tokens equal a direct `generate`; the engine
           by the tie-aware check).  Save stall, d2h and write seconds
           and GB/s, restore seconds, bytes per step, memory before and
           after a snapshot and peaks
  kernel_det  the NMS and ROIAlign kernels against their plain versions:
           NMS keep lists equal to the plain version's and to the JAX
           `nms_reference`'s (tests/torch_golden/, inputs rebuilt from
           each case's numpy seed) at the detect paths' shapes (SSD at 300
           and at 1200: 45,384 boxes an image), all-zero scores, fewer boxes
           than outputs, degenerate boxes, NaN scores and coordinates,
           signed zeros, +-inf and absent scores; ROIAlign
           within 1e-5 at Mask R-CNN's shapes, sampling 2 at scale 0.25,
           ROIs partly outside the map and under a pixel, 100 and 72
           channels, each on the route it must take (vector or strided); kernel and
           plain times beside the bound (no single PyTorch call computes
           either)
  train_grads  tpu_1b width with 2 layers: the flash path's gradients
           against the reference attention path's, and the loss falling
           over 10 steps on one repeated batch
  lora_train  LoRA fine-tuning through `recipes.llama_lora_finetune.build`
           at its defaults (tpu_1b, f32 base, rank 16 on wq and
           wv, B=8, S=2048, AdamW): 2 warm-up and 6 measured steps on one
           repeated batch with 16 launches of each flash kernel a step,
           every base leaf unchanged, every adapter leaf moved, the loss
           falling; ms/step, tokens/s, MFU at 4/6 of the full flops, peak
           memory.  The adapter is saved by the port's Checkpointer and
           served by `engine_backend(adapters_dir=...)` beside the base:
           it must move the teacher's logits by >= 0.3, and every answer
           passes the tie-aware and logits checks against a teacher over
           `merge_lora`'d weights (the base's for base requests)
  bert     BERT-Large MLM pretraining through
           `recipes.bert_large_pretrain.build` (24 layers, d=1024,
           16 heads of 64, S=512, f32 params, bf16 compute) at B=32:
           2 warm-up and 5 measured steps on one repeated batch with 24
           launches of each flash kernel a step (non-causal, D=64) and the
           loss falling; ms/step, tokens/s, MFU, peak memory
  bert_grads  bert_large width with 2 layers: the flash path's gradients
           against the reference attention path's, as train_grads
  optim    sgd, adafactor, lion and adamw (bf16 moments), 5 updates each
           over a 2-layer tpu_1b layer stack on the card, held to the same
           optimizer on the CPU in f32
  detect   the detection path: `detect` of maskrcnn_resnet50 at B=8 x 512
           (2 ROIAlign launches and 1 NMS launch per call) and of
           ssd_resnet34 at B=8 x 300 and at B=8 x 1200 (1 NMS launch over
           3,000 or 45,384 anchors per call), bf16: ms per call, images/s,
           peak memory; outputs checked,
           each call's NMS and pooling held against the plain versions, and
           Mask R-CNN's map pooled on ROIAlign's vector route

Launch counts are zeroed just before each path (forward then serve; the
engine; spec; lora; disagg; fabric; the measured train steps; the resumed
steps of the checkpoint phase; the measured steps of lora_train and of
bert; the measured detect calls of each model) and read just after it.
The `total` line gives the script's seconds; the last lines are the
`nvidia-smi` name/power line, a `{"kernels": [...]}` summary and
`{"ok": true, "device": ...}`.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

# Published dense peaks of one H100 SXM (NVIDIA data sheet) for the bound.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------- build --

def ptxas_report(logs: dict) -> list:
    """Registers and spills of every kernel in nvcc's `-Xptxas -v` logs
    ({source: log}): one row per kernel, named `name<type, D>` where the
    mangled name allows."""
    rows = []
    for source, log in sorted(logs.items()):
        kernel = None
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                kernel = {"source": source,
                          "kernel": _kernel_name(m.group(1))}
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and kernel is not None:
                kernel["spill_stores"] = int(m.group(1))
                kernel["spill_loads"] = int(m.group(2))
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel is not None:
                kernel["registers"] = int(m.group(1))
                rows.append(kernel)
                kernel = None
    return rows


def _kernel_name(mangled: str) -> str:
    """`flash_fwd_kernel<__nv_bfloat16, 128>` from its mangled name, whose
    identifiers are length-prefixed (`20flash_bwd_dkv_kernel`)."""
    for m in re.finditer(r"(?=(\d{1,3})([A-Za-z_]\w*?_kernel))", mangled):
        if int(m.group(1)) != len(m.group(2)):
            continue
        rest = mangled[m.start() + len(m.group(1)) + len(m.group(2)):]
        t = re.match(r"I\d+(__nv_bfloat16|__half)Li(\d+)E", rest)
        return f"{m.group(2)}<{t.group(1)}, {t.group(2)}>" if t \
            else m.group(2)
    return mangled


# The main paths' flash kernels must not spill (bf16, D = 128).
NO_SPILL = tuple(f"{k}<__nv_bfloat16, 128>" for k in (
    "flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"))


# ------------------------------------------------------------------ kernel --

@dataclasses.dataclass(frozen=True)
class AttnCase:
    name: str
    B: int
    H: int
    Hkv: int
    S: int
    D: int
    causal: bool
    dtype: str = "bfloat16"
    # "bshd": [B,S,H,D] tensors transposed to BHSD, as the model hands them
    layout: str = "bhsd"
    # kv length, S when 0.  Causal with S != Skv is the kernels' absolute
    # mask (q_pos >= kv_pos), which the model reaches only through an
    # explicit implementation="flash"
    Skv: int = 0

    def __post_init__(self):
        if not self.Skv:
            object.__setattr__(self, "Skv", self.S)


# The first case is the shape and layout `forward` gives the kernel.  The
# others cover what the kernels tile: 128-row q tiles and 64-row kv tiles
# (forward, dq), 128-row kv tiles and 64-row q tiles (dk/dv), ragged ends, GQA,
# D = 64 and fp16.
ATTN_CASES = (
    AttnCase("forward_b4", 4, 16, 16, 2048, 128, True, layout="bshd"),
    AttnCase("tpu_1b_b1", 1, 16, 16, 2048, 128, True),
    AttnCase("gqa_noncausal", 2, 16, 4, 1024, 64, False),
    AttnCase("ragged_causal", 1, 16, 16, 1000, 128, True),
    AttnCase("fp16_causal", 1, 8, 8, 512, 128, True, dtype="float16"),
    AttnCase("cross_causal", 2, 16, 16, 384, 128, True, Skv=1024),
    AttnCase("d64_causal", 2, 16, 16, 2048, 64, True),
    AttnCase("gqa_causal", 2, 16, 4, 1024, 128, True, layout="bshd"),
    AttnCase("s1088_causal", 2, 16, 16, 1088, 128, True),
    # BERT-Large's attention as the bert phase hands it over: non-causal,
    # head_dim 64, S=512, q/k/v transposed views of [B, S, H, D]
    AttnCase("bert_large_b32", 32, 16, 16, 512, 64, False, layout="bshd"),
)
# bf16/fp16 output: p and o are rounded to 8/11 mantissa bits at different
# points in the kernel (per 64-column tile) and the plain version (per row)
O_ATOL, O_RTOL = 1e-2, 1e-2
# lse stays in f32; only the summation order differs
LSE_ATOL = 1e-3


def live_pairs(c: AttnCase) -> int:
    """Unmasked (q, kv) pairs of one head: causal under absolute positions,
    row q sees min(q + 1, Skv) keys."""
    if not c.causal:
        return c.S * c.Skv
    n = min(c.S, c.Skv)
    return n * (n + 1) // 2 + max(c.S - c.Skv, 0) * c.Skv


def attention_bound(c: AttnCase, elem_bytes: int = 2):
    """Least time for the work the inputs need: unmasked (q, kv) pairs
    only, each input read once, each output written once."""
    flops = 4 * c.B * c.H * live_pairs(c) * c.D
    nbytes = (elem_bytes * (2 * c.B * c.H * c.S * c.D
                            + 2 * c.B * c.Hkv * c.Skv * c.D)
              + 4 * c.B * c.H * c.S)
    t_ops = flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, bound_by, flops, nbytes


def _rand_heads(c: AttnCase, gen, heads: int, seq: int):
    import torch

    shape = (c.B, seq, heads, c.D) if c.layout == "bshd" \
        else (c.B, heads, seq, c.D)
    t = torch.randn(shape, generator=gen, device="cuda").to(
        getattr(torch, c.dtype))
    return t.transpose(1, 2) if c.layout == "bshd" else t


def make_qkv(c: AttnCase, gen):
    return (_rand_heads(c, gen, c.H, c.S),
            _rand_heads(c, gen, c.Hkv, c.Skv),
            _rand_heads(c, gen, c.Hkv, c.Skv))


def check_fwd(c: AttnCase, q, k, v, o, lse, scale: float) -> dict:
    """Hold the forward kernel's (o, lse) against the plain version on the
    same inputs; returns the largest errors."""
    import torch

    from cloudtik_tpu_torch.ops import flash_attention as FA

    if q.is_cuda:
        torch.cuda.synchronize()
    o_ref, lse_ref = FA.flash_attention_reference(
        q, k, v, causal=c.causal, sm_scale=scale)
    o_err = (o.float() - o_ref.float()).abs()
    o_ok = bool((o_err <= O_ATOL + O_RTOL * o_ref.float().abs()).all())
    lse_err = (lse - lse_ref).abs().max().item()
    require(o.shape == q.shape and lse.shape == (c.B, c.H, c.S, 1),
            f"{c.name}: output shapes {tuple(o.shape)}, {tuple(lse.shape)}")
    require(bool(torch.isfinite(o).all()), f"{c.name}: non-finite o")
    require(o_ok, f"{c.name}: o differs from the plain version "
                  f"(max abs {o_err.max().item()})")
    require(lse_err <= LSE_ATOL, f"{c.name}: lse differs by {lse_err}")
    return {"o_max_abs_err": o_err.max().item(), "lse_max_abs_err": lse_err}


def phase_kernel() -> dict:
    import torch
    import torch.nn.functional as F

    from cloudtik_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for c in ATTN_CASES:
        q, k, v = make_qkv(c, gen)
        scale = c.D ** -0.5
        o, lse = FA.flash_attention_fwd(q, k, v, causal=c.causal,
                                        sm_scale=scale)
        fwd_errors = check_fwd(c, q, k, v, o, lse, scale)
        kernel_ms = time_ms(lambda: FA.flash_attention_fwd(
            q, k, v, causal=c.causal, sm_scale=scale))
        plain_ms = time_ms(lambda: FA.flash_attention_reference(
            q, k, v, causal=c.causal, sm_scale=scale), iters=3)
        gqa = {"enable_gqa": True} if c.H != c.Hkv else {}
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=c.causal, scale=scale, **gqa))
        bound_ms, bound_by, flops, nbytes = attention_bound(c)
        row = {
            "case": c.name, "shape_q": list(q.shape), "hkv": c.Hkv,
            "skv": c.Skv, "causal": c.causal, "dtype": c.dtype,
            "layout": c.layout, **fwd_errors,
            "tolerance": {"o_atol": O_ATOL, "o_rtol": O_RTOL,
                          "lse_atol": LSE_ATOL},
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            "tflops_per_s": flops / kernel_ms / 1e9,
        }
        emit("kernel", **row)
        results.append(row)
        del q, k, v, o, lse
        torch.cuda.empty_cache()
    return {r["case"]: r for r in results}


# -------------------------------------------------------------- kernel_bwd --

# The first case is the shape and layout the training path gives the
# kernels (tpu_1b at B=8, S=2048; do arrives in o's layout).
BWD_CASES = (
    AttnCase("train_b8", 8, 16, 16, 2048, 128, True, layout="bshd"),
) + ATTN_CASES[1:]
# bf16/fp16 gradients: p and ds are rounded to 8/11 mantissa bits before
# their products in both versions, but from f32 scores summed in another
# order, so a rounding may flip; dk/dv sum up to S such terms.  Held per
# element at 2e-2 + 2e-2 |ref| and as a whole at 1e-2 relative L2.
GRAD_ATOL, GRAD_RTOL, GRAD_REL_L2 = 2e-2, 2e-2, 1e-2


def attention_bwd_bound(c: AttnCase, elem_bytes: int = 2) -> dict:
    """Least time of each backward kernel for the work its inputs need:
    unmasked (q, kv) pairs only (dq: 3 products, 6 * pairs * D flops per
    (b, h); dk/dv: 4 products, 8 * pairs * D), each input read once (q,
    k, v, do, and lse and delta in f32), each output written once."""
    pairs = live_pairs(c)
    q_elems = c.B * c.H * c.S * c.D
    kv_elems = c.B * c.Hkv * c.Skv * c.D
    stats = 2 * 4 * c.B * c.H * c.S
    inputs = elem_bytes * (2 * q_elems + 2 * kv_elems) + stats
    out = {}
    for name, per_pair, written in (("dq", 6, q_elems),
                                    ("dkv", 8, 2 * kv_elems)):
        flops = per_pair * c.B * c.H * pairs * c.D
        nbytes = inputs + elem_bytes * written
        t_ops = flops / PEAK_BF16_FLOPS
        t_bytes = nbytes / PEAK_BYTES_PER_S
        out[name] = {"bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes", "flops": flops, "bytes": nbytes}
    return out


def _grad_errors(got, want) -> dict:
    err = (got.float() - want.float())
    ref = want.float()
    return {"max_abs": err.abs().max().item(),
            "rel_l2": (err.norm() / ref.norm()).item(),
            "within": bool((err.abs() <= GRAD_ATOL
                            + GRAD_RTOL * ref.abs()).all()),
            "finite": bool(_all_finite(got))}


def _all_finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t).all())


def phase_kernel_bwd() -> dict:
    import torch
    import torch.nn.functional as F

    from cloudtik_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(1)
    results = []
    for c in BWD_CASES:
        q, k, v = make_qkv(c, gen)
        do = _rand_heads(c, gen, c.H, c.S)
        scale = c.D ** -0.5
        o, lse = FA.flash_attention_fwd(q, k, v, causal=c.causal,
                                        sm_scale=scale)
        # the backward reads the forward's o and lse: hold them first
        fwd_errors = check_fwd(c, q, k, v, o, lse, scale)
        dq, dk, dv = FA.flash_attention_bwd(q, k, v, o, lse, do,
                                            causal=c.causal, sm_scale=scale)
        torch.cuda.synchronize()
        want = FA.flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal=c.causal, sm_scale=scale)
        errors = {n: _grad_errors(g, w)
                  for n, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
        del want
        for n, e in errors.items():
            require(e["finite"], f"{c.name}: non-finite {n}")
            require(e["within"] and e["rel_l2"] <= GRAD_REL_L2,
                    f"{c.name}: {n} differs from the plain version {e}")
        require(dq.shape == q.shape and dk.shape == k.shape
                and dv.shape == v.shape, f"{c.name}: gradient shapes")
        delta = FA._bwd_delta(o, do)
        dq_ms = time_ms(lambda: FA._launch_dq(
            q, k, v, do, lse, delta, c.causal, scale))
        dkv_ms = time_ms(lambda: FA._launch_dkv(
            q, k, v, do, lse, delta, c.causal, scale))
        bwd_ms = time_ms(lambda: FA.flash_attention_bwd(
            q, k, v, o, lse, do, causal=c.causal, sm_scale=scale))
        plain_ms = time_ms(lambda: FA.flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal=c.causal, sm_scale=scale), iters=3)
        # yardstick: SDPA forward+backward minus SDPA forward
        gqa = {"enable_gqa": True} if c.H != c.Hkv else {}
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=c.causal, scale=scale,
                **gqa).backward(do)

        with torch.no_grad():
            sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=c.causal, scale=scale, **gqa))
        sdpa_bwd_ms = time_ms(sdpa_fwd_bwd) - sdpa_fwd_ms
        bound = attention_bwd_bound(c)
        row = {
            "case": c.name, "shape_q": list(q.shape), "hkv": c.Hkv,
            "skv": c.Skv, "causal": c.causal, "dtype": c.dtype,
            "layout": c.layout, "errors": errors, "fwd_errors": fwd_errors,
            "tolerance": {"o_atol": O_ATOL, "o_rtol": O_RTOL,
                          "lse_atol": LSE_ATOL,
                          "atol": GRAD_ATOL, "rtol": GRAD_RTOL,
                          "rel_l2": GRAD_REL_L2, "why": (
                              "p and ds rounded to the input type before "
                              "their products in both versions, from f32 "
                              "scores summed in another order")},
            "dq": {"kernel_ms": dq_ms, **bound["dq"],
                   "tflops_per_s": bound["dq"]["flops"] / dq_ms / 1e9},
            "dkv": {"kernel_ms": dkv_ms, **bound["dkv"],
                    "tflops_per_s": bound["dkv"]["flops"] / dkv_ms / 1e9},
            "bwd_ms": bwd_ms,
            "plain_ms": plain_ms,
            "plain_is": "flash_attention_bwd_reference: dq, dk, dv together",
            "library_ms": sdpa_bwd_ms,
            "library_is": "SDPA forward+backward minus SDPA forward "
                          "(dq, dk, dv together)",
        }
        emit("kernel_bwd", **row)
        results.append(row)
        del q, k, v, do, o, lse, dq, dk, dv, qs, ks, vs, delta
        torch.cuda.empty_cache()
    return {r["case"]: r for r in results}


# ----------------------------------------------------------------- serving --

def _http(url: str, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_serve(model: str = "tpu_1b", device: str = "cuda") -> dict:
    import numpy as np
    import torch

    from cloudtik_tpu_torch.models import generate as G
    from cloudtik_tpu_torch.serve.server import ServeServer, \
        transformer_backend

    backend = transformer_backend(model, device=device)
    cfg, params = backend.cfg, backend.params
    V = cfg.vocab_size
    server = ServeServer([backend], host="127.0.0.1", port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    rng = np.random.default_rng(0)
    out = {}
    try:
        require(_http(base + "/healthz") == (200, {"status": "ok"}),
                "healthz")
        require(_http(base + "/v1/models")[1]["models"]
                == [f"transformer:{model}"], "models")
        # warm-up: first cuBLAS/allocator use, not timed
        status, _ = _http(base + "/v1/generate",
                          {"tokens": [[1, 2, 3]], "max_new_tokens": 2})
        require(status == 200, f"warm-up status {status}")

        for name, batch, plen, new in (("greedy_b1", 1, 128, 32),
                                       ("greedy_b2", 2, 64, 16)):
            prompt = rng.integers(0, V, (batch, plen)).tolist()
            t0 = time.perf_counter()
            status, body = _http(base + "/v1/generate",
                                 {"tokens": prompt, "max_new_tokens": new})
            wall = time.perf_counter() - t0
            require(status == 200, f"{name}: status {status} {body}")
            toks = np.asarray(body["tokens"])
            require(toks.shape == (batch, new), f"{name}: shape {toks.shape}")
            require(bool(((toks >= 0) & (toks < V)).all()), f"{name}: ids")
            direct = G.generate(
                params, torch.tensor(prompt, device=device), cfg,
                max_new_tokens=new).cpu().numpy()
            require(bool((direct == toks).all()),
                    f"{name}: served tokens differ from direct generate")
            out[name] = {"batch": batch, "prompt": plen, "new": new,
                         "wall_s": wall,
                         "tokens_per_s": batch * new / wall,
                         "equals_direct_generate": True}

        prompt = rng.integers(0, V, (1, 16)).tolist()
        topk = {"tokens": prompt, "max_new_tokens": 8, "temperature": 1.0,
                "top_k": 40, "seed": 7}
        s1, b1 = _http(base + "/v1/generate", topk)
        s2, b2 = _http(base + "/v1/generate", topk)
        require(s1 == s2 == 200, f"top-k status {s1} {s2}")
        require(b1 == b2, "top-k: same seed gave different tokens")
        direct = G.generate(
            params, torch.tensor(prompt, device=device), cfg,
            max_new_tokens=8, temperature=1.0, top_k=40,
            generator=torch.Generator(device=device).manual_seed(7))
        require(direct.cpu().tolist() == b1["tokens"],
                "top-k: served tokens differ from direct generate")
        out["topk_seeded"] = {"tokens": b1["tokens"], "repeatable": True}

        bad = [_http(base + "/v1/generate", p)[0] for p in (
            {"tokens": [[V]]}, {"tokens": "abc"}, {"max_new_tokens": 2})]
        require(bad == [400, 400, 400], f"400 path gave {bad}")
        require(_http(base + "/nope")[0] == 404, "404 path")
        require(server.drain(grace_s=5.0), "drain")
        status, _ = _http(base + "/v1/generate",
                          {"tokens": [[1]], "max_new_tokens": 1})
        require(status == 503, f"drained server answered {status}")
        out["error_paths"] = {"bad_request": bad, "not_found": 404,
                              "draining": status}
    finally:
        server.stop()
    emit("serve", **out)
    del backend, params
    return out


# ------------------------------------------------------------------ engine --

# Tie-aware greedy: each token the engine emits must have a logit within
# ENGINE_TIE_GAP of the largest at its position, by one teacher-forced
# `forward_step` over the prompt and the emitted tokens.  cuBLAS picks its
# kernels by shape, so the engine's B=8 decode and bucketed prefill need not
# round like `generate` at B=1, and a near tie may go either way; a lane that
# read another slot's KV shows as gaps of order 1 and more.
ENGINE_TIE_GAP = 0.1
# The logits check: every decode step's logits, as the engine computed them,
# within ENGINE_LOGITS_MAX_ABS of the teacher-forced ones at that position.
# At random weights the top logits crowd together, so a token that a wrong
# context chose may still sit within ENGINE_TIE_GAP of the top; this check
# holds every entry of every row.  On the H100 at tpu_1b the spread was
# 0.062 (wave and oversubscribed run), while a planted fault's weakest lane
# differed by 0.46 (lengths rolled; its tie gap only 0.17) and 3.6 (tables
# rolled): the limit sits 2.4x above the one and 3x below the other.
ENGINE_LOGITS_MAX_ABS = 0.15


@dataclasses.dataclass(frozen=True)
class EngineLoad:
    """The engine phase's configuration and traffic.  Request i asks for a
    prompt of prompt_lens[i % 4] tokens of its own; the even-numbered ones
    open with one shared prefix_len-token prefix first (a system prompt,
    cached by the warm-up request before the wave); requests with
    i % 4 == 1 ask for short_new tokens, the others for new_tokens."""
    slots: int = 8
    max_len: int = 1024
    block_size: int = 16
    prompt_lens: tuple = (32, 128, 384, 700)
    prefix_len: int = 256
    clients: int = 16
    new_tokens: int = 64
    short_new: int = 16
    oversize_prompt: int = 1100
    # the oversubscribed run: 3 requests' worth of blocks for `slots`
    # requests whose prompts alone take every block
    over_prompt: int = 384
    over_new: int = 64
    min_full_steps: int = 20


ENGINE_LOAD = EngineLoad()
# the CPU rehearsal at `tiny`: the same traffic at a quarter of the lengths
REHEARSAL_LOAD = EngineLoad(
    max_len=256, block_size=8, prompt_lens=(8, 32, 96, 175), prefix_len=64,
    new_tokens=16, short_new=6, oversize_prompt=300, over_prompt=96,
    over_new=16, min_full_steps=1)


def teacher_logits(params, cfg, prompt, tokens, device):
    """[len(tokens), vocab] f32: row k is the logits that choose tokens[k],
    by one teacher-forced forward over prompt + tokens."""
    import torch

    from cloudtik_tpu_torch.models import generate as G

    seq = list(prompt) + list(tokens[:-1])
    cache = G.init_cache(cfg, 1, len(seq), device)
    with torch.no_grad():
        logits, _ = G.forward_step(
            params, torch.tensor([seq], device=device), cache, cfg)
    return logits[0, len(prompt) - 1:]


def tie_gaps(params, cfg, prompt, tokens, device, teacher=None) -> list:
    """For each emitted token, the largest logit at its position less the
    token's own, teacher-forced."""
    import torch

    pos = teacher_logits(params, cfg, prompt, tokens, device) \
        if teacher is None else teacher
    chosen = pos.gather(-1, torch.tensor(tokens, device=device)[:, None])
    return (pos.max(-1).values - chosen[:, 0]).tolist()


class StepLogits:
    """Records, while entered, the logits of every decode step of `engine`
    as its `decode_step` computed them: `rows(request_id)[k]` is the row
    that chose that request's tokens[k].  `fault` plants a fault for the
    checks' power run: "tables" or "lengths" hands the step that tensor
    rolled one lane on, as a lane reading another slot's KV or offset
    would; "adapters" rolls a gathered LoRA step's adapter indices one
    lane on, as a lane decoding under another lane's adapter would, and
    `changed(request_id)` says whether that moved the request's own."""

    FAULTS = ("tables", "lengths")

    def __init__(self, engine, fault: str = None):
        require(fault in (None, "adapters") + self.FAULTS,
                f"unknown fault {fault}")
        self.engine, self.fault, self._steps = engine, fault, []
        self._changed = set()

    def __enter__(self):
        from cloudtik_tpu_torch.serve import engine as E

        self._module, self._orig = E, E.decode_logits

        def decode_logits(params, tokens, kp, vp, tables, lengths, active,
                          cfg, block_size, lora=None):
            if kp is not self.engine._kp:
                return self._orig(params, tokens, kp, vp, tables, lengths,
                                  active, cfg, block_size, lora=lora)
            lanes = [(b, s.request.request_id, len(s.request.tokens))
                     for b, s in enumerate(self.engine._slots)
                     if s is not None and s.decoding]
            if self.fault == "tables":
                tables = tables.roll(1, 0)
            elif self.fault == "lengths":
                lengths = lengths.roll(1, 0)
            elif self.fault == "adapters" and lora is not None:
                rolled = lora["idx"].roll(1, 0)
                moved = (lora["idx"] != rolled).tolist()
                self._changed.update(rid for b, rid, _ in lanes
                                     if moved[b])
                lora = dict(lora, idx=rolled)
            out = self._orig(params, tokens, kp, vp, tables, lengths,
                             active, cfg, block_size, lora=lora)
            self._steps.append((out.clone(), lanes))
            return out

        E.decode_logits = decode_logits
        return self

    def __exit__(self, *exc):
        self._module.decode_logits = self._orig

    def rows(self, request_id) -> dict:
        # a preempted request decodes a position again: the last one counts
        return {k: logits[b] for logits, lanes in self._steps
                for b, rid, k in lanes if rid == request_id}

    def changed(self, request_id) -> bool:
        return request_id in self._changed


class VerifyLogits:
    """Records, while entered, the logits of every speculative verify of
    `engine`: `rows(request)[k]` is the verify row that scored the
    request's tokens[k], for each row whose input was the request's own
    sequence (the pending token and the proposals accepted before it), so
    rows after a rejected proposal are left out.  `fault="shift"` runs the
    verify one position on (`start + 1`), as a verify writing and reading
    at a wrong cursor would."""

    def __init__(self, engine, fault: str = None):
        require(fault in (None, "shift"), f"unknown fault {fault}")
        self.engine, self.fault, self._rounds = engine, fault, []

    def __enter__(self):
        from cloudtik_tpu_torch.models import generate as G

        self._module, self._orig = G, G.paged_verify
        spec_step = self.engine._spec_step
        current = {}

        def tagged_spec_step(slot_id, slot):
            current["request"] = slot.request
            return spec_step(slot_id, slot)

        def paged_verify(params, kp, vp, table, tokens, start, cfg):
            out = self._orig(params, kp, vp, table, tokens,
                             start + (self.fault == "shift"), cfg)
            self._rounds.append((current["request"], start,
                                 tokens[0].tolist(), out[2][0].clone()))
            return out

        self.engine._spec_step = tagged_spec_step
        G.paged_verify = paged_verify
        return self

    def __exit__(self, *exc):
        self._module.paged_verify = self._orig
        del self.engine._spec_step

    def rows(self, req) -> dict:
        out = {}
        for r, start, inputs, logits in self._rounds:
            if r is not req:
                continue
            k0 = start - len(req.prompt) + 1   # tokens[k0 - 1] is pending
            for i in range(len(inputs)):
                if k0 + i >= len(req.tokens) \
                        or inputs[i] != req.tokens[k0 - 1 + i]:
                    break
                out[k0 + i] = logits[i]
        return out

    def rounds(self, req) -> int:
        return sum(r is req for r, *_ in self._rounds)


def logits_diff(teacher, rows: dict) -> float:
    """The largest |engine - teacher| over every recorded step's logits."""
    require(rows, "no decode step was recorded")
    return max(float((row - teacher[k]).abs().max())
               for k, row in rows.items())


def greedy_margins(params, cfg, prompt, tokens, device) -> list:
    """Top-1 less top-2 logit at each of `tokens`' positions (the direct
    greedy path's own tokens), teacher-forced."""
    import torch

    top = torch.topk(teacher_logits(params, cfg, prompt, tokens, device),
                     2, dim=-1).values
    return (top[:, 0] - top[:, 1]).tolist()


def check_tie_aware(name: str, gaps: list) -> float:
    worst = max(gaps)
    require(worst <= ENGINE_TIE_GAP,
            f"{name}: an emitted token's logit is {worst} below the "
            f"largest at its position (limit {ENGINE_TIE_GAP})")
    return worst


def check_answer(name, params, cfg, prompt, tokens, recorder, request_id,
                 device) -> tuple:
    """The tie-aware greedy check and the logits check of one answer;
    returns (largest tie gap, largest logits difference)."""
    teacher = teacher_logits(params, cfg, prompt, tokens, device)
    gap = check_tie_aware(name, tie_gaps(params, cfg, prompt, tokens,
                                         device, teacher))
    diff = logits_diff(teacher, recorder.rows(request_id))
    require(diff <= ENGINE_LOGITS_MAX_ABS,
            f"{name}: a decode step's logits are {diff} from the "
            f"teacher-forced ones (limit {ENGINE_LOGITS_MAX_ABS})")
    return gap, diff


def planted_fault(params, cfg, load, prompts, fault: str,
                  device) -> dict:
    """The checks' power at the phase's own shape: `load.slots` requests of
    `prompts` through an engine whose decode step gets its block tables or
    lengths rolled one lane on (`fault` None: neither).  Returns, over the
    lanes, the smallest of each lane's largest tie gap and logits
    difference, and how many lanes each check flags."""
    from cloudtik_tpu_torch.serve.engine import (
        DecodeEngine, EngineConfig, Request)

    eng = DecodeEngine(params, cfg, EngineConfig(
        slots=load.slots, max_len=load.max_len,
        block_size=load.block_size), device=device)
    reqs = [eng.submit(Request(p, max_new_tokens=load.short_new))
            for p in prompts[:load.slots]]
    with StepLogits(eng, fault) as rec:
        eng.start()
        try:
            outs = [r.wait(timeout=600) for r in reqs]
        finally:
            eng.stop()
    gaps, diffs = [], []
    for r, toks in zip(reqs, outs):
        teacher = teacher_logits(params, cfg, r.prompt, toks, device)
        gaps.append(max(tie_gaps(params, cfg, r.prompt, toks, device,
                                 teacher)))
        diffs.append(logits_diff(teacher, rec.rows(r.request_id)))
    return {"fault": fault, "lanes": len(reqs),
            "tie_gap_min_lane": min(gaps),
            "lanes_flagged_by_tie_gap": sum(g > ENGINE_TIE_GAP
                                            for g in gaps),
            "logits_diff_min_lane": min(diffs),
            "lanes_flagged_by_logits": sum(d > ENGINE_LOGITS_MAX_ABS
                                           for d in diffs)}


def _percentiles(values: list) -> dict:
    import numpy as np

    return {"p50": float(np.percentile(values, 50)),
            "p95": float(np.percentile(values, 95))}


def engine_traffic(params, cfg, load: EngineLoad, device,
                   direct_new: int = None) -> dict:
    """The engine phase's requests, from numpy seed 0: `load.clients`
    prompts (the even ones behind one shared `load.prefix_len`-token
    prefix) and their new-token counts; each prompt's direct greedy
    answer (its first `direct_new` tokens when given); and the EOS
    request, the one whose first five direct tokens lead their runners-up
    by the most, so its stop position does not hang on a near tie, with
    its EOS token.  `rng` goes on drawing for the phase."""
    import numpy as np
    import torch

    from cloudtik_tpu_torch.models import generate as G

    L, V = load, cfg.vocab_size
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, V, L.prefix_len).tolist()
    prompts, news = [], []
    for i in range(L.clients):
        own = rng.integers(0, V, L.prompt_lens[i % 4]).tolist()
        prompts.append(prefix + own if i % 2 == 0 else own)
        news.append(L.short_new if i % 4 == 1 else L.new_tokens)
    direct = [G.generate(params, torch.tensor([p], device=device), cfg,
                         max_new_tokens=min(n, direct_new or n))[0].tolist()
              for p, n in zip(prompts, news)]
    margins = [min(greedy_margins(params, cfg, p, d[:5], device))
               if d[4] not in d[:4] else -1.0
               for p, d in zip(prompts, direct)]
    eos_i = int(np.argmax(margins))
    return {"rng": rng, "prefix": prefix, "prompts": prompts, "news": news,
            "direct": direct, "margins": margins, "eos_i": eos_i,
            "eos": direct[eos_i][4]}


def phase_engine(model: str = "tpu_1b", device: str = "cuda",
                 load: EngineLoad = ENGINE_LOAD,
                 nvidia_smi: str = None) -> dict:
    """`tik-serve --engine`'s backend at `model` width behind ServeServer:
    one warm-up request, then `load.clients` concurrent HTTP clients; the
    413 and cancel paths; then an oversubscribed direct DecodeEngine that
    must preempt.  Every result passes the tie-aware greedy check."""
    import tempfile
    import threading

    import torch

    from cloudtik_tpu_torch import telemetry
    from cloudtik_tpu_torch.serve import kvcache, reqlog
    from cloudtik_tpu_torch.serve.engine import (
        DecodeEngine, EngineConfig, Request, RequestCancelled)
    from cloudtik_tpu_torch.serve.server import ServeServer, engine_backend
    from cloudtik_tpu_torch.telemetry import instruments as ti

    on_card = device == "cuda"
    L = load
    telemetry.enable()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    backend = engine_backend(model, slots=L.slots, max_len=L.max_len,
                             block_size=L.block_size, device=device)
    engine, cfg, params = backend.engine, backend.cfg, backend.params
    chunk_max = engine._chunk_max
    V = cfg.vocab_size
    traffic = engine_traffic(params, cfg, L, device)
    rng, prefix, prompts, news, direct, margins, eos_i, eos = (
        traffic[k] for k in ("rng", "prefix", "prompts", "news", "direct",
                             "margins", "eos_i", "eos"))

    server = ServeServer([backend], host="127.0.0.1", port=0)
    server.start()
    url = f"http://127.0.0.1:{server.port}/v1/generate"
    out = {"model": model, "dtype": str(cfg.dtype).replace("torch.", ""),
           "nvidia_smi": nvidia_smi, "slots": L.slots,
           "max_len": L.max_len, "block_size": L.block_size,
           "pool_blocks": engine.pool.num_blocks,
           "pool_gib": 2 * engine._kp.numel() * engine._kp.element_size()
           / 2 ** 30}
    try:
        status, _ = _http(url, {"tokens": [prefix + prompts[1][:8]],
                                "max_new_tokens": 2})
        require(status == 200, f"engine warm-up status {status}")
        hits0 = ti.SERVE_PREFIX_HITS.value()
        saved0 = ti.SERVE_PREFIX_TOKENS_SAVED.value()
        telemetry.SPAN_RING.clear()
        results = [None] * L.clients

        def client(i):
            payload = {"tokens": [prompts[i]], "max_new_tokens": news[i]}
            if i == eos_i:
                payload["eos_id"] = eos
            results[i] = _http(url, payload)

        with tempfile.TemporaryDirectory() as tmp, \
                StepLogits(engine) as wave_rec:
            path = f"{tmp}/requests.jsonl"
            reqlog.install(path)
            try:
                threads = [threading.Thread(target=client, args=(i,))
                           for i in range(L.clients)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                wall = time.perf_counter() - t0
            finally:
                reqlog.uninstall()
            records = {r["request_id"]: r
                       for r in reqlog.read_requests(path)}
        steps = [s["dur"] * 1e3 for s in telemetry.spans()
                 if s["name"] == "serve.decode_step"
                 and s["attrs"].get("active") == L.slots]

        require(not any(t.is_alive() for t in threads), "a client hung")
        toks, gaps, diffs, exact = [], [], [], 0
        for i, (status, body) in enumerate(results):
            require(status == 200, f"request {i}: status {status} {body}")
            got = body["tokens"][0]
            want = direct[i][:5] if i == eos_i else direct[i]
            if i == eos_i:
                require(got[-1] == eos and eos not in got[:-1],
                        f"request {i} did not stop at its EOS: {got}")
            else:
                require(len(got) == news[i],
                        f"request {i}: {len(got)} tokens, asked {news[i]}")
            require(all(0 <= t < V for t in got), f"request {i}: ids")
            gap, diff = check_answer(f"request {i}", params, cfg,
                                     prompts[i], got, wave_rec,
                                     body["request_id"], device)
            gaps.append(gap)
            diffs.append(diff)
            exact += got == want
            toks.append(got)
        recs = [records[body["request_id"]] for _, body in results]
        for i, rec in enumerate(recs):
            if i % 4 == 3:
                want_chunks = -(-len(prompts[i]) // chunk_max)
                require(rec["prefill_chunks"] == want_chunks,
                        f"request {i}: {rec['prefill_chunks']} prefill "
                        f"chunks, expected {want_chunks}")
        hits = ti.SERVE_PREFIX_HITS.value() - hits0
        saved = ti.SERVE_PREFIX_TOKENS_SAVED.value() - saved0
        n_prefixed = (L.clients + 1) // 2
        require(hits >= n_prefixed - 1
                and saved >= (n_prefixed - 1) * L.prefix_len,
                f"prefix cache: {hits} hits, {saved} tokens saved")
        require(len(steps) >= L.min_full_steps,
                f"only {len(steps)} decode steps with {L.slots} lanes")

        status, body = _http(url, {"tokens": [[1] * L.oversize_prompt],
                                   "max_new_tokens": 1})
        require(status == 413 and body.get("reason") == "capacity",
                f"oversize prompt: {status} {body}")
        cancelled = engine.submit(Request(
            prompts[1], max_new_tokens=L.max_len - len(prompts[1]) - 1))
        deadline = time.monotonic() + 300
        while len(cancelled.tokens) < 2:
            require(time.monotonic() < deadline
                    and not cancelled._done.is_set(),
                    "the request to cancel never decoded")
            time.sleep(0.001)
        cancelled.cancel()
        try:
            cancelled.wait(timeout=300)
            require(False, "the cancelled request finished normally")
        except RequestCancelled:
            pass
        while engine.pool.used() and time.monotonic() < deadline:
            time.sleep(0.001)
        require(engine.pool.used() == 0
                and engine.pool.available() == engine.pool.usable_blocks,
                f"pool after the wave: {engine.pool.used()} used, "
                f"{engine.pool.available()} available")
        out["wave"] = {
            "clients": L.clients, "wall_s": wall,
            "generated_tokens": sum(map(len, toks)),
            "tokens_per_s": sum(map(len, toks)) / wall,
            "ttft_s": _percentiles([r["ttft_s"] for r in recs]),
            "tpot_s": _percentiles([r["tpot_s"] for r in recs
                                    if r["tpot_s"] is not None]),
            "decode_step_ms_full": {
                "lanes": L.slots, "steps": len(steps),
                "mean": sum(steps) / len(steps)},
            "prefill_chunks": [r["prefill_chunks"] for r in recs],
            "prefix_hits": hits, "prefix_tokens_saved": saved,
            "eos_request": eos_i, "eos_margin": margins[eos_i],
            "tie_gap_max": max(gaps), "tie_gap_limit": ENGINE_TIE_GAP,
            "logits_diff_max": max(diffs),
            "logits_diff_limit": ENGINE_LOGITS_MAX_ABS,
            "equal_direct_generate": exact,
            "oversize": 413, "cancelled": True}
    finally:
        server.stop()
        engine.stop()

    # the oversubscribed run: every prompt's blocks fill the pool, so the
    # first decode growth preempts the newest request
    over = DecodeEngine(params, cfg, EngineConfig(
        slots=L.slots, max_len=L.max_len, block_size=L.block_size,
        num_blocks=1 + 3 * kvcache.blocks_for(L.max_len, L.block_size)),
        device=device)
    reqs = [over.submit(Request(rng.integers(0, V, L.over_prompt).tolist(),
                                max_new_tokens=L.over_new))
            for _ in range(L.slots)]
    t0 = time.perf_counter()
    with StepLogits(over) as over_rec:
        over.start()
        try:
            outs = [r.wait(timeout=600) for r in reqs]
            wall = time.perf_counter() - t0
        finally:
            over.stop()
    gaps, diffs = zip(*[
        check_answer(f"oversubscribed {i}", params, cfg, r.prompt, toks,
                     over_rec, r.request_id, device)
        for i, (r, toks) in enumerate(zip(reqs, outs))])
    preemptions = sum(r.preemptions for r in reqs)
    require(preemptions >= 1, "the oversubscribed run never preempted")
    require(all(len(r.tokens) == L.over_new for r in reqs),
            "oversubscribed: token counts")
    require(over.pool.used() == 0
            and over.pool.available() == over.pool.usable_blocks,
            "oversubscribed: pool not free after stop")
    out["oversubscribed"] = {
        "requests": L.slots, "prompt": L.over_prompt, "new": L.over_new,
        "pool_blocks": over.pool.num_blocks, "preemptions": preemptions,
        "wall_s": wall, "tie_gap_max": max(gaps),
        "logits_diff_max": max(diffs)}
    # the checks' power: a fault planted in the decode step must be caught
    # by the logits check in every lane
    out["planted"] = [planted_fault(params, cfg, L, prompts, fault, device)
                      for fault in StepLogits.FAULTS]
    for p in out["planted"]:
        require(p["lanes_flagged_by_logits"] == p["lanes"],
                f"the logits check missed a planted fault: {p}")
    out["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                          if on_card else None)
    emit("engine", **out)
    del backend, params, engine, over
    if on_card:
        torch.cuda.empty_cache()
    return out


# -------------------------------------------------------------------- spec --

@dataclasses.dataclass(frozen=True)
class SpecLoad:
    """The spec phase's configuration and traffic: `clients` concurrent
    requests, prompt lengths in turn from `prompt_lens`, `new_tokens`
    each; the last client samples (temperature 0.8), and the greedy
    request with the widest margins stops at an EOS that its first round
    accepts.  `drafts` are the `--spec-model` presets: one that disagrees
    with the target (its own architecture, random weights) and the
    target's own preset, a self-draft (seed 0 both)."""
    slots: int = 8
    max_len: int = 1024
    block_size: int = 16
    k: int = 4
    clients: int = 8
    prompt_lens: tuple = (32, 128, 256, 384)
    new_tokens: int = 32
    drafts: tuple = ("tpu_120m", "tpu_1b")
    fault_new: int = 16


SPEC_LOAD = SpecLoad()
# the CPU rehearsal at `tiny`: a quarter of the lengths; `tiny` is the only
# dense preset of its vocabulary, so both runs are self-drafts there
SPEC_REHEARSAL = SpecLoad(max_len=256, block_size=8,
                          prompt_lens=(8, 32, 64, 96), new_tokens=12,
                          drafts=("tiny", "tiny"), fault_new=8)
# the least acceptance of the self-draft: only bf16 near ties between the
# draft's [1,1] forwards and the [1,k+1] verify reject one of its proposals
SPEC_MIN_SELF_ACCEPTANCE = 0.8


def _collect(on_card: bool) -> None:
    """Free what the last run left: a served backend sits in a reference
    cycle (the server's handler class), so its engine and weights outlive
    the run until the collector finds them."""
    gc.collect()
    if on_card:
        import torch

        torch.cuda.empty_cache()


def spec_round_split(engine, context: int, reps: int = 5) -> dict:
    """Synchronised host ms of a spec round's parts for one slot at
    `context` tokens, on a stopped spec engine's weights and pool: one
    catch-up draft forward, the k-token `draft_propose`, the verify."""
    import torch

    from cloudtik_tpu_torch.models import generate as G

    dev, k = engine.device, engine._spec.k
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    dcfg, dparams = engine._draft_cfg, engine._draft_params
    cache = G.init_cache(dcfg, 1, engine._draft_plane, dev)
    table = torch.arange(1, engine._blocks_per_req + 1, device=dev)
    tok = torch.zeros((), dtype=torch.long, device=dev)
    window = torch.zeros((1, k + 1), dtype=torch.long, device=dev)

    def timed(fn) -> float:
        fn()
        total = 0.0
        for _ in range(reps):
            cache["length"] = context
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            total += time.perf_counter() - t0
        return total / reps * 1e3

    return {"context": context, "k": k,
            "catch_up_forward_ms": timed(lambda: G.forward_step(
                dparams, tok.reshape(1, 1), cache, dcfg)),
            "draft_propose_ms": timed(lambda: G.draft_propose(
                dparams, tok, cache, dcfg, k)),
            "verify_ms": timed(lambda: G.paged_verify(
                engine._params, engine._kp, engine._vp, table, window,
                context, engine.cfg))}


class _Rows:
    """The logits rows of one request from several recorders."""

    def __init__(self, step, verify=None):
        self.step, self.verify = step, verify

    def of(self, req) -> dict:
        rows = dict(self.step.rows(req.request_id))
        if self.verify is not None:
            rows.update(self.verify.rows(req))
        return rows


def check_rows(name, params, cfg, req, rows: dict, device,
               greedy: bool = True) -> tuple:
    """The tie-aware check (greedy answers) and the logits check of one
    finished request over `rows`; returns (largest tie gap or None,
    largest logits difference)."""
    teacher = teacher_logits(params, cfg, req.prompt, req.tokens, device)
    gap = check_tie_aware(name, tie_gaps(params, cfg, req.prompt,
                                         req.tokens, device, teacher)) \
        if greedy else None
    diff = logits_diff(teacher, rows)
    require(diff <= ENGINE_LOGITS_MAX_ABS,
            f"{name}: a step's logits are {diff} from the teacher-forced "
            f"ones (limit {ENGINE_LOGITS_MAX_ABS})")
    return gap, diff


def _serve_wave(engine, url, payloads):
    """POST `payloads` concurrently; returns (wall seconds, the engine's
    Request of each, the ledger record of each)."""
    import tempfile
    import threading

    from cloudtik_tpu_torch.serve import reqlog

    requests = {}
    submit = engine.submit

    def tagged_submit(req):
        requests[len(req.prompt), tuple(req.prompt)] = req
        return submit(req)

    results = [None] * len(payloads)

    def client(i):
        results[i] = _http(url, payloads[i])

    engine.submit = tagged_submit
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/requests.jsonl"
        reqlog.install(path)
        try:
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(payloads))]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
        finally:
            reqlog.uninstall()
            del engine.submit
        # a disaggregated pair also writes each request's "migrated"
        # milestone (the prefill role's half) under the same id
        records = {r["request_id"]: r for r in reqlog.read_requests(path)
                   if r["finish"] != reqlog.FINISH_MIGRATED}
    require(not any(t.is_alive() for t in threads), "a client hung")
    reqs, recs = [], []
    for i, (status, body) in enumerate(results):
        require(status == 200, f"request {i}: status {status} {body}")
        prompt = payloads[i]["tokens"][0]
        req = requests[len(prompt), tuple(prompt)]
        require(body["tokens"][0] == req.tokens, f"request {i}: body")
        reqs.append(req)
        recs.append(records[req.request_id])
    return wall, reqs, recs


def _wave_numbers(wall, reqs, recs, steps_ms=None) -> dict:
    n = sum(len(r.tokens) for r in reqs)
    out = {"wall_s": wall, "generated_tokens": n, "tokens_per_s": n / wall,
           "ttft_s": _percentiles([r["ttft_s"] for r in recs]),
           "tpot_s": _percentiles([r["tpot_s"] for r in recs
                                   if r["tpot_s"] is not None])}
    if steps_ms:
        out["decode_step_ms"] = {"steps": len(steps_ms),
                                 "mean": sum(steps_ms) / len(steps_ms)}
    return out


def phase_spec(model: str = "tpu_1b", device: str = "cuda",
               load: SpecLoad = SPEC_LOAD, nvidia_smi: str = None) -> dict:
    """`tik-serve --engine --spec-model`: `engine_backend(model,
    spec_model=draft, spec_k=k)` behind ServeServer for each of
    `load.drafts`, then a plain `--engine` run of the same requests, then
    a self-draft engine whose verify runs one position on (planted fault).
    Every greedy answer passes the tie-aware check; every verify row at an
    accepted or emitted position, and every plain decode step's row,
    passes the logits check."""
    import numpy as np
    import torch

    from cloudtik_tpu_torch import telemetry
    from cloudtik_tpu_torch.models import generate as G
    from cloudtik_tpu_torch.serve.engine import (
        DecodeEngine, EngineConfig, Request, SpecConfig)
    from cloudtik_tpu_torch.serve.server import ServeServer, engine_backend

    on_card = device == "cuda"
    L = load
    telemetry.enable()
    _collect(on_card)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out = {"model": model, "nvidia_smi": nvidia_smi, "slots": L.slots,
           "max_len": L.max_len, "block_size": L.block_size, "k": L.k,
           "clients": L.clients, "new_tokens": L.new_tokens, "runs": {}}
    rng = np.random.default_rng(1)
    payloads = eos_i = None
    for run, draft in (("plain", None), ("other_draft", L.drafts[0]),
                       ("self_draft", L.drafts[1])):
        backend = engine_backend(
            model, slots=L.slots, max_len=L.max_len,
            block_size=L.block_size, spec_model=draft, spec_k=L.k,
            device=device)
        engine, cfg, params = backend.engine, backend.cfg, backend.params
        if payloads is None:
            V = cfg.vocab_size
            prompts = [rng.integers(0, V, L.prompt_lens[i % 4]).tolist()
                       for i in range(L.clients)]
            # the EOS request: the greedy one whose first direct tokens
            # lead their runners-up by the most; EOS is its 3rd token, the
            # 2nd proposal of its first round
            margins = []
            for p in prompts[:-1]:
                d = G.generate(params, torch.tensor([p], device=device),
                               cfg, max_new_tokens=4)[0].tolist()
                margins.append((min(greedy_margins(params, cfg, p, d,
                                                   device))
                                if d[2] not in d[:2] else -1.0, d[2]))
            eos_i = int(np.argmax([m for m, _ in margins]))
            payloads = [{"tokens": [p], "max_new_tokens": L.new_tokens}
                        for p in prompts]
            payloads[eos_i]["eos_id"] = margins[eos_i][1]
            payloads[-1]["temperature"] = 0.8
        server = ServeServer([backend], host="127.0.0.1", port=0)
        server.start()
        url = f"http://127.0.0.1:{server.port}/v1/generate"
        try:
            status, _ = _http(url, {"tokens": [[1, 2, 3]],
                                    "max_new_tokens": 2})
            require(status == 200, f"spec warm-up status {status}")
            telemetry.SPAN_RING.clear()
            with StepLogits(engine) as step_rec, \
                    VerifyLogits(engine) as verify_rec:
                wall, reqs, recs = _serve_wave(engine, url, payloads)
        finally:
            server.stop()
            engine.stop()
        require(engine.pool.used() == 0
                and engine.pool.available() == engine.pool.usable_blocks,
                f"{run}: pool not free after stop")
        rows = _Rows(step_rec, verify_rec if draft else None)
        gaps, diffs = [], []
        for i, req in enumerate(reqs):
            greedy = i != L.clients - 1
            gap, diff = check_rows(f"{run} request {i}", params, cfg, req,
                                   rows.of(req), device, greedy)
            diffs.append(diff)
            if greedy:
                gaps.append(gap)
        eos_req = reqs[eos_i]
        require(eos_req.tokens[-1] == payloads[eos_i]["eos_id"]
                and len(eos_req.tokens) == 3,
                f"{run}: the EOS request gave {eos_req.tokens}")
        require(all(len(r.tokens) == L.new_tokens
                    for i, r in enumerate(reqs) if i != eos_i),
                f"{run}: token counts")
        spans = telemetry.spans()
        numbers = _wave_numbers(wall, reqs, recs, [
            s["dur"] * 1e3 for s in spans
            if s["name"] == "serve.decode_step"])
        numbers.update(tie_gap_max=max(gaps), logits_diff_max=max(diffs))
        if draft:
            require(recs[-1]["spec_steps"] == 0,
                    f"{run}: the sampled request speculated")
            greedy_recs = recs[:-1]
            drafted = sum(r["draft_tokens"] for r in greedy_recs)
            accepted = sum(r["accepted_tokens"] for r in greedy_recs)
            verifies = sum(r["spec_steps"] for r in greedy_recs)
            per_req = [r["accepted_tokens"] / r["draft_tokens"]
                       for r in greedy_recs if r["draft_tokens"]]
            rounds = [s["dur"] * 1e3 for s in spans
                      if s["name"] == "serve.spec.verify"]
            require(verifies >= len(greedy_recs) and rounds,
                    f"{run}: {verifies} verify rounds")
            require(sum(len(verify_rec.rows(r)) for r in reqs) > 0,
                    f"{run}: no verify row was recorded")
            numbers.update(
                draft=draft, acceptance=accepted / drafted,
                acceptance_per_request={"min": min(per_req),
                                        "max": max(per_req)},
                tokens_per_verify=(accepted + verifies) / verifies,
                verifies=verifies, spec_round_ms={
                    "rounds": len(rounds),
                    "mean": sum(rounds) / len(rounds)},
                eos_stop_in_first_round=recs[eos_i]["spec_steps"] == 1,
                round_split=spec_round_split(engine, max(L.prompt_lens)
                                             + L.new_tokens // 2))
        out["runs"][run] = numbers
        if run == "self_draft":
            self_params, self_draft = params, engine._draft_params
        del backend, engine, params, server, reqs, step_rec, verify_rec
        _collect(on_card)
    self_run = out["runs"]["self_draft"]
    require(self_run["acceptance"] >= SPEC_MIN_SELF_ACCEPTANCE,
            f"self-draft acceptance {self_run['acceptance']} (limit "
            f"{SPEC_MIN_SELF_ACCEPTANCE})")
    require(self_run["eos_stop_in_first_round"],
            "the self-draft's EOS request did not stop in its first round")

    # the checks' power: a self-draft engine whose verify runs at start+1
    # must be flagged by the logits check in every request
    eng = DecodeEngine(self_params, cfg, EngineConfig(
        slots=L.slots, max_len=L.max_len, block_size=L.block_size,
        spec=SpecConfig(k=L.k)), draft=(self_draft, cfg), device=device)
    reqs = [eng.submit(Request(p["tokens"][0], max_new_tokens=L.fault_new))
            for p in payloads[:L.slots]]
    with StepLogits(eng) as step_rec, \
            VerifyLogits(eng, "shift") as verify_rec:
        eng.start()
        try:
            for r in reqs:
                r.wait(timeout=600)
        finally:
            eng.stop()
    rows = _Rows(step_rec, verify_rec)
    diffs, gaps = [], []
    for r in reqs:
        require(verify_rec.rounds(r) > 0, "planted: a request never "
                "reached the verify")
        teacher = teacher_logits(self_params, cfg, r.prompt, r.tokens,
                                 device)
        diffs.append(logits_diff(teacher, rows.of(r)))
        gaps.append(max(tie_gaps(self_params, cfg, r.prompt, r.tokens,
                                 device, teacher)))
    out["planted"] = {
        "fault": "verify at start + 1", "lanes": len(reqs),
        "logits_diff_per_lane": diffs,
        "logits_diff_min_lane": min(diffs),
        "lanes_flagged_by_logits": sum(d > ENGINE_LOGITS_MAX_ABS
                                       for d in diffs),
        "tie_gap_min_lane": min(gaps),
        "lanes_flagged_by_tie_gap": sum(g > ENGINE_TIE_GAP for g in gaps)}
    require(out["planted"]["lanes_flagged_by_logits"] == len(reqs),
            f"the logits check missed the planted verify fault: "
            f"{out['planted']}")
    out["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                          if on_card else None)
    emit("spec", **out)
    del eng, reqs, self_params, self_draft
    _collect(on_card)
    return out


# -------------------------------------------------------------------- lora --

@dataclasses.dataclass(frozen=True)
class LoraLoad:
    """The lora phase's configuration and traffic.  `adapters` adapters of
    rank `rank` (alpha `alpha`, targets wq and wv) from the port's
    `random_lora_params`, `capacity` plane slots.  The mixed run: request
    i asks for adapter MIXED[i] (None: the base model) with a prompt of
    prompt_lens[i % 4] tokens; then `homogeneous` requests on one
    adapter.  `draft` is the preset of the per-adapter draft.  `b_scale`
    is `random_lora_params`' spread of b (the reference's 0.05)."""
    slots: int = 8
    max_len: int = 1024
    block_size: int = 16
    rank: int = 16
    alpha: float = 32.0
    b_scale: float = 0.05
    adapters: int = 4
    capacity: int = 3
    prompt_lens: tuple = (32, 128, 256, 384)
    new_tokens: int = 24
    homogeneous: int = 4
    draft: str = "tpu_120m"
    k: int = 4


LORA_LOAD = LoraLoad()
# the CPU rehearsal at `tiny`: its 2 layers compound an adapter's delta
# less than tpu_1b's 16, so its adapters draw b twice as wide
LORA_REHEARSAL = LoraLoad(max_len=256, block_size=8,
                          prompt_lens=(8, 32, 64, 96), new_tokens=8,
                          draft="tiny", b_scale=0.1)
# 12 requests: 3 on the base model, 9 over the 4 adapters.  The first 8
# fill the slots on 3 adapters; a3 then waits until one of them idles, and
# evicts it
MIXED = (None, "a0", "a1", "a2", None, "a0", "a1", "a2", "a3", "a3", None,
         "a3")
# the adapters must move the teacher's logits well past the logits check's
# limit, or the check could not tell a lane on the wrong adapter
LORA_MIN_ADAPTER_EFFECT = 4 * ENGINE_LOGITS_MAX_ABS


def phase_lora(model: str = "tpu_1b", device: str = "cuda",
               load: LoraLoad = LORA_LOAD, nvidia_smi: str = None) -> dict:
    """Multi-tenant LoRA on `DecodeEngine(adapters=AdapterPool(...))`:
    a mixed run of 12 concurrent greedy requests over 4 adapters and the
    base model with 3 plane slots (gathered steps, evictions, a wait on a
    pinned slot), a homogeneous run (merged steps), tenant isolation of
    the prefix cache, an unknown adapter, a spec engine with one
    per-adapter draft, and a planted fault (adapter indices rolled one
    lane on).  Every answer passes the tie-aware check and every decode
    step's logits the logits check against a teacher-forced forward over
    `merge_lora(base, adapter)`."""
    import numpy as np
    import torch

    from cloudtik_tpu_torch import telemetry
    from cloudtik_tpu_torch.models import generate as G
    from cloudtik_tpu_torch.models import lora as LO
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.serve.adapters import (
        AdapterLoadError, AdapterPool, AdapterSlotsExhausted)
    from cloudtik_tpu_torch.serve.engine import (
        DecodeEngine, EngineConfig, Request, SpecConfig)
    from cloudtik_tpu_torch.telemetry import instruments as ti

    on_card = device == "cuda"
    L = load
    telemetry.enable()
    _collect(on_card)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    cfg = T.config(model)
    params = T.init_params(torch.Generator(device=device).manual_seed(0),
                           cfg, device)
    lora_cfg = LO.LoRAConfig(rank=L.rank, alpha=L.alpha)
    bank = {f"a{i}": LO.random_lora_params(
        torch.Generator(device=device).manual_seed(i + 1), cfg, lora_cfg,
        scale=L.b_scale, device=device) for i in range(L.adapters)}
    merged = {None: params}
    merged.update({a: dict(params, layers=LO.merge_lora(
        params["layers"], ad, lora_cfg)) for a, ad in bank.items()})
    waits = []

    def make_pool():
        pool = AdapterPool(params, cfg, lora_cfg, loader=bank.__getitem__,
                           capacity=L.capacity)
        acquire = pool.acquire

        def counted_acquire(adapter_id):
            try:
                return acquire(adapter_id)
            except AdapterSlotsExhausted:
                waits.append(adapter_id)
                raise

        pool.acquire = counted_acquire
        return pool

    def make_engine(spec=None, **kw):
        _collect(on_card)    # the last section's engine and pool
        return DecodeEngine(params, cfg, EngineConfig(
            slots=L.slots, max_len=L.max_len, block_size=L.block_size,
            spec=spec), adapters=make_pool(), device=device, **kw)

    def run(eng, specs, fault=None, verify=False):
        reqs = [eng.submit(Request(p, max_new_tokens=L.new_tokens,
                                   adapter_id=a, tenant=a or "base"))
                for p, a in specs]
        t0 = time.perf_counter()
        with StepLogits(eng, fault) as step_rec:
            if verify:
                with VerifyLogits(eng) as verify_rec:
                    eng.start()
                    for r in reqs:
                        r.wait(timeout=600)
            else:
                verify_rec = None
                eng.start()
                for r in reqs:
                    r.wait(timeout=600)
        wall = time.perf_counter() - t0
        return reqs, _Rows(step_rec, verify_rec), step_rec, wall

    def check(name, reqs, rows):
        gaps, diffs = zip(*[check_rows(
            f"{name} {i}", merged[r.adapter_id], cfg, r, rows.of(r), device)
            for i, r in enumerate(reqs)])
        return max(gaps), max(diffs)

    def steps_by_lanes() -> dict:
        """Decode-step ms since the span ring was cleared, by lanes."""
        by_lanes = {}
        for s in telemetry.spans():
            if s["name"] == "serve.decode_step":
                by_lanes.setdefault(s["attrs"]["active"], []).append(
                    s["dur"] * 1e3)
        return {n: {"steps": len(v), "mean": sum(v) / len(v)}
                for n, v in sorted(by_lanes.items())}

    def pool_free(eng, name):
        require(eng.pool.used() == 0
                and eng.pool.available() == eng.pool.usable_blocks
                and not eng._adapters._ref,
                f"{name}: KV or adapter pool not free after stop")

    rng = np.random.default_rng(2)
    V = cfg.vocab_size
    prompts = [rng.integers(0, V, L.prompt_lens[i % 4]).tolist()
               for i in range(len(MIXED))]
    out = {"model": model, "nvidia_smi": nvidia_smi, "slots": L.slots,
           "max_len": L.max_len, "rank": L.rank, "alpha": L.alpha,
           "targets": list(lora_cfg.targets), "adapters": L.adapters,
           "capacity": L.capacity, "new_tokens": L.new_tokens}

    # the adapters must matter: the teacher's logits of each adapter
    # against the base model's, over one prompt and the base's answer
    base_answer = G.generate(params, torch.tensor([prompts[1]],
                                                  device=device), cfg,
                             max_new_tokens=L.new_tokens)[0].tolist()
    base_teacher = teacher_logits(params, cfg, prompts[1], base_answer,
                                  device)
    effect = {a: float((teacher_logits(merged[a], cfg, prompts[1],
                                       base_answer, device)
                        - base_teacher).abs().max())
              for a in bank}
    out["adapter_effect"] = effect
    require(min(effect.values()) >= LORA_MIN_ADAPTER_EFFECT,
            f"an adapter moves the teacher's logits by only "
            f"{min(effect.values())} (limit {LORA_MIN_ADAPTER_EFFECT})")

    # the mixed run: gathered steps, evictions and a wait on a pinned slot
    eng = make_engine()
    evictions0 = ti.SERVE_ADAPTER_EVICTIONS.value()
    telemetry.SPAN_RING.clear()
    reqs, rows, _, wall = run(eng, list(zip(prompts, MIXED)))
    eng.stop()
    steps = steps_by_lanes()
    gap, diff = check("mixed", reqs, rows)
    require(eng._gathered_steps >= 1, "the mixed run never gathered")
    require(waits, "the mixed run never waited on a pinned adapter slot")
    evictions = ti.SERVE_ADAPTER_EVICTIONS.value() - evictions0
    require(evictions >= 1, "the mixed run never evicted an adapter")
    pool_free(eng, "mixed")
    n = sum(len(r.tokens) for r in reqs)
    out["mixed"] = {
        "requests": len(reqs), "wall_s": wall, "generated_tokens": n,
        "tokens_per_s": n / wall,
        "gathered_steps": eng._gathered_steps,
        "merged_steps": eng._merged_steps, "evictions": evictions,
        "slot_waits": len(waits),
        "decode_step_ms_by_lanes": steps,
        "tie_gap_max": gap, "logits_diff_max": diff}

    # the homogeneous run: every lane on one adapter -> merged steps
    del eng, reqs, rows
    eng = make_engine()
    telemetry.SPAN_RING.clear()
    reqs, rows, _, wall = run(eng, [(p, "a1") for p in
                                    prompts[:L.homogeneous]])
    eng.stop()
    steps = steps_by_lanes()
    gap, diff = check("homogeneous", reqs, rows)
    require(eng._merged_steps >= 1 and eng._gathered_steps == 0,
            f"homogeneous run: {eng._merged_steps} merged, "
            f"{eng._gathered_steps} gathered steps")
    pool_free(eng, "homogeneous")
    out["homogeneous"] = {"requests": len(reqs), "wall_s": wall,
                          "merged_steps": eng._merged_steps,
                          "decode_step_ms_by_lanes": steps,
                          "tie_gap_max": gap, "logits_diff_max": diff}

    # tenant isolation of the prefix cache, and an unknown adapter
    del eng, reqs, rows
    eng = make_engine()
    eng.start()
    shared = prompts[3][:4 * L.block_size + 1]
    try:
        iso = []
        for a in ("a0", "a1", "a0"):
            r = eng.submit(Request(shared, max_new_tokens=2, adapter_id=a))
            r.wait(timeout=600)
            iso.append(r)
        bad = eng.submit(Request(prompts[0], max_new_tokens=2,
                                 adapter_id="no-such-adapter"))
        good = eng.submit(Request(prompts[0], max_new_tokens=2,
                                  adapter_id="a2"))
        try:
            bad.wait(timeout=600)
            require(False, "the unknown adapter's request was served")
        except AdapterLoadError:
            pass
        good.wait(timeout=600)
    finally:
        eng.stop()
    require(iso[1].prefix_tokens == 0 and iso[2].prefix_tokens > 0,
            f"prefix isolation: {[r.prefix_tokens for r in iso]}")
    pool_free(eng, "isolation")
    out["isolation"] = {"prefix_tokens": [r.prefix_tokens for r in iso],
                        "unknown_adapter_failed_alone": True}

    # spec with a per-adapter draft: a0 speculates, a1 decodes plain
    del eng, iso, bad, good
    dcfg = T.config(L.draft)
    dparams = T.init_params(torch.Generator(device=device).manual_seed(1),
                            dcfg, device)
    eng = make_engine(SpecConfig(k=L.k), draft=(dparams, dcfg),
                      adapter_drafts={"a0": dparams})
    reqs, rows, _, _ = run(eng, [(prompts[2], "a0"), (prompts[3], "a1")],
                           verify=True)
    eng.stop()
    gap, diff = check("adapter draft", reqs, rows)
    require(reqs[0].spec_steps > 0 and reqs[1].spec_steps == 0,
            f"adapter drafts: spec steps {reqs[0].spec_steps}, "
            f"{reqs[1].spec_steps}")
    pool_free(eng, "adapter draft")
    out["adapter_draft"] = {
        "draft": L.draft, "spec_steps": [r.spec_steps for r in reqs],
        "accepted": reqs[0].accepted_tokens,
        "drafted": reqs[0].draft_tokens,
        "tie_gap_max": gap, "logits_diff_max": diff}
    del dparams, eng, reqs, rows

    # the checks' power: adapter indices rolled one lane on in the
    # gathered step; every request whose adapter that changed is flagged
    eng = make_engine()
    specs = [(p, a) for p, a in zip(prompts, (None, "a0", "a1", "a2") * 2)]
    reqs, rows, step_rec, _ = run(eng, specs, fault="adapters")
    eng.stop()
    diffs = {r.request_id: logits_diff(teacher_logits(
        merged[r.adapter_id], cfg, r.prompt, r.tokens, device),
        rows.of(r)) for r in reqs}
    moved = [r.request_id for r in reqs if step_rec.changed(r.request_id)]
    out["planted"] = {
        "fault": "adapter indices rolled", "lanes": len(reqs),
        "lanes_changed": len(moved),
        "logits_diff_per_lane": list(diffs.values()),
        "lanes_flagged_by_logits": sum(diffs[i] > ENGINE_LOGITS_MAX_ABS
                                       for i in moved),
        "logits_diff_min_changed_lane": min(diffs[i] for i in moved)
        if moved else None}
    require(moved and out["planted"]["lanes_flagged_by_logits"]
            == len(moved),
            f"the logits check missed the planted adapter fault: "
            f"{out['planted']}")
    out["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                          if on_card else None)
    emit("lora", **out)
    del eng, reqs, rows, step_rec, params, merged, bank
    _collect(on_card)
    return out


# ------------------------------------------------------------------ disagg --

class MigrationLog:
    """Times each migration of a prefill-role engine into a decode-role
    engine while entered, and keeps the bits of one: per migration the
    gather + device-to-host ms (`_migrate_out` less its export), the
    pack + send ms (the migrator's export: over the loopback that includes
    the inbox's reassembly), and the import ms (the decode loop's
    host-to-device copy and scatter, ended by a synchronise the log adds).
    The first migration of a prompt of at least `keep_len` tokens has its
    prefill-pool blocks cloned before the export and its decode-pool
    blocks cloned after the import."""

    def __init__(self, prefill, decode, keep_len: int):
        self.prefill, self.decode, self.keep_len = prefill, decode, keep_len
        self.out, self.imports, self.kept = [], [], {}

    def __enter__(self):
        import torch

        pre, dec = self.prefill, self.decode
        sync = torch.cuda.synchronize if dec.device.type == "cuda" \
            else (lambda: None)
        migrate_out, export = pre._migrate_out, pre._migrator.export
        scatter, stamp = dec._scatter_imported, dec._stamp_first_token
        current = {}

        def timed_migrate_out(slot_id, slot, first_tok):
            req = slot.request
            if slot.true_len >= self.keep_len and not self.kept:
                table = slot.table[:-(-slot.true_len // pre.ec.block_size)]
                self.kept[req.request_id] = {"prefill": (
                    pre._kp[:, table].clone(), pre._vp[:, table].clone())}
            current.clear()
            t0 = time.perf_counter()
            migrate_out(slot_id, slot, first_tok)
            total = (time.perf_counter() - t0) * 1e3
            if "export_ms" in current:
                self.out.append({
                    "request": req.request_id, "tokens": slot.true_len,
                    "mb": current["mb"],
                    "gather_d2h_ms": total - current["export_ms"],
                    "pack_send_ms": current["export_ms"]})

        def timed_export(request, **kw):
            t0 = time.perf_counter()
            export(request, **kw)
            current["export_ms"] = (time.perf_counter() - t0) * 1e3
            current["mb"] = 2 * kw["k"].numel() * kw["k"].element_size() \
                / 1e6

        def timed_scatter(table, start, k, v):
            t0 = time.perf_counter()
            scatter(table, start, k, v)
            sync()
            self.imports.append({
                "blocks": len(table) - start, "reused": start,
                "mb": 2 * k[:, start:].numel() * k.element_size() / 1e6,
                "import_ms": (time.perf_counter() - t0) * 1e3})

        def import_stamp(slot_id, slot, first_tok):
            # an import stamps its first token right after its scatter
            rid = slot.request.request_id
            if slot.request.migrations:
                self.imports[-1]["request"] = rid
                kept = self.kept.get(rid)
                if kept is not None and "decode" not in kept:
                    kept["decode"] = (dec._kp[:, slot.table].clone(),
                                      dec._vp[:, slot.table].clone())
            return stamp(slot_id, slot, first_tok)

        pre._migrate_out, pre._migrator.export = timed_migrate_out, \
            timed_export
        dec._scatter_imported, dec._stamp_first_token = timed_scatter, \
            import_stamp
        return self

    def __exit__(self, *exc):
        del self.prefill._migrate_out, self.decode._scatter_imported
        del self.decode._stamp_first_token, self.prefill._migrator.export

    def bit_equal_blocks(self) -> int:
        """How many blocks the kept request migrated, when its decode-pool
        blocks equal its prefill-pool blocks bit for bit (K and V); else
        0."""
        import torch

        for kept in self.kept.values():
            if "decode" in kept and all(
                    torch.equal(a, b) for a, b in zip(kept["prefill"],
                                                      kept["decode"])):
                return kept["decode"][0].shape[1]
        return 0

    def summary(self) -> dict:
        """Per migration its three stages, MB and GB/s over the three;
        per stage the totals and rate; and the largest migration's row."""
        imports = {r["request"]: r for r in self.imports}
        rows = []
        for r in self.out:
            imp = imports[r["request"]]
            ms = r["gather_d2h_ms"] + r["pack_send_ms"] + imp["import_ms"]
            rows.append(dict(r, import_ms=imp["import_ms"],
                             import_mb=imp["mb"], reused=imp["reused"],
                             gb_per_s=r["mb"] / ms))
        out = {"migrations": len(self.out), "imports": len(self.imports),
               "rows": rows}
        for stage, src in (("gather_d2h", self.out),
                           ("pack_send", self.out),
                           ("import", self.imports)):
            ms = sum(r[f"{stage}_ms"] for r in src)
            mb = sum(r["mb"] for r in src)
            out[stage] = {"ms_total": ms, "mb_total": mb,
                          "gb_per_s": mb / ms if ms else None}
        if rows:
            out["largest"] = max(rows, key=lambda r: r["mb"])
        return out


def planted_import_shift(params, cfg, load, rng, device) -> dict:
    """The logits check's power on the migration path: `load.slots`
    requests through a disaggregated pair whose decode role lands each
    request's imported planes one block on (block j's planes in table
    entry j + 1: the first entry keeps what the pool held there, the last
    block's planes are dropped), its prefix cache off so that every block
    is imported.  Attention over the prompt is blind to which block holds
    which (already rotated) positions, so what the shift changes is the
    first and the last block: the prompts, drawn from `rng`, are two
    blocks less three tokens each, so that it changes half of each one.
    Every import moves; returns how many of those lanes the logits check
    flags."""
    from cloudtik_tpu_torch.serve.disagg import DisaggServing
    from cloudtik_tpu_torch.serve.engine import EngineConfig, Request

    ec = dict(max_len=load.max_len, block_size=load.block_size)
    pair = DisaggServing(params, cfg, EngineConfig(slots=2, **ec),
                         EngineConfig(slots=load.slots, prefix_cache=False,
                                      **ec), device=device)
    scatter = pair.decode._scatter_imported
    stamp = pair.decode._stamp_first_token
    moved, changed = [], set()

    def shifted(table, start, k, v):
        moved.append(len(table) > start)
        scatter(table[start + 1:], 0, k[:, start:-1], v[:, start:-1])

    def tagged_stamp(slot_id, slot, first_tok):
        # an import stamps its first token right after its scatter
        if slot.request.migrations and moved.pop():
            changed.add(slot.request.request_id)
        return stamp(slot_id, slot, first_tok)

    pair.decode._scatter_imported = shifted
    pair.decode._stamp_first_token = tagged_stamp
    reqs = [Request(rng.integers(0, cfg.vocab_size,
                                 2 * load.block_size - 3).tolist(),
                    max_new_tokens=load.short_new)
            for _ in range(load.slots)]
    with StepLogits(pair.decode) as rec:
        pair.start()
        try:
            for r in reqs:
                pair.submit(r)
            outs = [r.wait(timeout=600) for r in reqs]
        finally:
            pair.stop()
    diffs = {r.request_id: logits_diff(teacher_logits(
        params, cfg, r.prompt, toks, device), rec.rows(r.request_id))
        for r, toks in zip(reqs, outs)}
    return {"fault": "imported planes one block on",
            "lanes": len(reqs), "lanes_changed": len(changed),
            "logits_diff_per_lane": list(diffs.values()),
            "lanes_flagged_by_logits": sum(diffs[i] > ENGINE_LOGITS_MAX_ABS
                                           for i in changed),
            "logits_diff_min_changed_lane": min(
                (diffs[i] for i in changed), default=None)}


def phase_disagg(model: str = "tpu_1b", device: str = "cuda",
                 load: EngineLoad = ENGINE_LOAD, prefill_slots: int = 2,
                 nvidia_smi: str = None) -> dict:
    """`tik-serve --engine --disagg`: `engine_backend(model, disagg=True,
    prefill_slots=2)` at the engine phase's configuration behind
    ServeServer, the engine phase's traffic (16 clients, a shared cached
    prefix, one EOS).  Every answer passes the tie-aware check and every
    decode-role step the logits check; every record carries one migration
    of its whole prompt; both roles hit their prefix caches; one migrated
    request's blocks arrive bit for bit; both pools end free.  Then two
    requests torn by a planted `serve.kvcache.migrate` fault must answer
    right through the fallback, and a pair whose import lands its blocks
    one position on must be flagged in every lane it changes.  The same
    requests through a monolithic `--engine` backend, for the numbers."""
    import torch

    from cloudtik_tpu_torch import telemetry
    from cloudtik_tpu_torch.faults import seams
    from cloudtik_tpu_torch.faults.plan import FaultPlan, FaultPoint
    from cloudtik_tpu_torch.serve.engine import Request
    from cloudtik_tpu_torch.serve.server import ServeServer, engine_backend
    from cloudtik_tpu_torch.telemetry import instruments as ti

    on_card = device == "cuda"
    L = load
    telemetry.enable()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    backend = engine_backend(model, slots=L.slots, max_len=L.max_len,
                             block_size=L.block_size, disagg=True,
                             prefill_slots=prefill_slots, device=device)
    pair, cfg, params = backend.engine, backend.cfg, backend.params
    V = cfg.vocab_size
    traffic = engine_traffic(params, cfg, L, device, direct_new=5)
    rng, prefix, prompts, news, eos_i, eos = (
        traffic[k] for k in ("rng", "prefix", "prompts", "news", "eos_i",
                             "eos"))
    payloads = [{"tokens": [p], "max_new_tokens": n}
                for p, n in zip(prompts, news)]
    payloads[eos_i]["eos_id"] = eos
    warm = {"tokens": [prefix + prompts[1][:8]], "max_new_tokens": 2}
    out = {"model": model, "dtype": str(cfg.dtype).replace("torch.", ""),
           "nvidia_smi": nvidia_smi, "decode_slots": L.slots,
           "prefill_slots": prefill_slots, "max_len": L.max_len,
           "block_size": L.block_size,
           "pool_blocks": {"prefill": pair.prefill.pool.num_blocks,
                           "decode": pair.decode.pool.num_blocks}}

    server = ServeServer([backend], host="127.0.0.1", port=0)
    server.start()
    url = f"http://127.0.0.1:{server.port}/v1/generate"
    try:
        status, _ = _http(url, warm)
        require(status == 200, f"disagg warm-up status {status}")
        failures0 = ti.SERVE_KV_MIGRATION_FAILURES.value()
        with StepLogits(pair.decode) as rec, \
                MigrationLog(pair.prefill, pair.decode,
                             max(map(len, prompts))) as mig:
            wall, reqs, recs = _serve_wave(pair, url, payloads)
            # two requests torn by a planted fault: at the second block
            # of the first, then at the first block of the second
            torn = [Request(rng.integers(0, V, 8 * L.block_size).tolist(),
                            max_new_tokens=L.short_new) for _ in range(2)]
            plan = FaultPlan([FaultPoint("serve.kvcache.migrate", "raise",
                                         at_call=2, times=2)])
            with seams.armed(plan):
                for r in torn:
                    pair.submit(r)
                for r in torn:
                    r.wait(timeout=600)
        gaps, diffs = [], []
        for i, req in enumerate(reqs):
            got = req.tokens
            if i == eos_i:
                require(got[-1] == eos and eos not in got[:-1],
                        f"request {i} did not stop at its EOS: {got}")
            else:
                require(len(got) == news[i],
                        f"request {i}: {len(got)} tokens, asked {news[i]}")
            require(all(0 <= t < V for t in got), f"request {i}: ids")
            gap, diff = check_answer(f"disagg request {i}", params, cfg,
                                     req.prompt, got, rec, req.request_id,
                                     device)
            gaps.append(gap)
            diffs.append(diff)
            require(recs[i]["migrations"] == 1
                    and recs[i]["migrated_tokens"] == len(req.prompt),
                    f"request {i}: migrations {recs[i]['migrations']}, "
                    f"migrated_tokens {recs[i]['migrated_tokens']} of "
                    f"{len(req.prompt)}")
        require(plan.points[0].fired == 2,
                f"the planted tear fired {plan.points[0].fired} times")
        torn_checks = [check_answer(f"torn request {j}", params, cfg,
                                    r.prompt, r.tokens, rec, r.request_id,
                                    device) for j, r in enumerate(torn)]
        require(all(r.error is None and r.migrations == 0
                    and len(r.tokens) == L.short_new for r in torn),
                "a torn request did not finish through the fallback")
        failures = ti.SERVE_KV_MIGRATION_FAILURES.value() - failures0
        require(failures == 2, f"migration failures counted: {failures}")
        prefill_hits = sum(r["prefix_tokens"] > 0 for r in recs)
        decode_hits = sum(r["reused"] > 0 for r in mig.imports)
        require(prefill_hits >= 1 and decode_hits >= 1,
                f"prefix hits: prefill role {prefill_hits}, decode role "
                f"{decode_hits}")
        bit_equal = mig.bit_equal_blocks()
        require(bit_equal > 0,
                "a migrated request's decode-pool blocks differ from its "
                "prefill-pool blocks")
        out["wave"] = dict(
            _wave_numbers(wall, reqs, recs), clients=L.clients,
            tie_gap_max=max(gaps), tie_gap_limit=ENGINE_TIE_GAP,
            logits_diff_max=max(diffs),
            logits_diff_limit=ENGINE_LOGITS_MAX_ABS,
            migrated_tokens=[r["migrated_tokens"] for r in recs],
            prefix_hits={"prefill": prefill_hits, "decode": decode_hits},
            bit_equal_blocks=bit_equal)
        out["migration"] = mig.summary()
        out["torn"] = {"requests": len(torn), "fired": 2,
                       "failures_counted": failures,
                       "tie_gap_max": max(g for g, _ in torn_checks),
                       "logits_diff_max": max(d for _, d in torn_checks)}
    finally:
        server.stop()
        pair.stop()
    require(pair.prefill.pool.used() == 0 and pair.decode.pool.used() == 0,
            f"pools after stop: prefill {pair.prefill.pool.used()}, "
            f"decode {pair.decode.pool.used()} used")
    out["planted"] = planted_import_shift(params, cfg, L, rng, device)
    p = out["planted"]
    require(p["lanes_changed"] == p["lanes"]
            and p["lanes_flagged_by_logits"] == p["lanes_changed"],
            f"the logits check missed the planted import shift: {p}")

    # the same requests through a monolithic `--engine` backend
    mono = engine_backend(model, slots=L.slots, max_len=L.max_len,
                          block_size=L.block_size, device=device)
    server = ServeServer([mono], host="127.0.0.1", port=0)
    server.start()
    url = f"http://127.0.0.1:{server.port}/v1/generate"
    try:
        status, _ = _http(url, warm)
        require(status == 200, f"monolith warm-up status {status}")
        wall, reqs, recs = _serve_wave(mono.engine, url, payloads)
        gaps = [check_tie_aware(f"monolith request {i}", tie_gaps(
            params, cfg, r.prompt, r.tokens, device))
            for i, r in enumerate(reqs)]
        out["monolith"] = dict(_wave_numbers(wall, reqs, recs),
                               tie_gap_max=max(gaps))
    finally:
        server.stop()
        mono.engine.stop()
    out["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                          if on_card else None)
    out["seconds"] = time.perf_counter() - t_phase
    emit("disagg", **out)
    del backend, pair, params, mono
    _collect(on_card)
    return out


# ------------------------------------------------------------------ fabric --

@dataclasses.dataclass(frozen=True)
class FabricLoad:
    """The fabric phase's configuration and traffic: one prefill replica
    (`prefill_slots` lanes) and two decode replicas (`decode_slots` lanes
    each), blocks of `block_size`; prompts of `heavy_lens` tokens (at or
    over `threshold`: the fabric hop) and `short_lens` (direct), taken in
    turn, `new_tokens` each; `kill_requests` heavy requests in flight
    when the prefill replica is killed."""
    max_len: int = 1024
    block_size: int = 16
    prefill_slots: int = 2
    decode_slots: int = 4
    threshold: int = 64
    heavy_lens: tuple = (384, 700)
    short_lens: tuple = (16, 48)
    clients: int = 8
    new_tokens: int = 24
    kill_requests: int = 4


FABRIC_LOAD = FabricLoad()
# the CPU rehearsal at `tiny`: the same traffic at a quarter of the lengths
FABRIC_REHEARSAL = FabricLoad(max_len=256, block_size=8, threshold=16,
                              heavy_lens=(96, 175), short_lens=(4, 12),
                              new_tokens=8)


class HandoffLog:
    """Times each socket export of a `FabricMigrator` while entered: per
    handoff the ms from opening the transport to the commit frame sent,
    and the planes' MB."""

    def __init__(self, migrator):
        self.migrator, self.rows = migrator, []

    def __enter__(self):
        send = self.migrator._send

        def timed_send(request, handoff, kw):
            t0 = time.perf_counter()
            send(request, handoff, kw)
            self.rows.append({
                "tokens": kw["length"],
                "mb": 2 * kw["k"].numel() * kw["k"].element_size() / 1e6,
                "handoff_ms": (time.perf_counter() - t0) * 1e3})

        self.migrator._send = timed_send
        return self

    def __exit__(self, *exc):
        del self.migrator._send

    def summary(self) -> dict:
        ms = sum(r["handoff_ms"] for r in self.rows)
        mb = sum(r["mb"] for r in self.rows)
        return {"handoffs": len(self.rows), "rows": self.rows,
                "handoff_ms": _percentiles([r["handoff_ms"]
                                            for r in self.rows]),
                "wire_gb_per_s": mb / ms if ms else None}


def phase_fabric(model: str = "tpu_1b", device: str = "cuda",
                 load: FabricLoad = FABRIC_LOAD,
                 nvidia_smi: str = None) -> dict:
    """The serving fabric on the card: a `PrefillReplica` and two
    `DecodeReplica`s, each its own engine over one set of weights, behind
    the prefix-affinity `Router` with a `ReplicaRegistry` over
    `InMemoryStateBackend`; KV blocks cross `SocketKVTransport` on
    127.0.0.1.  Prompt-heavy requests must take the fabric hop and short
    ones go direct; a torn migration falls back on the decode replica the
    router chose; a prefill replica killed mid-traffic leaves every greedy
    request answered.  Every answer passes the tie-aware check (outcomes,
    never timings)."""
    import numpy as np
    import torch

    from cloudtik_tpu_torch import telemetry
    from cloudtik_tpu_torch.control.state import (
        InMemoryStateBackend, StateClient)
    from cloudtik_tpu_torch.faults import seams
    from cloudtik_tpu_torch.faults.plan import FaultPlan, FaultPoint
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.serve import fabric
    from cloudtik_tpu_torch.serve.engine import (
        DecodeEngine, EngineConfig, Request)
    from cloudtik_tpu_torch.serve.replicas import ReplicaRegistry
    from cloudtik_tpu_torch.serve.router import (
        Router, RouterConfig, chain_hash)
    from cloudtik_tpu_torch.telemetry import instruments as ti

    on_card = device == "cuda"
    L = load
    telemetry.enable()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    cfg = T.config(model)
    params = T.init_params(torch.Generator(device=device).manual_seed(0),
                           cfg, device)
    ec = dict(max_len=L.max_len, block_size=L.block_size)
    prefill = fabric.PrefillReplica("p0", DecodeEngine(
        params, cfg, EngineConfig(slots=L.prefill_slots, **ec),
        migrator=fabric.FabricMigrator(), device=device))
    decodes = [fabric.DecodeReplica(f"d{i}", DecodeEngine(
        params, cfg, EngineConfig(slots=L.decode_slots, **ec),
        role="decode", device=device)) for i in range(2)]
    replicas = [prefill] + decodes
    for r in replicas:
        r.engine.start()
    router = Router(ReplicaRegistry(StateClient(InMemoryStateBackend())),
                    RouterConfig(block_size=L.block_size,
                                 prefill_len_threshold=L.threshold,
                                 request_deadline_s=600))
    router.add_client(prefill, role="prefill", slots=L.prefill_slots)
    for r in decodes:
        router.add_client(r, role="decode", slots=L.decode_slots)
    rng = np.random.default_rng(1)
    V = cfg.vocab_size

    def prompt(n):
        return rng.integers(0, V, n).tolist()

    def paths():
        return {p: ti.SERVE_FABRIC_REQUESTS.value(path=p)
                for p in ("migrated", "fallback", "direct")}

    def answered(name, answers):
        """The largest tie gap over (prompt, tokens, error) answers, each
        complete and right."""
        gaps = []
        for j, (p, toks, error) in enumerate(answers):
            require(error is None and len(toks) == L.new_tokens,
                    f"{name} {j}: error {error!r}, {len(toks)} tokens of "
                    f"{L.new_tokens}")
            gaps.append(check_tie_aware(f"{name} {j}", tie_gaps(
                params, cfg, p, toks, device)))
        return max(gaps)

    def done(reqs):
        return [(r.prompt, r.tokens, r.error) for r in reqs]

    out = {"model": model, "dtype": str(cfg.dtype).replace("torch.", ""),
           "nvidia_smi": nvidia_smi, **dataclasses.asdict(L)}
    try:
        for n in (L.heavy_lens[0], L.short_lens[0]):
            router.handle({"tokens": prompt(n), "max_new_tokens": 2})
        # the wave: heavy and short requests in turn, all at once
        lens = [(L.heavy_lens, L.short_lens)[i % 2][i // 2 % 2]
                for i in range(L.clients)]
        reqs = [Request(prompt(n), max_new_tokens=L.new_tokens)
                for n in lens]
        before = paths()
        with HandoffLog(prefill.engine._migrator) as handoffs:
            t0 = time.perf_counter()
            for r in reqs:
                router.submit(r)
            for r in reqs:
                r.wait(timeout=600)
            wall = time.perf_counter() - t0
        after = paths()
        n_heavy = sum(n >= L.threshold for n in lens)
        require(after == dict(before, migrated=before["migrated"]
                              + n_heavy),
                f"fabric paths moved {before} -> {after}, expected "
                f"{n_heavy} migrated and nothing else")
        out["wave"] = {"requests": len(reqs), "heavy": n_heavy,
                       "wall_s": wall,
                       "tokens_per_s": sum(len(r.tokens) for r in reqs)
                       / wall,
                       "tie_gap_max": answered("fabric request",
                                               done(reqs)),
                       **handoffs.summary()}

        # a torn migration: the fallback re-prefills on the decode
        # replica the router chose
        torn = prompt(L.heavy_lens[0])
        chosen = router._pick(chain_hash(torn, L.block_size), set())[0]
        fell_back = []
        for r in decodes:
            take = r.take_fallback
            r.take_fallback = (lambda ticket, req, r=r, take=take: (
                fell_back.append(r.replica_id), take(ticket, req))[1])
        failures0 = ti.SERVE_KV_MIGRATION_FAILURES.value()
        before = paths()
        plan = FaultPlan([FaultPoint("serve.kvcache.migrate", "raise",
                                     at_call=2, times=1)])
        try:
            with seams.armed(plan):
                res = router.handle({"tokens": torn,
                                     "max_new_tokens": L.new_tokens})
        finally:
            for r in decodes:
                del r.take_fallback
        require(res.get("fabric_path") == "fallback"
                and fell_back == [chosen.replica_id]
                and paths()["fallback"] == before["fallback"] + 1
                and ti.SERVE_KV_MIGRATION_FAILURES.value()
                == failures0 + 1,
                f"torn migration: path {res.get('fabric_path')}, fell "
                f"back on {fell_back} (router chose {chosen.replica_id})")
        out["torn"] = {"fell_back_on": fell_back,
                       "tie_gap": answered("torn request", [
                           (torn, res["tokens"][0], None)])}

        # the prefill replica killed with heavy requests in flight
        killed = [Request(prompt(L.heavy_lens[i % 2]),
                          max_new_tokens=L.new_tokens)
                  for i in range(L.kill_requests)]
        before = paths()
        for r in killed:
            router.submit(r)
        deadline = time.monotonic() + 60
        while not any(r._done.is_set() for r in killed) and not any(
                s is not None for s in prefill.engine._slots):
            require(time.monotonic() < deadline, "no request started")
            time.sleep(0.001)
        prefill.kill()
        for r in killed:
            r.wait(timeout=600)
        out["prefill_killed"] = {
            "requests": len(killed),
            "paths": {k: paths()[k] - v for k, v in before.items()},
            "tie_gap_max": answered("request past the prefill kill",
                                    done(killed))}
    finally:
        router.stop()
        for r in replicas:
            r.stop()
    for r in replicas:
        require(r.engine.pool.used() == 0,
                f"{r.replica_id}: {r.engine.pool.used()} blocks held "
                "after stop")
    out["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                          if on_card else None)
    out["seconds"] = time.perf_counter() - t_phase
    emit("fabric", **out)
    del replicas, prefill, decodes, params, router
    _collect(on_card)
    return out


# ----------------------------------------------------------------- forward --

# bf16 rounding of the whole model: on a reduced-width CPU proxy both
# attention paths sat as far from an f32 model as from each other
# (max |diff| 0.06 at 8 layers, |logits| <= 4.7, relative L2 1.1%).
LOGITS_MAX_ABS = 0.5
LOGITS_REL_L2 = 0.05


def forward_main(model: str = "tpu_1b", B: int = 4, S: int = 2048,
                 device: str = "cuda"):
    import torch

    from cloudtik_tpu_torch.models import transformer as T

    cfg = T.config(model)
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_params(gen, cfg, device)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=device)
    with torch.no_grad():
        logits = T.forward(params, tokens, cfg)
    logits.cpu()   # waits for the device
    return cfg, params, tokens, logits


def phase_forward(cfg, params, tokens, logits, launches: int) -> dict:
    import torch

    from cloudtik_tpu_torch.models import transformer as T

    B, S = tokens.shape
    require(tuple(logits.shape) == (B, S, cfg.vocab_size),
            f"logits shape {tuple(logits.shape)}")
    require(logits.dtype == torch.float32, f"logits dtype {logits.dtype}")
    require(bool(torch.isfinite(logits).all()), "non-finite logits")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            T.forward(params, tokens, cfg)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        ref_cfg = dataclasses.replace(cfg, attention_impl="reference")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = T.forward(params, tokens, ref_cfg)
        torch.cuda.synchronize()
        ref_ms = (time.perf_counter() - t0) * 1e3
    diff = (logits - ref).abs().max().item()
    rel = ((logits - ref).norm() / ref.norm()).item()
    out = {"model": "tpu_1b", "batch": B, "seq": S, "dtype": "bfloat16",
           "flash_launches": launches, "ms_per_forward": ms,
           "reference_attention_ms": ref_ms,
           "tokens_per_s": B * S / (min(ms) / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "logits_max_abs": ref.abs().max().item(),
           "logits_max_abs_diff_vs_reference": diff,
           "logits_rel_l2_vs_reference": rel,
           "tolerance": {"max_abs": LOGITS_MAX_ABS, "rel_l2": LOGITS_REL_L2}}
    emit("forward", **out)
    require(diff <= LOGITS_MAX_ABS and rel <= LOGITS_REL_L2,
            f"forward logits differ from the reference path: max {diff}, "
            f"rel {rel}")
    return out


# ------------------------------------------------------------------- train --

def _launch_counts() -> dict:
    from cloudtik_tpu_torch.ops import flash_attention as FA

    return {"flash_fwd": FA.LAUNCHES, "flash_bwd_dq": FA.LAUNCHES_DQ,
            "flash_bwd_dkv": FA.LAUNCHES_DKV}


def _zero_launch_counts() -> None:
    from cloudtik_tpu_torch.ops import flash_attention as FA

    FA.LAUNCHES = FA.LAUNCHES_DQ = FA.LAUNCHES_DKV = 0


def _train_measured(trainer, data, warmup: int, steps: int,
                    on_card: bool) -> dict:
    """`warmup` steps, then `steps` measured steps in one log window with
    the launch counts zeroed just before and read just after, both off
    the iterator `data`.  "losses" are the warm-up windows' losses and
    the measured window's last; "last" is that window's history entry."""
    import torch

    t0 = time.perf_counter()
    warm = trainer.fit(data, warmup)["history"]
    warmup_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    trainer.config.log_every = steps
    _zero_launch_counts()
    t0 = time.perf_counter()
    entry = trainer.fit(data, steps)["history"][-1]   # ends in float()
    wall_s = time.perf_counter() - t0
    launches = _launch_counts()
    return {
        "warmup_steps": warmup, "measured_steps": steps,
        "warmup_s": warmup_s, "ms_per_step": wall_s / steps * 1e3,
        "tokens_per_s": entry["tokens_per_sec"], "mfu": entry.get("mfu"),
        "losses": [h["loss"] for h in warm] + [entry["loss"]],
        "last": entry, "launches": launches,
        "launches_per_step": {k: n / steps for k, n in launches.items()},
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if on_card else None)}


def phase_train(model: str = "tpu_1b", B: int = 8, S: int = 2048,
                device: str = "cuda", warmup: int = 2,
                steps: int = 5) -> dict:
    """bench.py's training configuration on the port: `warmup` steps, then
    the counts zeroed, `steps` measured steps, the counts read."""
    import torch

    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.train.data import synthetic_lm_batches
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import (
        Trainer, TrainerConfig, transformer_spec)

    cfg = T.config(model, max_seq_len=S, param_dtype=torch.bfloat16)
    trainer = Trainer(transformer_spec(cfg), TrainerConfig(
        global_batch_size=B, seq_len=S,
        optimizer=OptimizerConfig(moment_dtype="bfloat16"),
        log_every=steps), device=device)
    trainer.init_state(torch.Generator(device=device).manual_seed(0))
    # ---- the training path: counts zeroed just before, read just after --
    train = _train_measured(trainer, synthetic_lm_batches(
        B, S, cfg.vocab_size), warmup, steps, device == "cuda")
    entry = train.pop("last")
    result = {
        "model": model, "batch": B, "seq": S, "param_dtype": "bfloat16",
        "moment_dtype": "bfloat16", "remat_policy": cfg.remat_policy,
        **train, "flops_per_token": cfg.flops_per_token(),
        "loss": entry["loss"], "grad_norm": entry["grad_norm"],
    }
    emit("train", **result)
    require(math.isfinite(entry["loss"]), f"train loss {entry['loss']}")
    return result


# Gradients of the flash path against the reference attention path, tpu_1b
# width with 2 layers, bf16 compute on f32 params: the two paths round p
# and o to bf16 at different places, which moves each gradient leaf by
# about 1e-2 relative L2; 5e-2 holds that with room and fails on any wrong
# kernel term.
GRADS_REL_L2 = 5e-2


def phase_train_grads(model: str = "tpu_1b", n_layers: int = 2, B: int = 2,
                      S: int = 2048, device: str = "cuda",
                      loss_steps: int = 10) -> dict:
    import dataclasses

    import torch

    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.train.data import synthetic_lm_batches
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import (
        Trainer, TrainerConfig, transformer_spec)
    from cloudtik_tpu_torch.tree import tree_leaves

    cfg = T.config(model, n_layers=n_layers, max_seq_len=S)
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_params(gen, cfg, device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = next(synthetic_lm_batches(B, S, cfg.vocab_size, seed=1))
    batch = {k: torch.as_tensor(v).to(device, torch.long)
             for k, v in batch.items()}
    names = [f"{top}.{k}" if isinstance(v, dict) else top
             for top, v in params.items()
             for k in (v if isinstance(v, dict) else [None])]
    grads = {}
    for impl in ("flash", "reference"):
        icfg = dataclasses.replace(cfg, attention_impl=impl)
        loss, _ = T.loss_fn(params, batch, icfg)
        grads[impl] = (loss.item(), torch.autograd.grad(
            loss, tree_leaves(params)))
    rel = {n: ((a.float() - b.float()).norm() / b.float().norm()).item()
           for n, a, b in zip(names, grads["flash"][1],
                              grads["reference"][1])}
    finite = all(_all_finite(g) for g in grads["flash"][1])
    del grads["flash"], grads["reference"]

    trainer = Trainer(transformer_spec(cfg), TrainerConfig(
        global_batch_size=B, seq_len=S, log_every=1,
        optimizer=OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                                  schedule="constant")), device=device)
    trainer.init_state(params=params)
    host_batch = next(synthetic_lm_batches(B, S, cfg.vocab_size, seed=1))
    history = trainer.fit(iter([host_batch] * loss_steps),
                          loss_steps)["history"]
    losses = [h["loss"] for h in history]
    out = {"model": model, "n_layers": n_layers, "batch": B, "seq": S,
           "grad_rel_l2_flash_vs_reference": rel,
           "tolerance_rel_l2": GRADS_REL_L2, "grads_finite": finite,
           "repeated_batch_losses": losses}
    emit("train_grads", **out)
    require(finite, "non-finite gradients on the flash path")
    worst = max(rel.values())
    require(worst <= GRADS_REL_L2,
            f"flash-path gradients differ from the reference path's: {rel}")
    require(all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0] - 0.1,
            f"loss did not fall on a repeated batch: {losses}")
    return out


# ----------------------------------------------------------- lora_train --

@dataclasses.dataclass(frozen=True)
class LoraTrainLoad:
    """The lora_train phase: `recipes.llama_lora_finetune.build` at the
    recipe's defaults (tpu_1b, rank 16, B=8, S=2048, f32 base) plus
    `argv`, AdamW at `lr` with no warmup (the default warmup of 100 steps
    gives a learning rate of ~0 to a run of a few steps), `warmup` steps
    then `steps` measured ones on one repeated batch; then the adapter,
    saved by the port's Checkpointer, served through
    `engine_backend(adapters_dir=...)` beside the base: one request on
    the adapter and one on the base for each of `serve_prompts`."""
    argv: tuple = ()
    lr: float = 3e-3
    warmup: int = 2
    steps: int = 6
    serve_prompts: tuple = (32, 96, 160, 224)
    serve_new: int = 24
    slots: int = 4
    max_len: int = 512
    block_size: int = 16


LORA_TRAIN_LOAD = LoraTrainLoad()
# the CPU rehearsal at `tiny`
LORA_TRAIN_REHEARSAL = LoraTrainLoad(
    argv=("--model", "tiny", "--seq-len", "64", "--batch", "4"), lr=1e-2,
    serve_prompts=(8, 16, 24, 32), serve_new=6, max_len=128, block_size=8)
# The trained adapter must move the teacher's logits (merged weights
# against the base's, over one prompt and the base's own answer) by twice
# the logits check's limit: then an answer the server decoded on the base
# weights, or on a fresh adapter (b = 0: a delta of exactly 0), sits at
# least one limit from the trained teacher and fails the check.
LORA_TRAIN_MIN_EFFECT = 2 * ENGINE_LOGITS_MAX_ABS


def _check_losses(name: str, losses: list) -> None:
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f"{name}: the loss did not fall on a repeated batch: {losses}")


def phase_lora_train(load: LoraTrainLoad = LORA_TRAIN_LOAD,
                     device: str = "cuda", nvidia_smi: str = None) -> dict:
    """LoRA fine-tuning through the recipe's `build`, then the trained
    adapter saved and served.  Launch counts are zeroed just before the
    measured steps and read just after."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from cloudtik_tpu_torch.models import generate as G
    from cloudtik_tpu_torch.models import lora as LO
    from cloudtik_tpu_torch.recipes import llama_lora_finetune as R
    from cloudtik_tpu_torch.serve.server import ServeServer, engine_backend
    from cloudtik_tpu_torch.train.checkpoint import (CheckpointConfig,
                                                     Checkpointer)
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.tree import tree_leaves, tree_map

    on_card = device == "cuda"
    L = load
    _collect(on_card)
    args = R.parser().parse_args(
        ["--device", device, "--log-every", "1", *L.argv])
    trainer, data, cfg, base, lora_cfg = R.build(args, OptimizerConfig(
        learning_rate=L.lr, warmup_steps=0, total_steps=1000))
    trainer.init_state(torch.Generator(device=device).manual_seed(1))
    base_before = tree_map(torch.clone, base)
    start = tree_map(lambda p: p.detach().clone(), trainer.params)
    train = _train_measured(trainer, itertools.repeat(next(data)), L.warmup,
                            L.steps, on_card)
    base_unchanged = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(base), tree_leaves(base_before)))
    adapters_changed = all(not torch.equal(a.detach(), b) for a, b in zip(
        tree_leaves(trainer.params), tree_leaves(start)))
    del base_before, start
    entry = train.pop("last")
    out = {"model": args.model, "nvidia_smi": nvidia_smi,
           "n_layers": cfg.n_layers, "rank": lora_cfg.rank,
           "alpha": lora_cfg.alpha, "targets": list(lora_cfg.targets),
           "batch": args.batch, "seq": args.seq_len,
           "base_dtype": str(cfg.param_dtype).replace("torch.", ""),
           "optimizer": {"name": "adamw", "lr": L.lr, "warmup_steps": 0},
           "adapter_params": sum(p.numel()
                                 for p in tree_leaves(trainer.params)),
           "flops_per_token": trainer.spec.flops_per_token, **train,
           "grad_norm": entry["grad_norm"],
           "base_unchanged": base_unchanged,
           "adapters_changed": adapters_changed}
    require(base_unchanged, "lora_train: a base leaf changed")
    require(adapters_changed, "lora_train: an adapter leaf did not move")
    _check_losses("lora_train", out["losses"])

    # the trained adapter: saved, then served beside the base
    adapter = tree_map(lambda p: p.detach(), trainer.params)
    merged = dict(base, layers=LO.merge_lora(base["layers"], adapter,
                                             lora_cfg))
    rng = np.random.default_rng(3)
    V = cfg.vocab_size
    prompts = [rng.integers(0, V, n).tolist() for n in L.serve_prompts * 2]
    with torch.no_grad():
        base_answer = G.generate(base, torch.tensor([prompts[0]],
                                                    device=device), cfg,
                                 max_new_tokens=L.serve_new)[0].tolist()
    effect = float((teacher_logits(merged, cfg, prompts[0], base_answer,
                                   device)
                    - teacher_logits(base, cfg, prompts[0], base_answer,
                                     device)).abs().max())
    out["adapter_effect"] = effect
    out["adapter_effect_limit"] = LORA_TRAIN_MIN_EFFECT
    require(effect >= LORA_TRAIN_MIN_EFFECT,
            f"lora_train: the trained adapter moves the teacher's logits by "
            f"only {effect} (limit {LORA_TRAIN_MIN_EFFECT})")
    root = tempfile.mkdtemp(prefix="tik-lora-train-")
    backend = server = None
    try:
        adapters_dir = os.path.join(root, "adapters")
        ckpt = Checkpointer(CheckpointConfig(
            directory=os.path.join(adapters_dir, "trained")))
        ckpt.save(trainer.step, {"params": trainer.params}, force=True)
        ckpt.close()
        del trainer
        _collect(on_card)
        backend = engine_backend(
            args.model, slots=L.slots, max_len=L.max_len,
            block_size=L.block_size, adapters_dir=adapters_dir,
            lora_rank=lora_cfg.rank, lora_alpha=lora_cfg.alpha,
            params=base, device=device, max_seq_len=args.seq_len)
        engine = backend.engine
        server = ServeServer([backend], host="127.0.0.1", port=0)
        server.start()
        url = f"http://127.0.0.1:{server.port}/v1/generate"
        payloads = [dict({"tokens": [p], "max_new_tokens": L.serve_new},
                         **({"adapter": "trained"} if i % 2 == 0 else {}))
                    for i, p in enumerate(prompts)]
        with StepLogits(engine) as rec:
            wall, reqs, _ = _serve_wave(engine, url, payloads)
    finally:
        if server is not None:
            server.stop()
        if backend is not None:
            backend.engine.stop()
        shutil.rmtree(root, ignore_errors=True)
    gaps, diffs = zip(*[check_rows(
        f"lora_train request {i}", merged if r.adapter_id else base, cfg, r,
        rec.rows(r.request_id), device) for i, r in enumerate(reqs)])
    require(engine.pool.used() == 0 and not engine._adapters._ref,
            "lora_train: KV or adapter pool not free after stop")
    n = sum(len(r.tokens) for r in reqs)
    out["serve"] = {"requests": len(reqs),
                    "on_adapter": sum(bool(r.adapter_id) for r in reqs),
                    "wall_s": wall, "tokens_per_s": n / wall,
                    "tie_gap_max": max(gaps), "logits_diff_max": max(diffs)}
    emit("lora_train", **out)
    del backend, engine, merged, base, reqs, rec
    _collect(on_card)
    return out


# ------------------------------------------------------------------- bert --

@dataclasses.dataclass(frozen=True)
class BertLoad:
    """The bert phase: `recipes.bert_large_pretrain.build`
    (bert_large, S=512, f32 params with bf16 compute) plus `argv` (B=32,
    16,384 tokens a step as the train phase's), AdamW at `lr` with no
    warmup, `warmup` then `steps` measured steps on one repeated batch."""
    argv: tuple = ("--batch", "32")
    lr: float = 1e-4
    warmup: int = 2
    steps: int = 5


BERT_LOAD = BertLoad()
BERT_REHEARSAL = BertLoad(argv=("--model", "tiny", "--seq-len", "64",
                                "--batch", "4"), lr=1e-3)


def phase_bert(load: BertLoad = BERT_LOAD, device: str = "cuda",
               nvidia_smi: str = None) -> dict:
    """BERT MLM pretraining through the recipe's `build`.  Launch counts
    are zeroed just before the measured steps and read just after."""
    import torch

    from cloudtik_tpu_torch.recipes import bert_large_pretrain as R
    from cloudtik_tpu_torch.train.optim import OptimizerConfig

    on_card = device == "cuda"
    _collect(on_card)
    args = R.parser().parse_args(
        ["--device", device, "--log-every", "1", *load.argv])
    trainer, data, cfg = R.build(args, OptimizerConfig(
        learning_rate=load.lr, warmup_steps=0, total_steps=1000))
    trainer.init_state(torch.Generator(device=device).manual_seed(0))
    batch = next(data)
    train = _train_measured(trainer, itertools.repeat(batch), load.warmup,
                            load.steps, on_card)
    entry = train.pop("last")
    out = {"model": args.model, "nvidia_smi": nvidia_smi,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": cfg.n_heads, "head_dim": cfg.head_dim,
           "batch": args.batch, "seq": args.seq_len,
           "masked_per_seq": batch["mlm_positions"].shape[1],
           "param_dtype": str(cfg.param_dtype).replace("torch.", ""),
           "dtype": str(cfg.dtype).replace("torch.", ""),
           "optimizer": {"name": "adamw", "lr": load.lr, "warmup_steps": 0},
           "params": cfg.num_params(),
           "flops_per_token": cfg.flops_per_token(), **train,
           "mlm_accuracy": entry["mlm_accuracy"],
           "grad_norm": entry["grad_norm"]}
    emit("bert", **out)
    _check_losses("bert", out["losses"])
    del trainer
    _collect(on_card)
    return out


# BERT's key bias gets a zero gradient in exact arithmetic (a bias on k
# adds one score to every key of a query, which the softmax cancels), so
# both paths return rounding noise there: it is held to 1e-2 of the
# largest leaf's gradient norm instead of its own.
BERT_ZERO_GRADS = ("layers.bk",)


def phase_bert_grads(model: str = "bert_large", n_layers: int = 2,
                     B: int = 4, S: int = 512, device: str = "cuda",
                     loss_steps: int = 10) -> dict:
    """bert_large width with `n_layers` layers: the flash path's
    gradients against the reference attention path's (GRADS_REL_L2 per
    leaf, as train_grads), and the loss falling over `loss_steps` steps
    on one repeated batch."""
    import torch

    from cloudtik_tpu_torch.models import bert as BE
    from cloudtik_tpu_torch.train.data import synthetic_mlm_batches
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import (
        Trainer, TrainerConfig, bert_spec)
    from cloudtik_tpu_torch.tree import tree_leaves

    cfg = BE.config(model, n_layers=n_layers, max_seq_len=S)
    gen = torch.Generator(device=device).manual_seed(0)
    params = BE.init_params(gen, cfg, device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    host_batch = next(synthetic_mlm_batches(B, S, cfg.vocab_size, seed=1))
    batch = {k: torch.as_tensor(v).to(device, torch.long)
             for k, v in host_batch.items()}
    names = [f"{top}.{k}" if isinstance(v, dict) else top
             for top, v in params.items()
             for k in (v if isinstance(v, dict) else [None])]
    grads = {}
    for impl in ("flash", "reference"):
        icfg = dataclasses.replace(cfg, attention_impl=impl)
        loss, _ = BE.loss_fn(params, batch, icfg)
        grads[impl] = torch.autograd.grad(
            loss, tree_leaves(params), allow_unused=True,
            materialize_grads=True)
    scale = max(g.float().norm().item() for g in grads["reference"])
    rel, zero = {}, {}
    for n, a, b in zip(names, grads["flash"], grads["reference"]):
        err = (a.float() - b.float()).norm().item()
        if n in BERT_ZERO_GRADS:
            zero[n] = max(a.float().norm().item(),
                          b.float().norm().item()) / scale
        elif b.float().norm().item() > 0:
            rel[n] = err / b.float().norm().item()
        else:   # mlm_bias: never read, zero on both paths
            require(a.float().norm().item() == 0,
                    f"bert_grads: {n} has a gradient on the flash path")
    finite = all(_all_finite(g) for g in grads["flash"])
    del grads

    trainer = Trainer(bert_spec(cfg), TrainerConfig(
        global_batch_size=B, seq_len=S, log_every=1,
        optimizer=OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                                  schedule="constant")), device=device)
    trainer.init_state(params=params)
    history = trainer.fit(iter([host_batch] * loss_steps),
                          loss_steps)["history"]
    losses = [h["loss"] for h in history]
    out = {"model": model, "n_layers": n_layers, "batch": B, "seq": S,
           "grad_rel_l2_flash_vs_reference": rel,
           "zero_grad_leaves_over_largest_norm": zero,
           "tolerance_rel_l2": GRADS_REL_L2, "tolerance_zero_leaves": 1e-2,
           "grads_finite": finite, "repeated_batch_losses": losses}
    emit("bert_grads", **out)
    require(finite, "bert_grads: non-finite gradients on the flash path")
    require(max(rel.values()) <= GRADS_REL_L2,
            f"bert_grads: flash-path gradients differ from the reference "
            f"path's: {rel}")
    require(max(zero.values()) <= 1e-2,
            f"bert_grads: the zero-gradient leaves are not small: {zero}")
    require(all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0] - 0.1,
            f"bert_grads: loss did not fall on a repeated batch: {losses}")
    return out


# ------------------------------------------------------------------ optim --

# Each optimizer on the card against the same optimizer on the CPU in f32,
# from one state and on the same gradients.  Held per leaf by the L2 of
# the difference over the L2 of the total update (what the 5 updates moved
# the leaf): the card's reductions (the global norm that scales the clip,
# Adafactor's row and column means and rms) sum in another order, moving
# an update by ~1e-7 of itself; AdamW's bf16 mu rounds to bf16 on both
# sides, but a last-bit difference of its f32 input may flip a rounding,
# 2**-8 of that element's update; Lion's sign flips where its argument
# lies within that noise of zero, 2 lr on a handful of elements.  1e-3
# holds all three with room and fails on a wrong term or a stale state.
OPTIM_CASES = (("sgd", None), ("adafactor", None), ("lion", None),
               ("adamw", "bfloat16"))
OPTIM_REL_L2 = 1e-3


def phase_optim(model: str = "tpu_1b", n_layers: int = 2, steps: int = 5,
                device: str = "cuda", lr: float = 1e-3,
                nvidia_smi: str = None) -> dict:
    """`make_optimizer`'s sgd, adafactor, lion and adamw (bf16 moments)
    over the layer stack and final norm of a `n_layers`-layer model at
    `model` width, `steps` updates of gradients drawn N(0, 1e-3) (a
    global norm over 1, so the clip acts), on `device` and on the CPU."""
    import torch

    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.train.optim import (OptimizerConfig,
                                                make_optimizer)
    from cloudtik_tpu_torch.tree import tree_leaves, tree_map

    on_card = device == "cuda"
    cfg = T.config(model, n_layers=n_layers)
    full = T.init_params(torch.Generator(device=device).manual_seed(0), cfg,
                         device)
    params0 = {"layers": full["layers"], "final_norm": full["final_norm"]}
    del full
    gen = torch.Generator(device=device).manual_seed(5)
    grads = [tree_map(lambda p: torch.randn(
        p.shape, generator=gen, device=device) * 1e-3, params0)
        for _ in range(steps)]
    names = [f"layers.{k}" for k in params0["layers"]] + ["final_norm"]

    def run(where):
        params = tree_map(lambda t: t.to(where, copy=True), params0)
        opt = make_optimizer(ocfg)
        state = opt.init(params)
        for g in grads:
            updates, state, _ = opt.update(
                tree_map(lambda t: t.to(where), g), state, params)
            tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
        if where != "cpu" and on_card:
            torch.cuda.synchronize()
        return params, state

    out = {"model": model, "n_layers": n_layers, "steps": steps, "lr": lr,
           "nvidia_smi": nvidia_smi,
           "params": sum(p.numel() for p in tree_leaves(params0)),
           "tolerance_rel_l2": OPTIM_REL_L2, "cases": {}}
    p0 = tree_map(lambda p: p.cpu(), params0)
    for name, moment_dtype in OPTIM_CASES:
        ocfg = OptimizerConfig(name=name, learning_rate=lr, warmup_steps=0,
                               total_steps=1000, moment_dtype=moment_dtype)
        t0 = time.perf_counter()
        got, state = run(device)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want, _ = run("cpu")
        cpu_s = time.perf_counter() - t0
        rel = {}
        for n, a, b, p in zip(names, tree_leaves(got), tree_leaves(want),
                              tree_leaves(p0)):
            moved = (b - p).norm().item()
            rel[n] = (a.cpu() - b).norm().item() / moved
        out["cases"][f"{name}/{moment_dtype or 'float32'}"] = {
            "count": state["count"], "rel_l2": rel,
            "max_rel_l2": max(rel.values()),
            "card_s": card_s, "cpu_s": cpu_s}
        require(state["count"] == steps and max(rel.values())
                <= OPTIM_REL_L2, f"optim {name}: the card's updates differ "
                f"from the CPU's: {rel}")
        del got, want, state
    emit("optim", **out)
    return out


# -------------------------------------------------------------- checkpoint --

@dataclasses.dataclass(frozen=True)
class CheckpointLoad:
    """The checkpoint phase: the train phase's configuration (bf16 params
    and moments, save_attn) trained `steps` steps in one `fit` with a
    checkpoint every `every`, the save at `torn_step` torn right after it
    commits; then `serve_prompts` prompts of `serve_prompt` tokens and
    `serve_new` new ones through both backends on the restored weights."""
    model: str = "tpu_1b"
    batch: int = 8
    seq: int = 2048
    every: int = 2
    steps: int = 4
    torn_step: int = 4
    serve_prompts: int = 4
    serve_prompt: int = 128
    serve_new: int = 16


CHECKPOINT_LOAD = CheckpointLoad()
CHECKPOINT_REHEARSAL = CheckpointLoad(model="tiny", batch=2, seq=32,
                                      serve_prompt=8, serve_new=6)


def _span_seconds(name: str, part=None) -> dict:
    """{step: seconds} of the finished `name` spans (with attrs part ==
    `part` when given)."""
    from cloudtik_tpu_torch import telemetry

    return {r["attrs"]["step"]: r["dur"] for r in telemetry.spans()
            if r["name"] == name and "step" in r["attrs"]
            and (part is None or r["attrs"].get("part") == part)}


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).iterdir())


def _drop_page_cache(path) -> None:
    """Evict the cached pages of every file under `path` (posix_fadvise
    DONTNEED: a committed step's files are fsynced, so their pages are
    clean), so that the next read comes from the disk."""
    for f in Path(path).rglob("*"):
        if f.is_file():
            fd = os.open(f, os.O_RDONLY)
            try:
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)


def _step_timer(trainer, on_card: bool) -> list:
    """Wrap `trainer.train_step` so that it records a CUDA event on the
    current stream just before and just after each step; returns the list
    of (start, end) events it fills (none off the card)."""
    import torch

    marks = []
    train_step = trainer.train_step

    def timed(batch):
        if not on_card:
            return train_step(batch)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = train_step(batch)
        end.record()
        marks.append((start, end))
        return out

    trainer.train_step = timed
    return marks


def _step_ms(marks) -> dict:
    """Device ms of each step, and of each gap up to the next step's start
    (what the loop queues between two steps, such as a snapshot's clone),
    from `_step_timer`'s events after a synchronize."""
    return {"step_ms": [s.elapsed_time(e) for s, e in marks],
            "between_ms": [e.elapsed_time(s) for (_, e), (s, _)
                           in zip(marks, marks[1:])]}


def _leaf_gap(got, want) -> float:
    """Max abs difference over the leaves of two trees of one structure
    (`want` on the host): 0.0 only when every leaf is `torch.equal`, inf
    when a leaf differs by no finite amount (a NaN, a Python value)."""
    import torch

    from cloudtik_tpu_torch.tree import tree_leaves

    got, want = tree_leaves(got), tree_leaves(want)
    require(len(got) == len(want),
            f"{len(got)} leaves against the reference's {len(want)}")
    gap = 0.0
    for a, b in zip(got, want):
        if not isinstance(a, torch.Tensor):
            gap = gap if a == b else math.inf
            continue
        a = a.cpu()
        if not torch.equal(a, b):
            d = (a.float() - b.float()).abs().max().item()
            gap = max(gap, d) if d > 0 else math.inf
    return gap


def phase_checkpoint(load: CheckpointLoad = CHECKPOINT_LOAD,
                     device: str = "cuda") -> dict:
    """Train, save off the step loop, tear a step, resume past it, serve
    the restored weights.  Launch counts are zeroed just before the
    resumed steps and read just after."""
    import itertools
    import shutil
    import tempfile

    import numpy as np
    import torch

    from cloudtik_tpu_torch import telemetry
    from cloudtik_tpu_torch.faults import seams
    from cloudtik_tpu_torch.faults.plan import FaultPlan, FaultPoint
    from cloudtik_tpu_torch.models import generate as G
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.serve.server import (
        ServeServer, engine_backend, transformer_backend)
    from cloudtik_tpu_torch.telemetry import goodput
    from cloudtik_tpu_torch.train.checkpoint import restore_params
    from cloudtik_tpu_torch.train.data import synthetic_lm_batches
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import (
        Trainer, TrainerConfig, transformer_spec)
    from cloudtik_tpu_torch.tree import tree_leaves, tree_map

    on_card = device == "cuda"
    telemetry.enable()
    B, S = load.batch, load.seq
    cfg = T.config(load.model, max_seq_len=S, param_dtype=torch.bfloat16)
    root = tempfile.mkdtemp(prefix="tik-checkpoint-")
    ckpt_dir = str(Path(root) / "run")
    # one log window over a whole fit: nothing waits for the card between
    # steps, so a save's d2h runs under the steps after it, as in a long
    # run
    one_window = load.steps + 1

    def trainer_for(every: int, depth: int = 2,
                    log_every: int = 1) -> "Trainer":
        return Trainer(transformer_spec(cfg), TrainerConfig(
            global_batch_size=B, seq_len=S, log_every=log_every,
            optimizer=OptimizerConfig(moment_dtype="bfloat16"),
            checkpoint_every=every, checkpoint_dir=ckpt_dir,
            prefetch_depth=depth), device=device)

    def data(skip: int = 0):
        return itertools.islice(
            synthetic_lm_batches(B, S, cfg.vocab_size, seed=5), skip, None)

    def seed():
        return torch.Generator(device=device).manual_seed(0)

    def free_card():
        gc.collect()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def host_copy(tree):
        return tree_map(lambda t: t.detach().cpu().clone()
                        if isinstance(t, torch.Tensor) else t, tree)

    def losses(out):
        return [h["loss"] for h in out["history"]]

    def timed_s(fn):
        t0 = time.perf_counter()
        result = fn()
        return result, time.perf_counter() - t0

    out = {"model": load.model, "batch": B, "seq": S,
           "param_dtype": "bfloat16", "moment_dtype": "bfloat16",
           "remat_policy": cfg.remat_policy, "directory": root}
    try:
        # ---- room for max_to_keep + 1 steps of the saving trainer's
        # checkpointer, or a loud failure ----
        trainer = trainer_for(every=load.every, log_every=one_window)
        keep = trainer.checkpointer.config.max_to_keep
        state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(
            trainer._abstract_state()) if isinstance(t, torch.Tensor))
        free = shutil.disk_usage(root).free
        need = (keep + 1) * state_bytes
        out["disk"] = {"state_bytes": state_bytes, "free_bytes": free,
                       "max_to_keep": keep, "needed_bytes": need}
        require(free >= need, f"checkpoint phase: {free} bytes free under "
                f"{root}, {need} needed for {keep + 1} steps of "
                f"{state_bytes} bytes")

        # ---- determinism: `every` steps twice from one state (prefetch
        # 0 and 2), data_wait per step from the goodput ledger (log_every
        # 1: the callback runs after each step, so the pipeline's start,
        # step 1, stands apart); the prefetch-2 run goes on, uninterrupted,
        # to `steps`: its state at `every` and its losses are what the
        # saving run must restore and resume to ----
        buckets = (goodput.BUCKET_DATA_WAIT, goodput.BUCKET_HOST_TRANSFER)
        probe = trainer_for(every=0, depth=0)
        probe_losses, data_wait, at_save = {}, {}, {}
        for depth in (0, 2):
            probe.config.prefetch_depth = depth
            probe.init_state(seed())
            totals = [[goodput.LEDGER.total(b) for b in buckets]]
            probe_losses[depth] = losses(probe.fit(
                data(), load.every, callbacks=[
                    lambda _t, _e: totals.append(
                        [goodput.LEDGER.total(b) for b in buckets])]))
            per_step = [[(b - a) * 1e3 for a, b in zip(x, y)]
                        for x, y in zip(totals, totals[1:])]
            data_wait[depth] = {
                "data_wait_ms_by_step": [w for w, _ in per_step],
                "host_transfer_ms_by_step": [h for _, h in per_step]}
            at_save[depth] = host_copy(probe.state)
        uninterrupted = probe_losses[2] + losses(probe.fit(
            data(skip=load.every), load.steps - load.every))
        del probe
        free_card()
        loss_gap = max(abs(a - b) for a, b in zip(probe_losses[0],
                                                  probe_losses[2]))
        state_gap = _leaf_gap(at_save[0], at_save[2])
        require(math.isfinite(state_gap), "the two probe runs' states "
                "differ by no finite amount")
        saved = at_save.pop(2)
        del at_save
        deterministic = probe_losses[0] == probe_losses[2] \
            and state_gap == 0.0
        loss_tol = 0.0 if deterministic else 2 * loss_gap
        leaf_tol = 2 * state_gap
        out["determinism"] = {"losses": probe_losses,
                              "max_abs_loss_gap": loss_gap,
                              "max_abs_leaf_gap": state_gap,
                              "bitwise": deterministic,
                              "resume_tolerance": loss_tol,
                              "leaf_tolerance": leaf_tol}
        out["prefetch"] = {f"depth_{d}": v for d, v in data_wait.items()}

        # ---- the same fit with no save, step by step on the card's
        # clock: what the saving run's steps are held against ----
        nosave = trainer_for(every=0, log_every=one_window)
        nosave.init_state(seed())
        nosave_marks = _step_timer(nosave, on_card)
        nosave.fit(data(), load.steps)
        del nosave
        free_card()

        # ---- train and save in one fit, step `torn_step` torn; at each
        # save the peak since the last one (or the fit's start) is read
        # and the peak restarted once the snapshot is staged ----
        trainer.init_state(seed())
        ckpt = trainer.checkpointer
        marks = _step_timer(trainer, on_card)
        staged = []
        save = ckpt.save

        def measured_save(step, state, force=False):
            row = {"step": step}
            if on_card:
                row.update(
                    peak_before_gb=torch.cuda.max_memory_allocated() / 1e9,
                    allocated_before_gb=torch.cuda.memory_allocated() / 1e9)
            started = save(step, state, force)
            if started:
                if on_card:
                    row["allocated_after_gb"] = \
                        torch.cuda.memory_allocated() / 1e9
                    torch.cuda.reset_peak_memory_stats()
                staged.append(row)
            return started

        ckpt.save = measured_save
        plan = FaultPlan([FaultPoint("checkpoint.save", "torn_write",
                                     match={"step": load.torn_step})],
                         seed=7, name="checkpoint-phase")
        free_card()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        with seams.armed(plan):
            final = losses(trainer.fit(data(), load.steps))
            ckpt.wait()
        require([e for e in plan.trace if e["kind"] == "torn_write"],
                "the torn-write fault never fired")
        require(abs(final[-1] - uninterrupted[-1]) <= loss_tol,
                f"the saving run's last loss {final[-1]} differs from the "
                f"uninterrupted run's {uninterrupted[-1]} (tolerance "
                f"{loss_tol})")
        ckpt.close()
        steps_on_disk = ckpt.all_steps()
        step_bytes = {s: _dir_bytes(Path(ckpt_dir) / str(s))
                      for s in steps_on_disk}
        require(steps_on_disk == list(range(load.every, load.steps + 1,
                                            load.every)),
                f"steps on disk {steps_on_disk}")
        del trainer, ckpt
        free_card()

        # ---- resume past the torn step, from the disk ----
        resumed = trainer_for(every=1000)
        _drop_page_cache(ckpt_dir)
        step, resume_s = timed_s(resumed.maybe_resume)
        require(step == load.every, f"resumed at step {step}, expected "
                f"{load.every} (step {load.torn_step} is torn)")
        restored_gap = _leaf_gap(resumed.state, saved)
        require(restored_gap <= leaf_tol,
                f"restored leaves differ from the uninterrupted run's "
                f"state at step {load.every} by {restored_gap} (tolerance "
                f"{leaf_tol})")
        _zero_launch_counts()
        _zero_det_launch_counts()
        resumed_losses = losses(resumed.fit(data(skip=load.every),
                                            load.steps - load.every))
        launches = _launch_counts()
        det_launches = _det_launch_counts()
        require(not any(det_launches.values()),
                f"the checkpoint path launched {det_launches}, expected "
                "no detection kernel")
        diff = max(abs(a - b) for a, b in zip(
            resumed_losses, uninterrupted[load.every:]))
        out["resume"] = {"restored_step": step, "resume_s": resume_s,
                         "leaves": len(tree_leaves(saved)),
                         "max_abs_leaf_gap": restored_gap,
                         "uninterrupted_losses": uninterrupted,
                         "saving_run_last_loss": final[-1],
                         "resumed_losses": resumed_losses,
                         "max_abs_loss_diff": diff,
                         "tolerance": loss_tol}
        require(diff <= loss_tol,
                f"resumed losses {resumed_losses} differ from the "
                f"uninterrupted run's {uninterrupted[load.every:]} by "
                f"{diff} (tolerance {loss_tol})")
        out["launches"] = launches
        out["det_launches"] = det_launches
        out["launches_per_step"] = {
            k: n / (load.steps - load.every) for k, n in launches.items()}

        # ---- restore times, each read from the disk (page cache dropped
        # before it) but the second full one: past the torn step, which
        # goes (the torn file may be an optimizer leaf, which a
        # params-only read never opens), then full and params-only reads
        # of step `every` ----
        _drop_page_cache(ckpt_dir)
        (_state, good), past_torn_s = timed_s(
            lambda: resumed.checkpointer.restore_latest_good(
                resumed._abstract_state(), remove_unreadable=True,
                device=torch.device(device)))
        del _state
        require(good == load.every
                and resumed.checkpointer.all_steps() == [load.every],
                f"restore_latest_good gave step {good}, left "
                f"{resumed.checkpointer.all_steps()}")
        _drop_page_cache(ckpt_dir)
        _, full_s = timed_s(lambda: resumed.restore_checkpoint(load.every))
        _, full_warm_s = timed_s(
            lambda: resumed.restore_checkpoint(load.every))
        del resumed
        free_card()
        like = T.init_params(torch.Generator(), cfg, "meta")
        _drop_page_cache(ckpt_dir)
        params, params_s = timed_s(
            lambda: restore_params(ckpt_dir, like, torch.device(device)))
        require(_leaf_gap(params, saved["params"]) <= leaf_tol,
                "the params-only restore differs from the saved params")
        del params

        # ---- save costs: the host's enqueue and the write from the
        # spans; the stall as the card's time from the end of the saved
        # step to the end of the fit, against the fit with no save ----
        snap = _span_seconds("checkpoint.save", "snapshot")
        d2h = _span_seconds("checkpoint.d2h")
        write = _span_seconds("checkpoint.save", "write")
        inline = _span_seconds("checkpoint.save", "inline")
        pinned = [r["dur"] for r in telemetry.spans()
                  if r["name"] == "checkpoint.reserve"]
        gb = step_bytes[load.every] / 1e9
        stall = {}
        if on_card:
            def after_save_ms(m):
                return m[load.every - 1][1].elapsed_time(m[-1][1])

            steps_ms, nosave_ms = _step_ms(marks), _step_ms(nosave_marks)
            stall = {
                "stall_ms": after_save_ms(marks)
                - after_save_ms(nosave_marks),
                "after_save_ms": after_save_ms(marks),
                "after_save_no_save_ms": after_save_ms(nosave_marks),
                "clone_ms": steps_ms["between_ms"][load.every - 1]
                - nosave_ms["between_ms"][load.every - 1],
                "step_ms": steps_ms["step_ms"],
                "step_no_save_ms": nosave_ms["step_ms"]}
        out["save"] = {
            "step_dir_bytes": step_bytes[load.every],
            "torn_step_dir_bytes": step_bytes[load.torn_step],
            "offloaded": {"step": load.every,
                          "host_enqueue_ms": snap[load.every] * 1e3,
                          "stall_ms": stall.get("stall_ms"),
                          # the buffers pinned before the fit's first step
                          "pin_before_loop_s":
                          pinned[0] if pinned else None,
                          "d2h_s": d2h[load.every],
                          "d2h_gb_per_s": gb / d2h[load.every],
                          "write_s": write[load.every],
                          "write_gb_per_s": gb / write[load.every]},
            "card_time": stall or None,
            "torn_inline": {"step": load.torn_step,
                            "stall_s": inline[load.torn_step],
                            "d2h_s": d2h[load.torn_step],
                            "d2h_gb_per_s": gb / d2h[load.torn_step],
                            "write_s": write[load.torn_step]},
        }
        out["restore"] = {"cold_full_s": full_s,
                          "cold_full_gb_per_s": gb / full_s,
                          "warm_full_s": full_warm_s,
                          "cold_params_only_s": params_s,
                          "cold_full_past_torn_step_s": past_torn_s}
        first, torn = staged
        out["memory"] = {
            "peak_no_snapshot_gb": first.get("peak_before_gb"),
            "peak_with_snapshot_gb": torn.get("peak_before_gb"),
            "snapshot_gb": (first["allocated_after_gb"]
                            - first["allocated_before_gb"])
            if on_card else None,
            "snapshot_held_at_next_save_gb": (
                torn["allocated_before_gb"] - first["allocated_before_gb"])
            if on_card else None,
            "at_save": staged}

        # ---- serve the restored weights: plain backend and engine ----
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab_size, (
            load.serve_prompts, load.serve_prompt)).tolist()
        overrides = dict(max_seq_len=S, param_dtype=torch.bfloat16)
        plain = transformer_backend(load.model, checkpoint_dir=ckpt_dir,
                                    device=device, **overrides)
        require(_leaf_gap(plain.params, saved["params"]) <= leaf_tol,
                "the served params differ from the saved ones")
        engine = engine_backend(
            load.model, checkpoint_dir=ckpt_dir, device=device, slots=4,
            max_len=load.serve_prompt + load.serve_new + 16, block_size=16,
            **overrides)
        served = {"plain": [], "engine": []}
        gaps = []
        try:
            for name, backend in (("plain", plain), ("engine", engine)):
                server = ServeServer([backend], host="127.0.0.1", port=0)
                server.start()
                try:
                    for prompt in prompts:
                        status, body = _http(
                            f"http://127.0.0.1:{server.port}/v1/generate",
                            {"tokens": [prompt],
                             "max_new_tokens": load.serve_new})
                        require(status == 200, f"{name}: status {status} "
                                f"{body}")
                        served[name].append(body["tokens"][0])
                finally:
                    server.stop()
            for prompt, plain_toks, eng_toks in zip(
                    prompts, served["plain"], served["engine"]):
                direct = G.generate(
                    plain.params, torch.tensor([prompt], device=device),
                    plain.cfg, max_new_tokens=load.serve_new)[0].tolist()
                require(plain_toks == direct, "served tokens differ from "
                        "a direct generate on the restored params")
                gaps.append(check_tie_aware("checkpoint engine", tie_gaps(
                    plain.params, plain.cfg, prompt, eng_toks, device)))
        finally:
            engine.engine.stop()
        out["serve"] = {"prompts": load.serve_prompts,
                        "prompt_len": load.serve_prompt,
                        "new_tokens": load.serve_new,
                        "plain_equals_direct_generate": True,
                        "engine_equal_to_plain": sum(
                            a == b for a, b in zip(served["plain"],
                                                   served["engine"])),
                        "engine_tie_gap_max": max(gaps),
                        "tie_gap_limit": ENGINE_TIE_GAP}
        del plain, engine
    finally:
        shutil.rmtree(root, ignore_errors=True)
    require(not Path(root).exists(), f"{root} was not removed")
    emit("checkpoint", **out)
    gc.collect()
    return out


# -------------------------------------------------------------- kernel_det --

# FP32 rate outside the tensor cores (NVIDIA data sheet), for NMS's bound.
PEAK_F32_FLOPS = 67e12


@dataclasses.dataclass(frozen=True)
class NmsCase:
    name: str
    B: int
    N: int
    K: int
    seed: int                 # numpy seed of the boxes and scores
    iou_threshold: float = 0.5
    scores: str = "uniform"   # "uniform" in [0, 1) or "zero"
    degenerate: bool = False  # zero-area, duplicate and inverted boxes
    # "nan_score", "nan_box", "signed_zero" or "inf_and_absent": the
    # reference's NaN, signed-zero and absent-score semantics
    special: str = ""


# The first two are the shapes `detect` gives the kernel: Mask R-CNN (8
# images of 128 proposals, 50 kept) and SSD (8 images of 3,000 anchors, 100
# kept); ssd1200_b8 is SSD at MLPerf's 1200 x 1200 input (45,384 anchors an
# image).  Keep lists must equal the plain version's and the JAX
# `nms_reference`'s (tests/torch_golden/) exactly.
NMS_CASES = (
    NmsCase("maskrcnn_b8", 8, 128, 50, seed=1),
    NmsCase("ssd_b8", 8, 3000, 100, seed=2),
    NmsCase("all_zero_scores", 8, 3000, 100, seed=3, scores="zero"),
    NmsCase("fewer_than_k", 4, 60, 100, seed=4, iou_threshold=0.3),
    NmsCase("degenerate", 4, 512, 64, seed=5, iou_threshold=0.3,
            degenerate=True),
    NmsCase("ssd1200_b8", 8, 45_384, 100, seed=6),
    NmsCase("all_zero_ssd1200", 8, 45_384, 100, seed=7, scores="zero"),
    NmsCase("nan_score", 4, 3000, 100, seed=8, special="nan_score"),
    NmsCase("nan_box", 4, 512, 64, seed=9, special="nan_box"),
    NmsCase("signed_zero", 4, 512, 64, seed=10, special="signed_zero"),
    NmsCase("inf_and_absent", 4, 3000, 100, seed=11,
            special="inf_and_absent"),
    # K past half of N: the scan runs through every band of both images
    NmsCase("many_kept", 2, 3000, 1500, seed=12, iou_threshold=0.9),
)
# the kernel_det cases at the shapes the detect paths give B4
NMS_DETECT_SHAPES = ("ssd_b8", "maskrcnn_b8", "ssd1200_b8")
# anchors of ssd_resnet34 at 1200 x 1200 (maps 75/38/19/10/5/3, 6 a cell)
SSD1200_ANCHORS = 45_384
# flops per (kept box, candidate): the IoU and its compare (2 min, 2 max,
# 2 sub, 2 clamps, mul, add, sub, max, div, compare)
NMS_FLOPS_PER_PAIR = 16
# The JAX `nms_reference` keep list of each case, made from its seed by
# tools/export_torch_golden.py
GOLDEN_DIR = Path(__file__).resolve().parent / "tests" / "torch_golden"
# what the hand-made first image of nan_box and signed_zero keeps
NAN_BOX_KEEP = [1, 0, -1]
SIGNED_ZERO_KEEP = [0, -1, -1]


def make_nms_arrays(c: NmsCase):
    """Normalized xyxy boxes [B, N, 4] and scores [B, N], f32 numpy arrays
    made from the case's seed with exact float arithmetic only (no
    transcendental), so that every machine makes the same bits."""
    import numpy as np

    f32 = np.float32
    rng = np.random.default_rng(c.seed)
    xy = rng.random((c.B, c.N, 2), dtype=f32) * f32(0.8)
    wh = rng.random((c.B, c.N, 2), dtype=f32) * f32(0.3) + f32(0.01)
    boxes = np.concatenate([xy, np.minimum(xy + wh, f32(1.0))], axis=-1)
    if c.scores == "zero":
        scores = np.zeros((c.B, c.N), f32)
    else:
        scores = rng.random((c.B, c.N), dtype=f32)
    if c.degenerate:
        q = c.N // 4
        boxes[:, :q, 2:] = boxes[:, :q, :2]               # zero area
        boxes[:, q:2 * q] = boxes[:, 2 * q:3 * q]         # duplicates ...
        scores[:, q:2 * q] = scores[:, 2 * q:3 * q]       # ... tied
        boxes[:, 3 * q:] = boxes[:, 3 * q:][..., [2, 3, 0, 1]]  # inverted
    u = rng.random((c.B, c.N))
    if c.special == "nan_score":
        # every image but the last holds one NaN score: it keeps nothing
        for b in range(c.B - 1):
            scores[b, (int(rng.integers(c.N)), 0, c.N - 1)[b % 3]] = np.nan
    elif c.special == "nan_box":
        # image 0 starts [[0,0,1,1], [NaN,0,1,1], [0,0,1,1]] at scores
        # [0.5, 0.9, 0.4], every other box absent; in the others one box
        # in ten has a NaN coordinate
        coord = rng.integers(0, 4, (c.B, c.N))
        rows, cols = np.nonzero(u < 0.1)
        boxes[rows, cols, coord[rows, cols]] = np.nan
        boxes[0, :3] = [[0, 0, 1, 1], [np.nan, 0, 1, 1], [0, 0, 1, 1]]
        scores[0] = -np.inf
        scores[0, :3] = [0.5, 0.9, 0.4]
    elif c.special == "signed_zero":
        # image 0 starts with three copies of one box at [-0.0, 0.0, 0.0],
        # every other box absent; the others hold +-0.0 ties and a tenth
        # of scores in [-0.5, 0.5)
        scores[:] = np.where(u < 0.45, f32(-0.0), f32(0.0))
        scores[u >= 0.9] = ((u[u >= 0.9] - 0.95) * 10).astype(f32)
        boxes[0, :3] = boxes[0, 0]
        scores[0] = -np.inf
        scores[0, :3] = [-0.0, 0.0, 0.0]
    elif c.special == "inf_and_absent":
        # +inf, and scores at or below -5e29 (absent) beside -4e29 (not);
        # the last image holds absent scores only
        for lo, hi, value in ((0.0, 0.01, np.inf), (0.01, 0.06, -np.inf),
                              (0.06, 0.11, -1e30), (0.11, 0.16, -5e29),
                              (0.16, 0.21, -6e29), (0.21, 0.26, -4e29)):
            scores[(u >= lo) & (u < hi)] = value
        if c.B > 1:
            scores[-1] = np.where(u[-1] < 0.5, f32(-np.inf), f32(-5e29))
    return boxes, scores


def make_nms_inputs(c: NmsCase, device: str):
    """`make_nms_arrays` as tensors on the device, as `detect` hands them
    to NMS."""
    import torch

    boxes, scores = make_nms_arrays(c)
    return (torch.from_numpy(boxes).to(device),
            torch.from_numpy(scores).to(device))


def golden_keep(c: NmsCase):
    """The JAX `nms_reference` keep list [B, K] committed for this case, or
    None when there is none for these inputs (a case cut to CPU size)."""
    import numpy as np

    path = GOLDEN_DIR / f"nms_{c.name}.npz"
    if not path.exists():
        return None
    g = np.load(path)
    same = (int(g["seed"]) == c.seed
            and tuple(int(x) for x in g["shape"]) == (c.B, c.N, c.K)
            and float(g["iou_threshold"]) == c.iou_threshold)
    return g["keep"] if same else None


def check_nms_case(c: NmsCase, keep, scores) -> None:
    """What each kind of case states beyond equality, on the keep list
    [B, K] (numpy) of scores [B, N] (numpy)."""
    import numpy as np

    if c.N < c.K:
        require(bool((keep[:, c.N:] == -1).all()),
                f"nms {c.name}: no -1 padding")
    if c.scores == "zero" and not c.special:
        require(bool((keep[:, 0] == 0).all()),
                f"nms {c.name}: ties not taken by lowest index")
    if c.special == "nan_score":
        require(bool((keep[:-1] == -1).all()) and bool((keep[-1] >= 0).any()),
                f"nms {c.name}: an image with a NaN score kept a box, or "
                "the clean image kept none")
    elif c.special == "nan_box":
        require(keep[0, :3].tolist() == NAN_BOX_KEEP,
                f"nms {c.name}: kept {keep[0, :3].tolist()}, expected "
                f"{NAN_BOX_KEEP}")
    elif c.special == "signed_zero":
        require(keep[0, :3].tolist() == SIGNED_ZERO_KEEP,
                f"nms {c.name}: kept {keep[0, :3].tolist()}, expected "
                f"{SIGNED_ZERO_KEEP}")
    elif c.special == "inf_and_absent":
        picked = np.take_along_axis(scores, np.maximum(keep, 0), axis=1)
        require(bool((picked[keep >= 0] > np.float32(-5e29)).all()),
                f"nms {c.name}: an absent score was kept")
        require(c.B == 1 or bool((keep[-1] == -1).all()),
                f"nms {c.name}: the image of absent scores kept a box")
        for b in range(c.B):
            inf = np.nonzero(scores[b] == np.inf)[0]
            require(len(inf) == 0 or keep[b, 0] == inf[0],
                    f"nms {c.name}: image {b} did not start at its first "
                    "+inf score")


def nms_scan_work(scores, keep):
    """What a scan in sorted order must do on these inputs, from the keep
    list [B, K] (numpy) of scores [B, N] (numpy): the candidates it reaches
    (through the K-th kept, or all of them) and the IoUs it takes, one for
    each (kept box, later candidate reached).  An image with a NaN score
    takes none.  Returns (candidates reached, IoU pairs), summed over the
    images."""
    import numpy as np

    K = keep.shape[1]
    reached = pairs = 0
    for s, k in zip(scores, keep):
        if np.isnan(s).any():
            continue
        cand = np.nonzero(s > np.float32(-5e29))[0]
        order = cand[np.lexsort((cand, -s[cand]))]   # -0.0 ties +0.0
        rank = np.empty(len(s), np.int64)
        rank[order] = np.arange(len(order))
        pos = rank[k[k >= 0]]
        n = int(pos[-1]) + 1 if len(pos) == K else len(order)
        reached += n
        pairs += int((n - 1 - pos).sum())
    return reached, pairs


def nms_bound(c: NmsCase, scores, keep):
    """Least time for the work these inputs need: each box (20 bytes) read
    once, each keep index written once; one IoU for each (kept box, later
    candidate) that the scan in sorted order reaches (`nms_scan_work`)."""
    _, pairs = nms_scan_work(scores, keep)
    flops = NMS_FLOPS_PER_PAIR * pairs
    nbytes = 20 * c.B * c.N + 4 * c.B * c.K
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def nms_steps_bound_ms(c: NmsCase, kept: int) -> float:
    """The bound that the rows of the earlier, argmax-loop design gave:
    `kept` greedy steps over all N boxes, or the bytes if more.  Kept under
    its own key, so that rows compare across designs."""
    t_ops = NMS_FLOPS_PER_PAIR * kept * c.N / PEAK_F32_FLOPS
    t_bytes = (20 * c.B * c.N + 4 * c.B * c.K) / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3


@dataclasses.dataclass(frozen=True)
class RoiCase:
    name: str
    B: int
    R: int
    C: int
    H: int
    P: int
    sampling: int
    scale: float = 1.0
    dtype: str = "bfloat16"
    # "nhwc": the detect path's [B, H, W, C] map permuted to [B, C, H, W]
    layout: str = "nhwc"
    rois: str = "proposals"   # "proposals", "outside" or "subpixel"
    # the route of csrc/roi_align.cu the kernel must take
    # (`detection.roi_align_route`): "vector" for a bf16 NHWC map whose C
    # is a multiple of 8, else "strided"
    route: str = "vector"


# The first two are the shapes Mask R-CNN's `roi_heads` gives the kernel: 8
# images x 128 proposals on the [8, 32, 32, 1024] bf16 C4 map, pooled to 7x7
# and 14x14 with sampling 1.  ragged_channels has a bf16 NHWC map of 100
# channels: its 200-byte pixel stride and its channel tail take the strided
# route.  channel_tail's 72 channels take the vector route with a last
# block of 8 channels.
ROI_CASES = (
    RoiCase("maskrcnn_7", 8, 128, 1024, 32, 7, 1),
    RoiCase("maskrcnn_14", 8, 128, 1024, 32, 14, 1),
    RoiCase("sampling2_scale025", 2, 64, 256, 64, 7, 2, scale=0.25,
            dtype="float32", layout="nchw", route="strided"),
    RoiCase("partly_outside", 2, 64, 256, 32, 7, 2, rois="outside"),
    RoiCase("subpixel", 2, 64, 96, 32, 7, 2, dtype="float32",
            rois="subpixel", route="strided"),
    RoiCase("ragged_channels", 2, 64, 100, 32, 14, 1, route="strided"),
    RoiCase("channel_tail", 2, 64, 72, 32, 7, 2),
)
# f32 outputs from the same (widened) inputs; only the order of the sums
# and the contraction of the bilinear weights differ
ROI_ATOL = ROI_RTOL = 1e-5
ROI_FLOPS_PER_SAMPLE = 16   # 4 taps: weights, products, sum


def make_roi_inputs(c: RoiCase, gen, device: str):
    import torch

    dtype = getattr(torch, c.dtype)
    if c.layout == "nhwc":
        feats = torch.randn((c.B, c.H, c.H, c.C), generator=gen,
                            device=device).to(dtype).permute(0, 3, 1, 2)
    else:
        feats = torch.randn((c.B, c.C, c.H, c.H), generator=gen,
                            device=device).to(dtype)
    extent = c.H / c.scale           # input coordinates
    u = torch.rand((c.B, c.R, 4), generator=gen, device=device)
    if c.rois == "proposals":        # normalized boxes times the map size
        x1y1 = u[..., :2] * 0.9
        x2y2 = (x1y1 + 0.02 + u[..., 2:] * 0.5).clamp(max=1.0)
    elif c.rois == "outside":
        x1y1 = u[..., :2] - 0.5
        x2y2 = x1y1 + 0.3 + u[..., 2:] * 0.9
    else:                            # under a pixel: clamped to size 1
        x1y1 = u[..., :2]
        x2y2 = x1y1 + u[..., 2:] * 0.5 * c.scale
    return feats, (torch.cat([x1y1, x2y2], dim=-1) * extent).contiguous()


def roi_bound(c: RoiCase):
    """Least time: the map read once, rois read once, the f32 output
    written once; bilinear arithmetic on every sample."""
    elem = 2 if c.dtype == "bfloat16" else 4
    out = c.B * c.R * c.C * c.P * c.P
    flops = ROI_FLOPS_PER_SAMPLE * out * c.sampling ** 2
    nbytes = elem * c.B * c.C * c.H * c.H + 16 * c.B * c.R + 4 * out
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def roi_errors(got, want) -> dict:
    err = (got - want).abs()
    return {"max_abs_err": err.max().item(),
            "within": bool((err <= ROI_ATOL + ROI_RTOL * want.abs()).all()),
            "finite": _all_finite(got)}


def phase_kernel_det(device: str = "cuda", nms_cases=NMS_CASES,
                     roi_cases=ROI_CASES) -> dict:
    """B4 and B5 against their plain versions on the same inputs; times on
    the card only."""
    import torch

    from cloudtik_tpu_torch.ops import detection as D

    on_card = device == "cuda"
    gen = torch.Generator(device=device).manual_seed(2)
    out = {"nms": {}, "roi_align": {}}
    for c in nms_cases:
        boxes, scores = make_nms_inputs(c, device)
        kw = {"iou_threshold": c.iou_threshold, "max_output": c.K}
        keep = D.nms_batched(boxes, scores, **kw)
        want = D.nms_reference_batched(boxes, scores, **kw)
        require(keep.shape == (c.B, c.K) and keep.dtype == torch.int32,
                f"nms {c.name}: keep {tuple(keep.shape)} {keep.dtype}")
        diff = (keep - want).abs().max().item()
        require(diff == 0, f"nms {c.name}: keep differs from the plain "
                           f"version in {int((keep != want).sum())} places")
        keep_np, scores_np = keep.cpu().numpy(), scores.cpu().numpy()
        check_nms_case(c, keep_np, scores_np)
        golden = golden_keep(c)
        require(golden is not None or not on_card,
                f"nms {c.name}: no JAX golden keep list for these inputs "
                f"in {GOLDEN_DIR}")
        if golden is not None:
            require(bool((keep_np == golden).all()),
                    f"nms {c.name}: keep differs from the JAX golden in "
                    f"{int((keep_np != golden).sum())} places")
        kept = int((keep >= 0).sum())
        bound_ms, bound_by, flops, nbytes = nms_bound(c, scores_np, keep_np)
        row = {"case": c.name, "B": c.B, "N": c.N, "K": c.K,
               "iou_threshold": c.iou_threshold, "kept": kept,
               "reached": nms_scan_work(scores_np, keep_np)[0],
               "max_abs_err": diff, "equal": True,
               "jax_golden_equal": golden is not None,
               "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
               "bytes": nbytes,
               "reference_steps_bound_ms": nms_steps_bound_ms(c, kept)}
        if on_card:
            row["kernel_ms"] = time_ms(lambda: D.nms_batched(
                boxes, scores, **kw))
            row["plain_ms"] = time_ms(lambda: D.nms_reference_batched(
                boxes, scores, **kw), iters=3, warmup=1)
        emit("kernel_det", kernel="nms", **row)
        out["nms"][c.name] = row
    for c in roi_cases:
        feats, rois = make_roi_inputs(c, gen, device)
        kw = {"pooled_size": c.P, "sampling_ratio": c.sampling,
              "spatial_scale": c.scale}
        D.LAST_ROI_ROUTE = None
        got = D.roi_align_batched(feats, rois, **kw)
        route = D.LAST_ROI_ROUTE       # None on the CPU: no kernel ran
        require(route == (c.route if on_card else None),
                f"roi_align {c.name}: took the {route} route, expected "
                f"{c.route}")
        want = D.roi_align_reference_batched(feats, rois, **kw)
        require(got.shape == (c.B, c.R, c.C, c.P, c.P)
                and got.dtype == torch.float32,
                f"roi_align {c.name}: output {tuple(got.shape)} {got.dtype}")
        errors = roi_errors(got, want)
        require(errors["finite"], f"roi_align {c.name}: non-finite output")
        require(errors["within"], f"roi_align {c.name}: differs from the "
                                  f"plain version {errors}")
        del got, want
        bound_ms, bound_by, flops, nbytes = roi_bound(c)
        row = {"case": c.name, "B": c.B, "R": c.R, "C": c.C, "H": c.H,
               "P": c.P, "sampling": c.sampling, "scale": c.scale,
               "dtype": c.dtype, "layout": c.layout, "rois": c.rois,
               "route": route, "max_abs_err": errors["max_abs_err"],
               "tolerance": {"atol": ROI_ATOL, "rtol": ROI_RTOL},
               "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
               "bytes": nbytes}
        if on_card:
            row["kernel_ms"] = time_ms(lambda: D.roi_align_batched(
                feats, rois, **kw))
            row["plain_ms"] = time_ms(lambda: D.roi_align_reference_batched(
                feats, rois, **kw), iters=3, warmup=1)
            torch.cuda.empty_cache()
        emit("kernel_det", kernel="roi_align", **row)
        out["roi_align"][c.name] = row
    return out


# ------------------------------------------------------------------ detect --

def _det_launch_counts() -> dict:
    from cloudtik_tpu_torch.ops import detection as D

    return {"nms": D.LAUNCHES_NMS, "roi_align": D.LAUNCHES_ROI_ALIGN}


def _zero_det_launch_counts() -> None:
    from cloudtik_tpu_torch.ops import detection as D

    D.LAUNCHES_NMS = D.LAUNCHES_ROI_ALIGN = 0


def _timed_call(fn, on_card: bool):
    """(result, ms) of one call: CUDA events on the card, else the host
    clock."""
    import torch

    if not on_card:
        t0 = time.perf_counter()
        result = fn()
        return result, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    end.synchronize()
    return result, start.elapsed_time(end)


def phase_detect(kind: str, name: str, B: int = 8, device: str = "cuda",
                 warmup: int = 1, iters: int = 5, **overrides) -> dict:
    """`detect` of a repo preset at full width (bf16 compute, f32 params,
    random weights from seed 0), with `overrides` of its config (such as
    `image_size`): `warmup` calls, then the detection counts zeroed,
    `iters` measured calls, the counts read.  Then the last call's outputs
    are checked, and its NMS and ROIAlign inputs are held against the plain
    versions (launches made for that come after the counts)."""
    import torch

    from cloudtik_tpu_torch.models import maskrcnn as MR
    from cloudtik_tpu_torch.models import ssd as SD
    from cloudtik_tpu_torch.ops import detection as D

    M = {"maskrcnn": MR, "ssd": SD}[kind]
    cfg = M.config(name, **overrides)
    on_card = device == "cuda"
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(gen, cfg, device)
    S = cfg.image_size
    images = torch.randn((B, S, S, 3), generator=gen, device=device)

    def call():
        return M.detect(params, images, cfg, device=device)

    for _ in range(warmup):
        call()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # ---- the detection path: counts zeroed just before, read just after --
    _zero_det_launch_counts()
    ms = []
    for _ in range(iters):
        out, t = _timed_call(call, on_card)
        ms.append(t)
    launches = _det_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None

    K = out["keep"].shape[1]
    valid = out["keep"] >= 0
    labels = out["labels"]
    require(out["boxes"].shape == (B, K, 4) and out["scores"].shape == (B, K),
            f"{name}: output shapes")
    for key in ("boxes", "scores", "nms_boxes", "nms_scores"):
        require(_all_finite(out[key]), f"{name}: non-finite {key}")
    require(bool(((labels >= 1) & (labels < cfg.num_classes))[valid].all())
            and bool((labels[~valid] == 0).all()),
            f"{name}: labels outside [1, {cfg.num_classes})")
    boxes = out["boxes"][valid]
    require(bool((boxes[:, 2:] >= boxes[:, :2]).all()),
            f"{name}: a kept box with x2 < x1 or y2 < y1")
    want_keep = D.nms_reference_batched(
        out["nms_boxes"], out["nms_scores"], iou_threshold=0.5,
        max_output=K)
    require(bool((out["keep"] == want_keep).all()),
            f"{name}: NMS keep differs from the plain version on the "
            "call's own boxes and scores")
    result = {"model": name, "batch": B, "image_size": S,
              "nms_boxes_per_image": out["nms_scores"].shape[1],
              "dtype": "bfloat16", "warmup_calls": warmup,
              "measured_calls": iters, "ms_per_call": ms,
              "mean_ms": sum(ms) / len(ms),
              "images_per_s": B / (sum(ms) / len(ms) / 1e3),
              "peak_mem_gb": peak, "launches": launches,
              "kept_per_image": valid.sum(dim=1).tolist(),
              "nms_equal": True}
    if kind == "maskrcnn":
        # Mask R-CNN clips its boxes; SSD's decode is unclipped, as in JAX
        require(bool(((boxes >= 0) & (boxes <= 1)).all()),
                f"{name}: boxes outside [0, 1]")
        require(_all_finite(out["mask_logits"]), f"{name}: mask logits")
        feat = out["feature"].permute(0, 3, 1, 2)
        rois = out["proposals"] * out["feature"].shape[1]
        errs, routes = {}, {}
        for P in (cfg.roi_pool, cfg.mask_pool):
            kw = {"pooled_size": P, "sampling_ratio": 1,
                  "spatial_scale": 1.0}
            D.LAST_ROI_ROUTE = None
            got = D.roi_align_batched(feat, rois, **kw)
            routes[f"pooled_{P}"] = D.LAST_ROI_ROUTE
            e = roi_errors(got, D.roi_align_reference_batched(
                feat, rois, **kw))
            require(e["within"] and e["finite"],
                    f"{name}: pooled {P}x{P} differ from the plain "
                    f"ROIAlign {e}")
            errs[f"pooled_{P}"] = e["max_abs_err"]
        result["roi_align_max_abs_err"] = errs
        # the same map and rois as the path's two launches
        result["roi_align_route"] = routes
        require(all(r == ("vector" if on_card else None)
                    for r in routes.values()),
                f"{name}: ROIAlign took the routes {routes}, expected the "
                "vector route on the card")
    emit("detect", **result)
    del params, out
    if on_card:
        torch.cuda.empty_cache()
    return result


# -------------------------------------------------------------------- main --

def main() -> int:
    import torch

    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke runs on the "
              "card", file=sys.stderr)
        return 1
    from cloudtik_tpu_torch.ops import _kernels
    from cloudtik_tpu_torch.ops import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("device", name=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = _kernels.build_all()
    ptxas = ptxas_report(_kernels.build_logs())
    emit("build", seconds=time.perf_counter() - t0, built=sorted(built),
         ptxas=ptxas)
    for name in NO_SPILL:
        row = next((r for r in ptxas if r["kernel"] == name), None)
        require(row is not None and row["spill_stores"] == 0,
                f"{name} spills or is missing from the build log: {row}")

    kernel = phase_kernel()
    kernel_bwd = phase_kernel_bwd()
    kernel_det = phase_kernel_det()

    # ---- the inference path: counts zeroed just before, read just after --
    _zero_launch_counts()
    cfg, params, tokens, logits = forward_main()
    forward_launches = FA.LAUNCHES
    phase_serve()
    inference = _launch_counts()
    require(forward_launches == cfg.n_layers,
            f"forward launched the flash kernel {forward_launches} times, "
            f"expected {cfg.n_layers}")
    require(inference["flash_fwd"] >= 1,
            "the inference path never launched the flash kernel")

    phase_forward(cfg, params, tokens, logits, forward_launches)
    del params, logits
    torch.cuda.empty_cache()

    # ---- the engine path: counts zeroed just before, read just after ----
    # its attention is the reference's einsums (no Pallas kernel there)
    _zero_launch_counts()
    _zero_det_launch_counts()
    phase_engine(nvidia_smi=smi)
    engine_launches = {**_launch_counts(), **_det_launch_counts()}
    emit("engine_path", launches=engine_launches)
    require(not any(engine_launches.values()),
            f"the engine path launched {engine_launches}, expected none")

    # ---- the spec, lora, disagg and fabric paths, counts zeroed just
    # before each and read just after: the verify and the draft are
    # `forward_step`'s einsums, the LoRA delta is `gathered_delta`'s and
    # migration's gather and scatter are indexing, as in the reference ----
    for name, phase in (("spec", phase_spec), ("lora", phase_lora),
                        ("disagg", phase_disagg), ("fabric", phase_fabric)):
        _zero_launch_counts()
        _zero_det_launch_counts()
        phase(nvidia_smi=smi)
        path_launches = {**_launch_counts(), **_det_launch_counts()}
        emit(f"{name}_path", launches=path_launches)
        require(not any(path_launches.values()),
                f"the {name} path launched {path_launches}, expected none")

    # ---- the training path (counts zeroed and read inside) ----
    train = phase_train()
    per_step = train["launches_per_step"]
    require(per_step == {"flash_fwd": cfg.n_layers,
                         "flash_bwd_dq": cfg.n_layers,
                         "flash_bwd_dkv": cfg.n_layers},
            f"train step launches {per_step}, expected {cfg.n_layers} of "
            "each kernel (save_attn must never re-run the forward)")
    torch.cuda.empty_cache()

    # ---- the checkpoint path (counts zeroed and read inside, around the
    # steps resumed past the torn checkpoint) ----
    checkpoint = phase_checkpoint()
    per_step = checkpoint["launches_per_step"]
    require(per_step == {"flash_fwd": cfg.n_layers,
                         "flash_bwd_dq": cfg.n_layers,
                         "flash_bwd_dkv": cfg.n_layers},
            f"resumed train step launches {per_step}, expected "
            f"{cfg.n_layers} of each kernel")
    torch.cuda.empty_cache()
    phase_train_grads()
    torch.cuda.empty_cache()

    # ---- LoRA training (counts zeroed and read inside, around the
    # measured steps), then the trained adapter served ----
    lora_train = phase_lora_train(nvidia_smi=smi)
    per_step = lora_train["launches_per_step"]
    n = lora_train["n_layers"]
    require(per_step == {"flash_fwd": n, "flash_bwd_dq": n,
                         "flash_bwd_dkv": n},
            f"lora_train step launches {per_step}, expected {n} of each "
            "kernel")

    # ---- BERT-Large pretraining (counts zeroed and read inside) ----
    bert = phase_bert(nvidia_smi=smi)
    per_step = bert["launches_per_step"]
    n = bert["n_layers"]
    require(per_step == {"flash_fwd": n, "flash_bwd_dq": n,
                         "flash_bwd_dkv": n},
            f"bert step launches {per_step}, expected {n} of each kernel")
    phase_bert_grads()
    torch.cuda.empty_cache()
    phase_optim(nvidia_smi=smi)
    torch.cuda.empty_cache()

    # ---- the detection path (counts zeroed and read inside) ----
    detect = {"maskrcnn": phase_detect("maskrcnn", "maskrcnn_resnet50"),
              "ssd": phase_detect("ssd", "ssd_resnet34"),
              "ssd1200": phase_detect("ssd", "ssd_resnet34",
                                      image_size=1200)}
    require(detect["ssd1200"]["nms_boxes_per_image"] == SSD1200_ANCHORS,
            f"ssd_resnet34 at 1200 gave NMS "
            f"{detect['ssd1200']['nms_boxes_per_image']} boxes an image")
    for model, per_call in (("maskrcnn", {"nms": 1, "roi_align": 2}),
                            ("ssd", {"nms": 1, "roi_align": 0}),
                            ("ssd1200", {"nms": 1, "roi_align": 0})):
        r = detect[model]
        want = {k: n * r["measured_calls"] for k, n in per_call.items()}
        require(r["launches"] == want,
                f"{r['model']} at {r['image_size']} detect launches "
                f"{r['launches']}, expected {want} ({per_call} per call)")
    det_launches = {k: sum(r["launches"][k] for r in detect.values())
                    for k in ("nms", "roi_align")}

    main_case = kernel[ATTN_CASES[0].name]
    train_case = kernel_bwd[BWD_CASES[0].name]
    launches = {k: inference[k] + train["launches"][k]
                + checkpoint["launches"][k] + lora_train["launches"][k]
                + bert["launches"][k] for k in inference}

    def bwd_err(grads):
        return max(r["errors"][g]["max_abs"] for r in kernel_bwd.values()
                   for g in grads)

    summary = {"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "cloudtik_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "cloudtik_tpu/ops/flash_attention.py:54",
        "launches": launches["flash_fwd"],
        "max_abs_err": max(
            [r["o_max_abs_err"] for r in kernel.values()]
            + [r["fwd_errors"]["o_max_abs_err"]
               for r in kernel_bwd.values()]),
        "ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "cloudtik_tpu_torch/csrc/flash_bwd.cu",
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": bwd_err(grads),
        "ms": train_case[part]["kernel_ms"],
        "plain_ms": train_case["plain_ms"],
        "bound_ms": train_case[part]["bound_ms"],
        "bound_by": train_case[part]["bound_by"],
        "library_ms": train_case["library_ms"],
    } for name, part, grads, replaces in (
        ("flash_bwd_dq", "dq", ("dq",),
         "cloudtik_tpu/ops/flash_attention.py:150"),
        ("flash_bwd_dkv", "dkv", ("dk", "dv"),
         "cloudtik_tpu/ops/flash_attention.py:191"))]}
    # B4 at SSD's shape (the larger of the two detect shapes at the preset
    # sizes), with every detect shape beside it; B5 as one Mask R-CNN call
    # runs it, the 7x7 and the 14x14 launch together
    nms_main = kernel_det["nms"][NMS_CASES[1].name]
    roi_main = [kernel_det["roi_align"][c.name] for c in ROI_CASES[:2]]
    summary["kernels"] += [{
        "name": "nms",
        "route": "cuda",
        "source": "cloudtik_tpu_torch/csrc/nms.cu",
        "replaces": "cloudtik_tpu/ops/detection.py:100",
        "launches": det_launches["nms"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in kernel_det["nms"].values()),
        "ms": nms_main["kernel_ms"],
        "plain_ms": nms_main["plain_ms"],
        "bound_ms": nms_main["bound_ms"],
        "bound_by": nms_main["bound_by"],
        "library_ms": None,
        "at": {n: {k: kernel_det["nms"][n][k] for k in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "kept",
            "reached", "reference_steps_bound_ms")}
            for n in NMS_DETECT_SHAPES},
    }, {
        "name": "roi_align",
        "route": "cuda",
        "source": "cloudtik_tpu_torch/csrc/roi_align.cu",
        "replaces": "cloudtik_tpu/ops/detection.py:203",
        "launches": det_launches["roi_align"],
        "max_abs_err": max(
            [r["max_abs_err"] for r in kernel_det["roi_align"].values()]
            + list(detect["maskrcnn"]["roi_align_max_abs_err"].values())),
        "ms": sum(r["kernel_ms"] for r in roi_main),
        "plain_ms": sum(r["plain_ms"] for r in roi_main),
        "bound_ms": sum(r["bound_ms"] for r in roi_main),
        "bound_by": "bytes",
        "library_ms": None,
    }]
    require(all(r["bound_by"] == "bytes" for r in roi_main),
            "roi_align's main shapes are not bound by bytes")
    emit("total", seconds=time.perf_counter() - t_script)
    print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
