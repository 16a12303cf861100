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
  forward  the inference path, part 1: tpu_1b `forward` at B=4, S=2048 in
           bf16, held against the same forward on the reference attention
  train    the training path: `Trainer.fit` on tpu_1b at full width and
           depth, B=8, S=2048, bf16 params and moments, save_attn remat: 2
           warm-up steps, then 5 measured steps with 16 launches of each
           kernel per step; ms/step, tokens/s, MFU, peak memory
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
  detect   the detection path: `detect` of maskrcnn_resnet50 at B=8 x 512
           (2 ROIAlign launches and 1 NMS launch per call) and of
           ssd_resnet34 at B=8 x 300 and at B=8 x 1200 (1 NMS launch over
           3,000 or 45,384 anchors per call), bf16: ms per call, images/s,
           peak memory; outputs checked,
           each call's NMS and pooling held against the plain versions, and
           Mask R-CNN's map pooled on ROIAlign's vector route

Launch counts are zeroed just before each path (forward then serve; the
measured train steps; the measured detect calls of each model) and read
just after it.  The last lines are the
`nvidia-smi` name/power line, a `{"kernels": [...]}` summary and
`{"ok": true, "device": ...}`.
"""

from __future__ import annotations

import dataclasses
import json
import math
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
    data = synthetic_lm_batches(B, S, cfg.vocab_size)
    t0 = time.perf_counter()
    trainer.fit(data, warmup)
    warmup_s = time.perf_counter() - t0
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # ---- the training path: counts zeroed just before, read just after --
    _zero_launch_counts()
    t0 = time.perf_counter()
    out = trainer.fit(data, steps)     # ends in float() of the metrics
    wall_s = time.perf_counter() - t0
    launches = _launch_counts()
    entry = out["history"][-1]
    result = {
        "model": model, "batch": B, "seq": S, "param_dtype": "bfloat16",
        "moment_dtype": "bfloat16", "remat_policy": cfg.remat_policy,
        "warmup_steps": warmup, "measured_steps": steps,
        "warmup_s": warmup_s, "ms_per_step": wall_s / steps * 1e3,
        "tokens_per_s": entry["tokens_per_sec"], "mfu": entry.get("mfu"),
        "flops_per_token": cfg.flops_per_token(),
        "loss": entry["loss"], "grad_norm": entry["grad_norm"],
        "launches": launches,
        "launches_per_step": {k: n / steps for k, n in launches.items()},
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if on_card else None),
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

    # ---- the training path (counts zeroed and read inside) ----
    train = phase_train()
    per_step = train["launches_per_step"]
    require(per_step == {"flash_fwd": cfg.n_layers,
                         "flash_bwd_dq": cfg.n_layers,
                         "flash_bwd_dkv": cfg.n_layers},
            f"train step launches {per_step}, expected {cfg.n_layers} of "
            "each kernel (save_attn must never re-run the forward)")
    torch.cuda.empty_cache()
    phase_train_grads()
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
    launches = {k: inference[k] + train["launches"][k] for k in inference}

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
    print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
