"""Paged decode attention: one token a lane against a block-paged KV pool.

The decode engine's attention (serve/engine.py `_decode_layer`).  No
Pallas kernel stands behind it: the reference (`cloudtik_tpu/serve/
engine.py`) gathers each lane's block table and runs XLA einsums, and
`paged_attention_reference` below is that formulation in PyTorch, the CPU
path.  On the card `paged_attention` launches the hand-written kernel of
`csrc/paged_attn.cu` instead, which appends the new K/V in place and reads
each lane's K/V through its block table only up to the lane's length, once
per KV head.

Shapes: q [B, 1, H, Dh]; the new k, v [B, 1, Hkv, Dh]; one layer's pool
planes ck, cv [N, bs, Hkv, Dh] (written in place); tables [B, M] physical
block ids; lengths [B] int64, each lane's absolute position (where its new
K/V goes); active [B] bool.  Lane b attends positions 0..lengths[b].  The
output [B, 1, H, Dh] is in q's dtype; an inactive lane's is discarded by
the caller (the kernel gives 0, the plain version finite garbage).  The
kernel takes bf16 (the engine's dtype on the card), head_dim 64 or 128 and
GQA groups of 1, 2, 4 or 8, and raises on anything else.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from cloudtik_tpu_torch.models.generate import _NEG
from cloudtik_tpu_torch.serve import kvcache

# Launches of the CUDA kernels in this process (the wrapper adds one per
# kernel launch and nowhere else: one a call with a single split, two with
# the merge), so a run can show its path went through them.
LAUNCHES = 0

_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)
# positions a CTA takes: a multiple of SPLIT_QUANTUM, at most MAX_SPLIT
# (csrc/paged_attn.cu's kMaxSplit); enough splits that a batch whose lanes
# are all full gives about CTAS_PER_SM CTAs an SM
MAX_SPLIT = 512
SPLIT_QUANTUM = 64
CTAS_PER_SM = 8


def paged_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, ck: torch.Tensor,
                              cv: torch.Tensor, tables: torch.Tensor,
                              lengths: torch.Tensor, active: torch.Tensor,
                              block_size: int) -> torch.Tensor:
    """The plain version: each lane scatters its new K/V at (table[length
    // bs], length % bs) and attends over its gathered table in f32.
    Inactive lanes all write block 0 at offset 0 (a duplicate index,
    harmless because block 0 is garbage); unallocated table slots gather
    the null block, finite garbage masked to exactly 0 by the softmax."""
    B = q.shape[0]
    M = tables.shape[1]
    bs = block_size
    rows = torch.arange(B, device=q.device)
    blk_idx = torch.clamp(lengths // bs, 0, M - 1)
    phys = torch.where(active, tables[rows, blk_idx], kvcache.NULL_BLOCK)
    off = torch.where(active, lengths % bs, 0)
    ck[phys, off] = k[:, 0].to(ck.dtype)
    cv[phys, off] = v[:, 0].to(cv.dtype)
    T = M * bs
    ck_seq = ck[tables].reshape(B, T, ck.shape[-2], ck.shape[-1])
    cv_seq = cv[tables].reshape(B, T, cv.shape[-2], cv.shape[-1])
    groups = q.shape[2] // ck_seq.shape[2]
    ck_h = ck_seq.repeat_interleave(groups, dim=2)
    cv_h = cv_seq.repeat_interleave(groups, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(),
                          ck_h.float()) * (q.shape[-1] ** -0.5)
    mask = (torch.arange(T, device=q.device)[None, None, None, :]
            <= lengths[:, None, None, None])
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs, cv_h.float()).to(q.dtype)


def split_plan(batch: int, kv_heads: int, capacity: int,
               sms: int) -> Tuple[int, int]:
    """(positions a CTA, number of splits) for `capacity` = M * bs
    positions a lane at most: enough splits that `batch` full lanes give
    about CTAS_PER_SM CTAs on each of `sms` SMs, each split a multiple of
    SPLIT_QUANTUM positions and at most MAX_SPLIT."""
    want = -(-CTAS_PER_SM * sms // (batch * kv_heads))
    per = -(-capacity // max(want, 1))
    per = min(max(-(-per // SPLIT_QUANTUM) * SPLIT_QUANTUM, SPLIT_QUANTUM),
              MAX_SPLIT)
    return per, -(-capacity // per)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_kernel_inputs(q, k, v, ck, cv, tables, lengths, active,
                         block_size: int) -> None:
    """Raise on what the CUDA kernel does not take."""
    tensors = {"q": q, "k": k, "v": v, "ck": ck, "cv": cv,
               "tables": tables, "lengths": lengths, "active": active}
    if not all(t.is_cuda and t.device == q.device for t in tensors.values()):
        raise ValueError("paged attention kernel needs every tensor on q's "
                         "CUDA device")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, ck, cv)):
        raise ValueError(
            "paged attention kernel takes bf16 q, k, v and pool planes, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}, {ck.dtype}, {cv.dtype}")
    if (tables.dtype, lengths.dtype, active.dtype) != (
            torch.int64, torch.int64, torch.bool):
        raise ValueError("paged attention kernel takes int64 tables and "
                         "lengths and a bool active mask")
    B, S, H, D = q.shape
    N, bs, Hkv, Dk = ck.shape
    if S != 1 or tuple(k.shape) != (B, 1, Hkv, D) or k.shape != v.shape \
            or ck.shape != cv.shape or Dk != D or bs != block_size \
            or tables.dim() != 2 or tables.shape[0] != B \
            or tuple(lengths.shape) != (B,) or tuple(active.shape) != (B,):
        raise ValueError(
            f"paged attention shapes: q {tuple(q.shape)}, k {tuple(k.shape)},"
            f" v {tuple(v.shape)}, pool {tuple(ck.shape)} / "
            f"{tuple(cv.shape)}, tables {tuple(tables.shape)}, lengths "
            f"{tuple(lengths.shape)}, active {tuple(active.shape)}, "
            f"block_size {block_size}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged attention kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {D}")
    if H % Hkv or H // Hkv not in _GROUPS:
        raise ValueError(f"paged attention kernel takes GQA groups "
                         f"{_GROUPS}, got {H} heads over {Hkv}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"paged attention kernel needs a contiguous "
                             f"{name}, got strides {t.stride()}")
    for name in ("q", "k", "v", "ck", "cv"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"paged attention kernel needs {name} 16-byte "
                             "aligned")


def _kernel(q, k, v, ck, cv, tables, lengths, active,
            block_size: int) -> torch.Tensor:
    """Launch csrc/paged_attn.cu on CUDA tensors; raise on what it does not
    take."""
    global LAUNCHES
    from cloudtik_tpu_torch.ops import _kernels

    _check_kernel_inputs(q, k, v, ck, cv, tables, lengths, active,
                         block_size)
    B, _, H, D = q.shape
    Hkv = ck.shape[2]
    M = tables.shape[1]
    split, n_splits = split_plan(B, Hkv, M * block_size,
                                 _sm_count(q.device))
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if n_splits > 1:
        part_acc = torch.empty((B, H, n_splits, D), device=q.device,
                               dtype=torch.float32)
        part_ml = torch.empty((B, H, n_splits, 2), device=q.device,
                              dtype=torch.float32)
    lib = _kernels.library("paged_attn")
    err = lib.tik_paged_attn(
        D, H // Hkv, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        ck.data_ptr(), cv.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), active.data_ptr(), out.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), B, H, Hkv, M,
        block_size, split, n_splits, float(D ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check(lib, err, "paged_attn launch")
    LAUNCHES += 1 if n_splits == 1 else 2
    return out


def paged_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    ck: torch.Tensor, cv: torch.Tensor, tables: torch.Tensor,
                    lengths: torch.Tensor, active: torch.Tensor,
                    block_size: int) -> torch.Tensor:
    """Append each active lane's k/v to the pool planes in place and return
    its attention output [B, 1, H, Dh]: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors; any other device raises."""
    if q.is_cuda:
        return _kernel(q, k, v, ck, cv, tables, lengths, active, block_size)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k, v, ck, cv, tables, lengths,
                                         active, block_size)
    raise ValueError(f"no paged attention for device {q.device}")
