"""Attention entry point: one call, best available implementation.

Counterpart of `cloudtik_tpu/ops/attention.py`.  Auto mode takes the ring
(ops/ring_attention.py) when the ambient mesh splits `seq`, else the Hopper
flash kernel (ops/flash_attention.py) where it applies and the plain
reference elsewhere.  Shapes follow [batch, num_heads, seq, head_dim]
("BHSD"); kv tensors may have fewer heads (num_kv_heads divides num_heads).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_KERNEL_DTYPES = (torch.bfloat16, torch.float16)
_KERNEL_HEAD_DIMS = (64, 128)


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention (materializes scores).

    q: [B, H, S, D]; k, v: [B, Hkv, Skv, D] with H % Hkv == 0.  The causal
    mask aligns diagonals when S and Skv differ (decode).  segment_ids:
    [B, S] ints; attention only within equal segments (packing).
    """
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if sm_scale is None:
        sm_scale = D ** -0.5
    if Hkv != H:
        group = H // Hkv
        qg = q.reshape(B, Hkv, group, S, D)
        scores = torch.einsum("bhgsd,bhtd->bhgst", qg, k) * sm_scale
    else:
        scores = torch.einsum("bhsd,bhtd->bhst", q, k) * sm_scale

    Skv = k.shape[2]
    mask = None
    if causal:
        q_pos = torch.arange(S, device=q.device)[:, None] + (Skv - S)
        kv_pos = torch.arange(Skv, device=q.device)[None, :]
        mask = q_pos >= kv_pos
    if segment_ids is not None:
        seg_mask = segment_ids[:, :, None] == segment_ids[:, None, :]
        seg_mask = seg_mask[:, None, :, :]  # [B, 1, S, Skv]
        mask = seg_mask if mask is None else (mask & seg_mask)
    if mask is not None:
        if scores.dim() == 5 and mask.dim() == 4:
            mask = mask[:, :, None]         # over the group axis
        scores = torch.where(
            mask, scores,
            torch.full_like(scores, torch.finfo(scores.dtype).min))

    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if Hkv != H:
        out = torch.einsum("bhgst,bhtd->bhgsd", probs, v)
        return out.reshape(B, H, S, D)
    return torch.einsum("bhst,bhtd->bhsd", probs, v)


def use_flash_kernel(device_type: str, dtype: torch.dtype,
                     q_shape: Sequence[int], kv_shape: Sequence[int],
                     causal: bool) -> bool:
    """Auto-dispatch rule: the CUDA kernel for bf16/fp16 on the card with
    head_dim 64 or 128, and for causal attention only when S == Skv (the
    kernel's mask uses absolute positions, the reference's is aligned on
    the Skv - S diagonal; they agree only there)."""
    S, D = q_shape[-2], q_shape[-1]
    Skv = kv_shape[-2]
    return (device_type == "cuda" and dtype in _KERNEL_DTYPES
            and D in _KERNEL_HEAD_DIMS and (not causal or S == Skv))


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    implementation: Optional[str] = None,
    return_residuals: bool = False,
):
    """Multi-head / grouped-query attention.

    implementation: None (auto), "flash" (the CUDA kernel, or its plain
    version on the CPU), "reference", "ring" (sequence-parallel over the
    ambient mesh's `seq` axis; it raises without one).  Auto picks ring
    whenever the ambient mesh splits `seq`.

    return_residuals=True returns (out, lse_or_None): the flash path's
    logsumexp (a statistic with no gradient), None on the reference path.

    Both paths are differentiable: "flash" through its autograd Function,
    whose backward runs the dq and dk/dv kernels on the card (their plain
    version on the CPU); "reference" through plain autograd.
    """
    impl = implementation
    if impl is None:
        from cloudtik_tpu_torch.parallel.sharding import mesh_axis_size

        if mesh_axis_size("seq") > 1:
            impl = "ring"
        else:
            impl = "flash" if use_flash_kernel(
                q.device.type, q.dtype, q.shape, k.shape, causal) \
                else "reference"
    if impl == "ring":
        from cloudtik_tpu_torch.ops.ring_attention import \
            ring_attention_sharded

        out = ring_attention_sharded(q, k, v, causal=causal,
                                     sm_scale=sm_scale)
        return (out, None) if return_residuals else out
    if impl == "flash":
        from cloudtik_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               return_lse=return_residuals)
    if impl != "reference":
        raise ValueError(f"unknown attention implementation {impl!r}")
    out = reference_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    return (out, None) if return_residuals else out
