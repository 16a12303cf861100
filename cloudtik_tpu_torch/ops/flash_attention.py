"""Flash attention, forward, for Hopper: a hand-written CUDA kernel.

Counterpart of `cloudtik_tpu/ops/flash_attention.py`.  The forward kernel
(`csrc/flash_fwd.cu`) replaces the Pallas `_fwd_kernel`: FlashAttention-2
online softmax with Q/K/V tiles in shared memory and both products on the
tensor cores, f32 accumulation, outputs `o` (q's dtype) and
`lse = m + log(l)` ([B, H, S, 1], f32).

Layout: q [B, H, S, D], k/v [B, Hkv, Skv, D]; GQA reads kv head
h // (H // Hkv) with no repeated K/V.  The causal mask uses ABSOLUTE
positions (q_pos >= kv_pos), exactly as the TPU kernel does; it agrees with
`ops/attention.reference_attention` (diagonal-aligned) only when S == Skv.

`flash_attention_fwd` runs the kernel on a CUDA tensor and the plain
version (`flash_attention_reference`) on a CPU tensor; on a CUDA tensor it
launches or raises, and never falls back.  The backward kernels
(`_dq_kernel`, `_dkv_kernel`) come with the training slice: until then a
call that needs a gradient raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

DEFAULT_BLOCK = 512
_NEG_INF = -1e30

# Launches of the CUDA kernel in this process (the wrapper adds one per
# launch and nowhere else), so a run can show its path went through it.
LAUNCHES = 0

_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}
_HEAD_DIMS = (64, 128)


def _check_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, S, D] / [B, Hkv, Skv, D]")
    if k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(
            f"num_heads {q.shape[1]} must be divisible by num_kv_heads "
            f"{k.shape[1]}")


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (o, lse) as the kernel defines
    them.  Scores in f32, absolute-position causal mask at -1e30, p cast to
    v's dtype before the P.V product (f32 accumulate), l == 0 guarded to 1.
    """
    _check_heads(q, k, v)
    B, H, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = H // Hkv
    if sm_scale is None:
        sm_scale = D ** -0.5
    qg = q.reshape(B, Hkv, group, S, D).float()
    s = torch.einsum("bhgsd,bhtd->bhgst", qg, k.float()) * sm_scale
    if causal:
        q_pos = torch.arange(S, device=q.device)[:, None]
        kv_pos = torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(q_pos >= kv_pos, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    acc = torch.einsum("bhgst,bhtd->bhgsd", p.to(v.dtype).float(), v.float())
    o = (acc / l_safe).to(q.dtype).reshape(B, H, S, D)
    lse = (m + torch.log(l_safe)).reshape(B, H, S, 1)
    return o, lse


def _kernel_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, sm_scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/flash_fwd.cu on CUDA tensors; raise on what it does not
    take."""
    global LAUNCHES
    from cloudtik_tpu_torch.ops import _kernels

    if not (k.is_cuda and v.is_cuda and k.device == q.device == v.device):
        raise ValueError("q, k, v must be on the same CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash kernel takes bf16/fp16 q, k, v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    D = q.shape[3]
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {_HEAD_DIMS}, "
                         f"got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # 16-byte vector loads: contiguous head dim, rows 16-byte aligned
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"flash kernel needs {name} with a contiguous last dim and "
                f"16-byte aligned rows, got strides {t.stride()}")
    B, H, S, _ = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)      # keeps q's (strided) layout
    lse = torch.empty((B, H, S, 1), device=q.device, dtype=torch.float32)

    def strides(t: torch.Tensor):
        return (ctypes.c_longlong * 3)(*t.stride()[:3])

    lib = _kernels.library("flash_fwd")
    err = lib.tik_flash_fwd(
        _DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), B, H, Hkv, S, Skv, strides(q),
        strides(k), strides(v), strides(o), float(sm_scale), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check(lib, err, "flash_fwd launch")
    LAUNCHES += 1
    return o, lse


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) from the CUDA kernel for CUDA tensors, from the plain
    version for CPU tensors; any other device raises."""
    _check_heads(q, k, v)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        return _kernel_fwd(q, k, v, causal, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         sm_scale=sm_scale)
    raise ValueError(f"no flash attention for device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """(o, lse) with lse a non-differentiable statistic, as the JAX
    custom_vjp returns it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                     sm_scale=sm_scale)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        raise NotImplementedError(
            "flash attention backward (_dq_kernel / _dkv_kernel) is not "
            "ported yet: it comes with the training slice")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    block_q: int = DEFAULT_BLOCK,
    block_k: int = DEFAULT_BLOCK,
    return_lse: bool = False,
):
    """Flash attention.  q [B,H,S,D], k/v [B,Hkv,Skv,D].

    With return_lse=True also returns the per-row logsumexp [B, H, S, 1]
    (f32).  `block_q`/`block_k` keep the JAX signature and are ignored: the
    CUDA kernel tiles by 64 rows and takes any S and Skv.
    """
    del block_q, block_k
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if needs_grad and q.is_cuda:
        raise NotImplementedError(
            "flash attention on CUDA has no backward yet (_dq_kernel / "
            "_dkv_kernel come with the training slice); call it under "
            "torch.no_grad() or use implementation='reference'")
    o, lse = _FlashAttention.apply(q, k, v, causal, float(sm_scale))
    return (o, lse) if return_lse else o
