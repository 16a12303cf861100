"""Flash attention for Hopper: hand-written CUDA kernels, forward and backward.

Counterpart of `cloudtik_tpu/ops/flash_attention.py`.  The forward kernel
(`csrc/flash_fwd.cu`) replaces the Pallas `_fwd_kernel`: FlashAttention-2
online softmax with both products on the tensor cores (`mma.sync`) and the
scores, probabilities and output accumulator in registers, f32
accumulation, outputs `o` (q's dtype) and `lse = m + log(l)`
([B, H, S, 1], f32).  The backward kernels
(`csrc/flash_bwd.cu`) replace `_dq_kernel` and `_dkv_kernel`: both
recompute p = exp(s - lse) from the saved (q, k, lse), and dk/dv come out
per kv head.

Layout: q [B, H, S, D], k/v [B, Hkv, Skv, D]; GQA reads kv head
h // (H // Hkv) with no repeated K/V.  The causal mask uses ABSOLUTE
positions (q_pos >= kv_pos), exactly as the TPU kernel does; it agrees with
`ops/attention.reference_attention` (diagonal-aligned) only when S == Skv.

`flash_attention_fwd` / `flash_attention_bwd` run the kernels on a CUDA
tensor and the plain versions (`flash_attention_reference`,
`flash_attention_bwd_reference`) on a CPU tensor; on a CUDA tensor they
launch or raise, and never fall back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

DEFAULT_BLOCK = 512
_NEG_INF = -1e30

# Launches of each CUDA kernel in this process (its wrapper adds one per
# launch and nowhere else), so a run can show its path went through them:
# the forward, the dq and the dk/dv kernel.
LAUNCHES = 0
LAUNCHES_DQ = 0
LAUNCHES_DKV = 0

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


def _causal_mask(s: torch.Tensor, S: int, Skv: int) -> torch.Tensor:
    """s [..., S, Skv] with entries q_pos < kv_pos (absolute positions) set
    to -1e30, as the TPU kernels mask them."""
    q_pos = torch.arange(S, device=s.device)[:, None]
    kv_pos = torch.arange(Skv, device=s.device)[None, :]
    return torch.where(q_pos >= kv_pos, s, torch.full_like(s, _NEG_INF))


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
        s = _causal_mask(s, S, Skv)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    acc = torch.einsum("bhgst,bhtd->bhgsd", p.to(v.dtype).float(), v.float())
    o = (acc / l_safe).to(q.dtype).reshape(B, H, S, D)
    lse = (m + torch.log(l_safe)).reshape(B, H, S, 1)
    return o, lse


def _bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(do * o) in f32 [B, H, S, 1], outside the kernels as XLA
    computes it."""
    return (do.float() * o.float()).sum(dim=-1, keepdim=True)


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *,
    causal: bool = True, sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels: (dq, dk, dv) as `_bwd`,
    `_dq_kernel` and `_dkv_kernel` define them.  delta = rowsum(do * o) in
    f32; scores in f32 with the absolute-position causal mask at -1e30;
    p = exp(s - lse); ds = p * (dp - delta) * sm_scale; ds is cast to k's
    dtype before ds.k and to q's before ds^T.q, p to do's before p^T.do;
    f32 accumulation, dk/dv summed over each kv head's group; outputs in
    the inputs' dtypes.
    """
    _check_heads(q, k, v)
    B, H, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = H // Hkv
    if sm_scale is None:
        sm_scale = D ** -0.5

    def grouped(t: torch.Tensor) -> torch.Tensor:   # -> [B, Hkv, g, S, X]
        return t.reshape(B, Hkv, group, S, t.shape[-1])

    delta = _bwd_delta(o, do)
    qg, dog = grouped(q).float(), grouped(do).float()
    s = torch.einsum("bhgsd,bhtd->bhgst", qg, k.float()) * sm_scale
    if causal:
        s = _causal_mask(s, S, Skv)
    p = torch.exp(s - grouped(lse))
    dp = torch.einsum("bhgsd,bhtd->bhgst", dog, v.float())
    ds = p * (dp - grouped(delta)) * sm_scale
    dq = torch.einsum("bhgst,bhtd->bhgsd", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bhgst,bhgsd->bhtd", ds.to(q.dtype).float(), qg)
    dv = torch.einsum("bhgst,bhgsd->bhtd", p.to(do.dtype).float(), dog)
    return (dq.reshape(B, H, S, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _kernel_layout(t: torch.Tensor) -> bool:
    """16-byte vector loads: contiguous head dim, rows 16-byte aligned."""
    return (t.stride(3) == 1 and not any(s % 8 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _check_kernel_inputs(q: torch.Tensor, **others: torch.Tensor) -> None:
    """Raise on what the CUDA kernels do not take: every tensor on q's CUDA
    device, bf16/fp16 of q's dtype, head_dim 64 or 128, `_kernel_layout`."""
    tensors = {"q": q, **others}
    names = ", ".join(tensors)
    if not all(t.is_cuda and t.device == q.device for t in tensors.values()):
        raise ValueError(f"{names} must be on the same CUDA device")
    if q.dtype not in _DTYPE_CODES \
            or any(t.dtype != q.dtype for t in tensors.values()):
        raise ValueError(
            f"flash kernel takes bf16/fp16 {names} of one dtype, got "
            f"{[str(t.dtype) for t in tensors.values()]}")
    D = q.shape[3]
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {_HEAD_DIMS}, "
                         f"got {D}")
    for name, t in tensors.items():
        if not _kernel_layout(t):
            raise ValueError(
                f"flash kernel needs {name} with a contiguous last dim and "
                f"16-byte aligned rows, got strides {t.stride()}")


def _strides(t: torch.Tensor):
    """Batch, head and sequence strides for a C entry."""
    return (ctypes.c_longlong * 3)(*t.stride()[:3])


def _kernel_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, sm_scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/flash_fwd.cu on CUDA tensors; raise on what it does not
    take."""
    global LAUNCHES
    from cloudtik_tpu_torch.ops import _kernels

    _check_kernel_inputs(q, k=k, v=v)
    B, H, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)      # keeps q's (strided) layout
    lse = torch.empty((B, H, S, 1), device=q.device, dtype=torch.float32)
    lib = _kernels.library("flash_fwd")
    err = lib.tik_flash_fwd(
        _DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), B, H, Hkv, S, Skv, _strides(q),
        _strides(k), _strides(v), _strides(o), float(sm_scale), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check(lib, err, "flash_fwd launch")
    LAUNCHES += 1
    return o, lse


def _launch_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
               causal: bool, sm_scale: float) -> torch.Tensor:
    """Launch the dq kernel of csrc/flash_bwd.cu on inputs `_kernel_bwd`
    has checked."""
    global LAUNCHES_DQ
    from cloudtik_tpu_torch.ops import _kernels

    B, H, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)     # q's (strided) layout
    lib = _kernels.library("flash_bwd")
    err = lib.tik_flash_bwd_dq(
        _DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H,
        Hkv, S, Skv, _strides(q), _strides(k), _strides(v), _strides(do),
        _strides(dq), float(sm_scale), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check(lib, err, "flash_bwd_dq launch")
    LAUNCHES_DQ += 1
    return dq


def _launch_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                causal: bool, sm_scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel of csrc/flash_bwd.cu on inputs `_kernel_bwd`
    has checked."""
    global LAUNCHES_DKV
    from cloudtik_tpu_torch.ops import _kernels

    B, H, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _kernels.library("flash_bwd")
    err = lib.tik_flash_bwd_dkv(
        _DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, H, Hkv, S, Skv, _strides(q), _strides(k),
        _strides(v), _strides(do), _strides(dk), _strides(dv),
        float(sm_scale), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check(lib, err, "flash_bwd_dkv launch")
    LAUNCHES_DKV += 1
    return dk, dv


def _kernel_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                causal: bool, sm_scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the dq and dk/dv kernels of csrc/flash_bwd.cu on CUDA
    tensors; raise on what they do not take.  A `do` outside the kernels'
    layout (the expanded gradient of `o.sum()`, say) is copied once; the
    model's path hands in o's own layout and copies nothing."""
    if not _kernel_layout(do):
        do = do.contiguous()
    _check_kernel_inputs(q, k=k, v=v, do=do)
    B, H, S, _ = q.shape
    if tuple(lse.shape) != (B, H, S, 1) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be a contiguous f32 [B, H, S, 1] tensor "
                         f"on q's device, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    delta = _bwd_delta(o, do)
    dq = _launch_dq(q, k, v, do, lse, delta, causal, sm_scale)
    dk, dv = _launch_dkv(q, k, v, do, lse, delta, causal, sm_scale)
    return dq, dk, dv


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


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *,
    causal: bool = True, sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the CUDA kernels for CUDA tensors, from the plain
    version for CPU tensors; any other device raises."""
    _check_heads(q, k, v)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        return _kernel_bwd(q, k, v, o, lse, do, causal, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do,
                                             causal=causal, sm_scale=sm_scale)
    raise ValueError(f"no flash attention for device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """(o, lse) with lse a non-differentiable statistic, as the JAX
    custom_vjp returns it.  Saves (q, k, v, o, lse), so the backward pass
    runs the two backward kernels and never the forward one."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                     sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        del dlse   # lse is a statistic: its cotangent is ignored, as in JAX
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal,
                                         sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


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
    """Differentiable flash attention.  q [B,H,S,D], k/v [B,Hkv,Skv,D].

    With return_lse=True also returns the per-row logsumexp [B, H, S, 1]
    (f32), a statistic with no gradient.  `block_q`/`block_k` keep the JAX
    signature and are ignored: the CUDA kernels choose their own tiles (the
    forward 128 q rows by 64 kv rows, dk/dv 128 kv rows by 64 q rows, dq 64
    by 64) and take any S and Skv.
    """
    del block_q, block_k
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    o, lse = _FlashAttention.apply(q, k, v, causal, float(sm_scale))
    return (o, lse) if return_lse else o
