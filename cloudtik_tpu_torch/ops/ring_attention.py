"""Ring attention: sequence parallelism over the `seq` mesh axis.

Counterpart of `cloudtik_tpu/ops/ring_attention.py`.  Each rank holds its
S/n slice of q, k and v; k and v rotate around the `seq` group (rank i
receives from i+1 and sends to i-1, by `collectives.shift_many`: P2P, or
an all-gather under gloo on the card), and each step
merges one block with the online-softmax recurrence, in f32, on the
grouped-query view [B, Hkv, G, S, D].  The causal mask compares global
positions (i*S + arange); `where(mask, p, 0)` keeps a fully masked block
from adding exp(0) = 1, and the output divides by max(l, 1e-30), as the
reference does.  After n steps every block is home again.

torch's P2P ops have no autograd, so the ring is a `torch.autograd.Function`
whose backward runs the ring again: it recomputes p from the saved row
max m and sum l, and the dk/dv accumulators travel with their k/v blocks,
so each block's gradient arrives home after n steps (the reference gets
the same from differentiating `ppermute`).  The reference's ring is
einsums, not a Pallas kernel, and so is this one: no flash kernel runs
inside it.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from cloudtik_tpu_torch.parallel import collectives, sharding

NEG_INF = -1e30


def _ring_index(group) -> tuple:
    """(rank along the ring, n)."""
    ranks = dist.get_process_group_ranks(group)
    return ranks.index(dist.get_rank()), len(ranks)


def _rotate(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """One step around the ring: each tensor goes to rank i - 1 and its
    neighbour's comes from i + 1 (`collectives.shift_many`, offset -1)."""
    return collectives.shift_many(tensors, group, -1)


def _mask(i: int, j: int, S: int, device) -> torch.Tensor:
    q_pos = i * S + torch.arange(S, device=device)
    kv_pos = j * S + torch.arange(S, device=device)
    return q_pos[:, None] >= kv_pos[None, :]


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, sm_scale):
        i, n = _ring_index(group)
        B, H, S, D = q.shape
        Hkv = k.shape[1]
        G = H // Hkv
        qf = (q.float() * sm_scale).reshape(B, Hkv, G, S, D)
        acc = q.new_zeros((B, Hkv, G, S, D), dtype=torch.float32)
        m = q.new_full((B, Hkv, G, S), NEG_INF, dtype=torch.float32)
        l = q.new_zeros((B, Hkv, G, S), dtype=torch.float32)
        k_c, v_c = k, v
        for s in range(n):
            j = (i + s) % n
            scores = torch.einsum("bhgsd,bhtd->bhgst", qf, k_c.float())
            if causal:
                mask = _mask(i, j, S, q.device)
                scores = torch.where(mask, scores,
                                     torch.full_like(scores, NEG_INF))
            m_new = torch.maximum(m, scores.amax(-1))
            p = torch.exp(scores - m_new[..., None])
            if causal:
                p = torch.where(mask, p, torch.zeros_like(p))
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgst,bhtd->bhgsd", p, v_c.float())
            m = m_new
            k_c, v_c = _rotate([k_c, v_c], group)
        l = torch.clamp(l, min=1e-30)
        out = acc / l[..., None]
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.group, ctx.causal, ctx.sm_scale = group, causal, sm_scale
        return out.reshape(B, H, S, D).to(q.dtype)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, m, l = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.sm_scale
        i, n = _ring_index(group)
        B, H, S, D = q.shape
        Hkv = k.shape[1]
        G = H // Hkv
        qf = (q.float() * scale).reshape(B, Hkv, G, S, D)
        do = d_out.float().reshape(B, Hkv, G, S, D)
        delta = (do * out).sum(-1)                           # [B,Hkv,G,S]
        dq = torch.zeros_like(qf)
        k_c, v_c = k, v
        dk_c = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_c = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for s in range(n):
            j = (i + s) % n
            kf, vf = k_c.float(), v_c.float()
            scores = torch.einsum("bhgsd,bhtd->bhgst", qf, kf)
            p = torch.exp(scores - m[..., None]) / l[..., None]
            if causal:
                p = torch.where(_mask(i, j, S, q.device), p,
                                torch.zeros_like(p))
            dv_c = dv_c + torch.einsum("bhgst,bhgsd->bhtd", p, do)
            dp = torch.einsum("bhgsd,bhtd->bhgst", do, vf)
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhgst,bhtd->bhgsd", ds, kf)
            dk_c = dk_c + torch.einsum("bhgst,bhgsd->bhtd", ds, qf)
            k_c, v_c, dk_c, dv_c = _rotate([k_c, v_c, dk_c, dv_c], group)
        dq = (dq * scale).reshape(B, H, S, D)
        return (dq.to(q.dtype), dk_c.to(k.dtype), dv_c.to(v.dtype), None,
                None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, *, causal: bool = True,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Exact blockwise attention over a ring of sequence shards.

    q: [B, H, S_loc, D]; k, v: [B, Hkv, S_loc, D], this rank's slices of
    the sequence; `group` is the ring (the `seq` group; rank order is ring
    order).  Returns [B, H, S_loc, D] in q's dtype."""
    H, Hkv = q.shape[1], k.shape[1]
    if H % Hkv:
        raise ValueError(f"n_heads {H} not divisible by n_kv_heads {Hkv}")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _Ring.apply(q, k, v, group, causal, sm_scale)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           sm_scale: Optional[float] = None
                           ) -> torch.Tensor:
    """Ring attention over the ambient mesh's `seq` axis (parallel/
    sharding.py `use_mesh`), for [B, H, S_loc, D] slices.  Without a mesh
    whose `seq` axis is split there is no ring, and it raises."""
    group = sharding.axis_group("seq")
    if group is None:
        raise ValueError(
            "ring attention needs an ambient mesh with a seq axis of size "
            "> 1 (parallel.sharding.use_mesh)")
    return ring_attention(q, k, v, group, causal=causal, sm_scale=sm_scale)
