"""The collectives the port issues, with the gradients each use needs.

GSPMD derives these from placements in the reference; torch runs one
program per rank, so the trainer and the model code call them explicitly
over the ambient mesh's axes (parallel/sharding.py `use_mesh`).  Each
autograd Function takes its process groups in the forward and keeps them,
so its backward never reads the ambient mesh.

* `reduce_sum`     forward: sum over the axes; backward: the identity.
                   The global loss and MoE's statistics: each rank
                   differentiates only its own tokens' share, and the
                   trainer sums the gradients over the batch axes.
* `copy_to`        forward: the identity; backward: sum over the axes.
                   The input of a region split over an axis (the experts
                   of one token on several `expert` ranks).
* `gather_dim`     forward: all-gather along one dimension; backward:
                   reduce-scatter (sum) back to the shard.  FSDP's
                   gather-on-use.
* `all_reduce`     a plain sum, no gradient (counts, gradient sync).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from cloudtik_tpu_torch.parallel import sharding


def groups_for(axes: Sequence[str]) -> Tuple:
    """The ambient mesh's process groups for `axes`, skipping axes that are
    absent or of size 1."""
    out = []
    for a in axes:
        g = sharding.axis_group(a)
        if g is not None:
            out.append(g)
    return tuple(out)


def _sum_over(x: torch.Tensor, groups: Tuple) -> torch.Tensor:
    x = x.clone()
    for g in groups:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g)
    return x


def all_reduce(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Sum of x over the ambient mesh's `axes` (no gradient)."""
    groups = groups_for(axes)
    return _sum_over(x.detach(), groups) if groups else x


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return _sum_over(x, groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.groups), None


def reduce_sum(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Sum over `axes` forward, identity backward (x itself when no axis
    is split)."""
    groups = groups_for(axes)
    return _ReduceSum.apply(x, groups) if groups else x


def copy_to(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Identity forward, sum over `axes` backward."""
    groups = groups_for(axes)
    return _CopyTo.apply(x, groups) if groups else x


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * moved.shape[0],) + tuple(moved.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def _scatter_sum(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    moved = g.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // n,) + tuple(moved.shape[1:]),
                      dtype=g.dtype, device=g.device)
    dist.reduce_scatter_tensor(out, moved, op=dist.ReduceOp.SUM,
                               group=group)
    return out.movedim(0, dim)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.dim, ctx.group), None, None


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather x's shards along `dim` over `group`; the gradient comes
    back reduce-scattered (summed) to the shard."""
    return _GatherDim.apply(x, dim, group)


def gather_full(x: torch.Tensor, dim: int, group: Optional[object]
                ) -> torch.Tensor:
    """All-gather without a gradient (checkpoints)."""
    return x if group is None else _gather(x.detach(), dim, group)
