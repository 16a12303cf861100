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
                   gather-on-use.  With `summed=False` the backward takes
                   this rank's slice of the cotangent instead: a leaf
                   gathered over an axis whose ranks read the same tokens
                   (tensor, pipe, expert) gets the same whole gradient on
                   each of them, which a sum would multiply.
* `all_reduce`     a plain sum (or max, min), no gradient (counts,
                   gradient sync, the split vocab's max and argmax).
* `batch_mean`     the mean over the global batch of a tensor of this
                   rank's rows: its sum through `reduce_sum` over the
                   global count (every family's loss and metrics).
* `gather_rows`    dimension 0 gathered over the batch axes in the order
                   `data.local_batch` cuts rows, the backward summed
                   (GraphSAGE's neighbours on other ranks).
* `shift_many`     each rank takes the tensors of the rank `offset`
                   places before it along a group, cyclically
                   (`lax.ppermute` with a cyclic perm), no gradient.  The
                   pipeline's stage-to-stage hand-off and the ring's
                   rotation; each writes out its own backward, in which
                   the cotangents take the opposite shift.

A shift runs on one of two routes, chosen from the group's backend and the
tensor's device before any call (never on a failure): point-to-point
(`batch_isend_irecv`) under NCCL and under gloo on CPU tensors, and an
`all_gather_into_tensor` over the group, each rank taking its source's
slot, under gloo on CUDA tensors, where gloo refuses point-to-point
(tools/probe_torch_gloo_cuda.py).  The gather moves n times the bytes.
Reductions run in the tensor's own dtype on every backend.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from cloudtik_tpu_torch.parallel import sharding
from cloudtik_tpu_torch.parallel.mesh import DATA_AXES


def groups_for(axes: Sequence[str]) -> Tuple:
    """The ambient mesh's process groups for `axes`, skipping axes that are
    absent or of size 1."""
    out = []
    for a in axes:
        g = sharding.axis_group(a)
        if g is not None:
            out.append(g)
    return tuple(out)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def _sum_over(x: torch.Tensor, groups: Tuple, op: str = "sum"
              ) -> torch.Tensor:
    y = x.clone()
    for g in groups:
        dist.all_reduce(y, op=_OPS[op], group=g)
    return y


def all_reduce(x: torch.Tensor, axes: Sequence[str],
               op: str = "sum") -> torch.Tensor:
    """x reduced over the ambient mesh's `axes` by `op` ("sum", "max" or
    "min"), no gradient."""
    groups = groups_for(axes)
    return _sum_over(x.detach(), groups, op) if groups else x


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


def _own_slice(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    return g.chunk(n, dim)[dist.get_group_rank(
        group, dist.get_rank())].contiguous()


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, summed):
        ctx.dim, ctx.group, ctx.summed = dim, group, summed
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        back = _scatter_sum if ctx.summed else _own_slice
        return back(g, ctx.dim, ctx.group), None, None, None


def gather_dim(x: torch.Tensor, dim: int, group,
               summed: bool = True) -> torch.Tensor:
    """All-gather x's shards along `dim` over `group`; the gradient comes
    back reduce-scattered (summed) to the shard, or with `summed=False`
    as this rank's slice of it."""
    return _GatherDim.apply(x, dim, group, summed)


def gather_rows(x: torch.Tensor, axes: Sequence[str] = DATA_AXES
                ) -> torch.Tensor:
    """Every rank's rows of x (dimension 0) over the ambient mesh's `axes`,
    row-major over them as `data.local_batch` cuts a batch (the inner axis
    gathered first).  The backward sums each row's cotangent over the
    ranks and hands each rank its own rows."""
    for axis in reversed(tuple(axes)):
        group = sharding.axis_group(axis)
        if group is not None:
            x = gather_dim(x, 0, group, summed=True)
    return x


def batch_mean(x: torch.Tensor, axes: Sequence[str] = DATA_AXES
               ) -> torch.Tensor:
    """The mean of x's elements over the global batch, x holding this
    rank's rows (every rank as many): this rank's sum summed over `axes`
    (`reduce_sum`: the backward is this rank's share) over the global
    count; `x.mean()` off a mesh."""
    groups = groups_for(axes)
    if not groups:
        return x.mean()
    n = x.numel() * math.prod(dist.get_world_size(g) for g in groups)
    return _ReduceSum.apply(x.sum(), groups) / n


def gather_full(x: torch.Tensor, dim: int, group: Optional[object]
                ) -> torch.Tensor:
    """All-gather without a gradient (checkpoints)."""
    return x if group is None else _gather(x.detach(), dim, group)


# ------------------------------------------------------------------ shift --

def shift_route(group, device: torch.device) -> str:
    """"p2p" or "all_gather": the route a shift over `group` takes for a
    tensor on `device` (see the module docstring)."""
    gloo_cuda = (dist.get_backend(group) == "gloo"
                 and torch.device(device).type == "cuda")
    return "all_gather" if gloo_cuda else "p2p"


def shift_many(tensors: List[torch.Tensor], group, offset: int
               ) -> List[torch.Tensor]:
    """Each tensor from the rank `offset` places before this one along
    `group` (cyclic, in the group's rank order): rank i sends to
    i + offset and receives from i - offset.  No gradient."""
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    i = ranks.index(dist.get_rank())
    src = (i - offset) % n
    if not tensors or src == i:
        return [t.clone() for t in tensors]
    if shift_route(group, tensors[0].device) == "all_gather":
        out = []
        for t in tensors:
            # flat: gloo takes only the concatenated output layout
            flat = t.contiguous().reshape(-1)
            slots = flat.new_empty(n * flat.numel())
            dist.all_gather_into_tensor(slots, flat, group=group)
            out.append(slots[src * flat.numel():(src + 1) * flat.numel()]
                       .view(t.shape))
        return out
    out = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
           for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), ranks[(i + offset) % n],
                      group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, ranks[src], group) for o in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out

