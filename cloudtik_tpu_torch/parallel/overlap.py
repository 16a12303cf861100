"""Bucketed gradient-sync/compute overlap for accumulated training steps.

Counterpart of `cloudtik_tpu/parallel/overlap.py`, the DDP/ZeRO schedule
(Li et al., "PyTorch Distributed", VLDB'20; Rajbhandari et al., "ZeRO",
SC'20): instead of one all-reduce of the whole gradient per microbatch,
each microbatch's gradients are flattened into fixed buckets (leaves
packed to `bucket_bytes` of f32) and each bucket is reduce-scattered over
the `data` axis with `async_op=True`, so the collective is in flight while
the next microbatch's backward runs.  Each rank accumulates its shard of
every bucket (1/D of the gradient bytes); one all-gather a bucket at the
step's end rebuilds the parameter-shaped tree the optimizer reads.

The plan is the reference's: leaves in tree order, greedy packing, bucket
lengths padded to the product of the batch axes' sizes, the scatter axes
from the rule table's `batch` mapping filtered to the mesh.  Torch holds
each rank's own shards of the parameters, so a plan built from the local
shapes buckets this rank's gradients, and the buckets scatter over `data`
alone: the `fsdp` sum of a split leaf happens in the backward (its
gather's reduce-scatter) and of a replicated one per microbatch, as in the
sequential path, and so does the `seq` sum.  The sums are the sequential
path's sums in the same order when `data` has two ranks and no other
token axis is split (a sum of two addends has one value), so the two paths
agree bit for bit there; with more addends the order differs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from cloudtik_tpu_torch.faults import seams
from cloudtik_tpu_torch.parallel.mesh import axis_sizes_of
from cloudtik_tpu_torch.parallel.sharding import (AxisRules, DEFAULT_RULES,
                                                  batch_mesh_axes)
from cloudtik_tpu_torch.tree import tree_leaves, tree_unflatten

# Default bucket size (the reference's: DDP's classic 25 MB is larger; a
# smaller one keeps several collectives in flight on small models).
DEFAULT_BUCKET_BYTES = 4 << 20


@dataclasses.dataclass(frozen=True)
class OverlapPlan:
    """Static flatten/scatter layout for one (param tree, mesh) pair.

    `buckets` holds, per bucket, the leaf indices (tree order) it packs;
    `sizes`/`shapes` describe every leaf; `scatter_axes` are the
    batch-mapped mesh axes (present, size > 1); `pad_to` is their size
    product (every bucket pads to a multiple of it)."""

    buckets: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    scatter_axes: Tuple[str, ...]
    pad_to: int
    bucket_bytes: int

    @property
    def shards(self) -> int:
        """How many ways each bucket scatters (1 = no scatter)."""
        return self.pad_to

    def bucket_len(self, bucket: Tuple[int, ...]) -> int:
        n = sum(self.sizes[i] for i in bucket)
        return ((n + self.pad_to - 1) // self.pad_to) * self.pad_to

    def grad_bytes(self) -> int:
        """Total f32 gradient bytes a step must sync (un-padded)."""
        return 4 * sum(self.sizes)


def plan_overlap(params_shape: Any, mesh,
                 rules: AxisRules = DEFAULT_RULES,
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> OverlapPlan:
    """The bucketed flatten/scatter plan for a tree of tensors (or
    anything with `.shape`) on `mesh` (a DeviceMesh or {axis: size}).

    Leaves pack greedily in tree order: a bucket closes once it crosses
    `bucket_bytes` of f32 gradient (one giant leaf is its own bucket)."""
    leaves = tree_leaves(params_shape)
    sizes = tuple(int(math.prod(leaf.shape)) for leaf in leaves)
    shapes = tuple(tuple(leaf.shape) for leaf in leaves)
    axes = batch_mesh_axes(mesh, rules)
    mesh_sizes = axis_sizes_of(mesh)
    pad_to = max(int(math.prod(mesh_sizes[a] for a in axes)), 1)
    buckets: List[Tuple[int, ...]] = []
    current: List[int] = []
    current_bytes = 0
    for i, size in enumerate(sizes):
        current.append(i)
        current_bytes += 4 * size
        if current_bytes >= bucket_bytes:
            buckets.append(tuple(current))
            current, current_bytes = [], 0
    if current:
        buckets.append(tuple(current))
    return OverlapPlan(buckets=tuple(buckets), sizes=sizes, shapes=shapes,
                       scatter_axes=axes, pad_to=pad_to,
                       bucket_bytes=int(bucket_bytes))


def should_overlap(config_value: Optional[bool], accum: int, mesh,
                   rules: AxisRules = DEFAULT_RULES) -> bool:
    """Resolve `TrainerConfig.overlap_grad_sync`: an explicit setting
    wins (and needs accum > 1); auto (None) is on when accum > 1 and the
    rule table's batch mapping puts a `data` axis on the mesh (a pure-FSDP
    mesh stays off, as in the reference)."""
    if config_value is not None:
        return bool(config_value) and accum > 1
    return accum > 1 and "data" in batch_mesh_axes(mesh, rules)


def flatten_buckets(grads: Any, plan: OverlapPlan) -> List[torch.Tensor]:
    """One flat f32 vector a bucket, zero-padded to its length."""
    leaves = tree_leaves(grads)
    out = []
    for bucket in plan.buckets:
        flat = torch.cat([leaves[i].reshape(-1).float() for i in bucket])
        pad = plan.bucket_len(bucket) - flat.numel()
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        out.append(flat)
    return out


def unflatten_buckets(flats: Sequence[torch.Tensor], plan: OverlapPlan,
                      like: Any) -> Any:
    """The gradient tree (structure of `like`) from whole flat buckets."""
    leaves: List[Optional[torch.Tensor]] = [None] * len(plan.sizes)
    for bucket, flat in zip(plan.buckets, flats):
        off = 0
        for i in bucket:
            leaves[i] = flat[off:off + plan.sizes[i]].reshape(plan.shapes[i])
            off += plan.sizes[i]
    return tree_unflatten(like, leaves)


class BucketSync:
    """One accumulated step's overlapped sync over `group` (the data
    axis): `add` starts each microbatch's reduce-scatters and folds the
    previous microbatch's into the carry; `finish` folds the last and
    all-gathers the buckets."""

    def __init__(self, plan: OverlapPlan, group):
        self.plan, self.group = plan, group
        self.n = dist.get_world_size(group)
        # the first microbatch's shards start the carry (not 0 + them: the
        # sequential path's sum starts from its first microbatch too)
        self.carry: Optional[List[torch.Tensor]] = None
        self.pending: List[Tuple[Any, torch.Tensor]] = []

    def _fold(self) -> None:
        for work, _ in self.pending:
            work.wait()
        outs = [out for _, out in self.pending]
        if outs:
            self.carry = outs if self.carry is None else [
                c + o for c, o in zip(self.carry, outs)]
        self.pending = []

    def add(self, grads: Any) -> None:
        started = []
        for flat in flatten_buckets(grads, self.plan):
            out = flat.new_empty(flat.numel() // self.n)
            started.append((dist.reduce_scatter_tensor(
                out, flat, op=dist.ReduceOp.SUM, group=self.group,
                async_op=True), out))
        self._fold()
        self.pending = started

    def finish(self, like: Any) -> Any:
        self._fold()
        flats = []
        for shard in self.carry:
            whole = shard.new_empty(shard.numel() * self.n)
            dist.all_gather_into_tensor(whole, shard, group=self.group)
            flats.append(whole)
        return unflatten_buckets(flats, self.plan, like)


# ------------------------------------------------------------ sync seam --

def deferred_sync_bytes(plan: OverlapPlan, overlap: bool) -> int:
    """Bytes of gradient traffic still un-hidden at the step boundary
    under a ring-collective cost model (the (D-1)/D wire factor):
    sequential, the whole all-reduce (2 G (D-1)/D); overlapped, only the
    closing all-gather (G (D-1)/D)."""
    shards = plan.shards
    if shards <= 1:
        return 0
    wire = plan.grad_bytes() * (shards - 1) // shards
    return wire if overlap else 2 * wire


def fire_grad_sync_seam(step: int, overlap: bool, sync_bytes: int,
                        fence=None) -> None:
    """The `train.grad_sync` injection seam, fired by the trainer at the
    gradient-sync boundary of every accumulated step (between the
    accumulation and the optimizer).  Latency injected here books to the
    goodput ledger's `grad_sync` bucket, never `step_compute`.  `fence`
    blocks until the accumulated gradients are done on the device.
    Unarmed this is one attribute check."""
    seams.fire("train.grad_sync", step=step, overlap=overlap,
               sync_bytes=sync_bytes, fence=fence)
