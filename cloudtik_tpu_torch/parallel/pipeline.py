"""Pipeline parallelism over the `pipe` mesh axis: GPipe and 1F1B.

Counterpart of `cloudtik_tpu/parallel/pipeline.py`.  The layer stack
[L, ...] is split over `pipe`, so each rank holds L/P contiguous layers (a
stage); the batch splits into M microbatches that flow stage to stage in
M + P - 1 ticks (fill, steady state, drain).  At tick t stage s runs
microbatch t - s, and at the end of every tick every rank hands what it
made to the next stage (`collectives.shift_many`, the reference's cyclic
`lax.ppermute`).

JAX runs the ticks as one `lax.scan` inside `shard_map`, every stage
computing every tick and `jnp.where` selecting the valid results.  Here
each rank runs one program with its stage index as a Python int, so a
stage skips the ticks where it holds no microbatch; the collectives over
`pipe` (the shift every tick, the closing reductions) run on every rank
every tick, in the same order, and the collectives inside a stage (tensor,
fsdp, data) run within groups whose ranks share the stage and so skip the
same ticks.  Autograd would order the backward's shifts by each rank's own
graph, so both schedules are one `torch.autograd.Function` whose backward
is written out: the reverse pipeline, M + P - 1 ticks, stage s handling
microbatch u - (P - 1 - s) at tick u, parameter gradients accumulating
locally and input cotangents shifting upstream.

* "gpipe": the forward keeps each tick's graph (every stage's activations
  for every microbatch are resident until the backward), and the
  backward differentiates those graphs.
* "1f1b": the forward runs under no_grad and saves only each
  microbatch's boundary input to its stage; the backward recomputes one
  stage slice a tick (`torch.enable_grad()` and `torch.autograd.grad`).
  Peak activation memory is M boundaries and one live stage window, the
  reference's reason for the schedule.  The bubble is the same
  (P-1)/(M+P-1).

The boundary, as the reference has it: the input is replicated over
`pipe` (every rank embeds); the activations cross stages in f32 and compute
in x's dtype; the last stage's outputs reach every rank (a sum over `pipe`
with zeros off the last stage); every rank then computes the same loss,
so each holds the whole output cotangent and only the last stage reads
it.  The input's cotangent is stage 0's, summed over `pipe` with zeros
elsewhere, so every leaf outside the stack gets the same gradient on every
pipe rank and the trainer never sums over `pipe`.  Extras (positions) are
per-microbatch data indexed by each stage and get no cotangent under
either schedule (the reference's GPipe differentiates them; every use here
passes integers).  Aux (MoE's router losses) accumulates each stage's
share of each microbatch and is summed over `pipe`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from cloudtik_tpu_torch.parallel import collectives, fsdp, sharding
from cloudtik_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten


def pipe_axis_size(axis: str = "pipe") -> int:
    """Size of the pipe axis on the ambient mesh (1 = no pipelining)."""
    return sharding.mesh_axis_size(axis)


def pipeline_apply(
    stage_fn: Callable[..., Any],
    stacked_params: Any,
    x: torch.Tensor,
    *,
    n_microbatches: int,
    extras: Any = None,
    aux_init: Optional[Dict[str, float]] = None,
    axis: str = "pipe",
    schedule: str = "gpipe",
):
    """Apply a pipe-split layer stack to x.

    stage_fn(stage_params, x_micro, extras_micro) applies one stage's layer
    slice and returns y_micro (x's shape and dtype), or (y_micro, aux)
    when `aux_init` is given.  stacked_params is this rank's stage: a tree
    whose leaves are tensors or `fsdp.LayerShards` with leading dim L/P.
    x: [B, ...], the same on every pipe rank, B divisible by
    n_microbatches.  extras: None or a tree of [B, ...] tensors, sliced per
    microbatch.  aux_init: {name: 0.0}; the return is then (y, aux_sum),
    aux summed over stages and microbatches (divide by layers *
    microbatches for a mean).

    With no `axis` on the ambient mesh (or size 1) the stack runs locally
    on the whole batch."""
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    n_stages = pipe_axis_size(axis)
    M = n_microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(
            f"batch {B} not divisible by n_microbatches {M}")
    if n_stages == 1:
        return stage_fn(stacked_params, x, extras)
    run = _Run(stage_fn, stacked_params, extras, M, B, axis, schedule,
               None if aux_init is None else sorted(aux_init))
    outs = _Pipeline.apply(run, x, *run.leaves)
    if aux_init is None:
        return outs[0] if isinstance(outs, tuple) else outs
    return outs[0], dict(zip(run.aux_keys, outs[1:]))


def _tensors(stacked: Any) -> List[torch.Tensor]:
    """The stage's leaf tensors (a LayerShards' local shard)."""
    return [w.local if isinstance(w, fsdp.LayerShards) else w
            for w in tree_leaves(stacked)]


def _rebuild(stacked: Any, tensors: List[torch.Tensor]) -> Any:
    """`stacked` with its leaf tensors replaced, LayerShards kept."""
    def one(w, t):
        if isinstance(w, fsdp.LayerShards):
            return fsdp.LayerShards(t, w.gathers)
        return t
    return tree_map(one, stacked, tree_unflatten(stacked, tensors))


class _Run:
    """One pipeline call: the stage, its place on the axis, and what the
    forward leaves for the backward."""

    def __init__(self, stage_fn, stacked, extras, M, B, axis, schedule,
                 aux_keys):
        self.stage_fn, self.stacked, self.extras = stage_fn, stacked, extras
        self.M, self.mb, self.schedule = M, B // M, schedule
        self.aux_keys = aux_keys
        self.group = sharding.axis_group(axis)
        self.P = dist.get_world_size(self.group)
        self.s = sharding.axis_rank(axis)
        self.leaves = _tensors(stacked)
        # a call under no_grad keeps nothing for a backward
        self.keep = torch.is_grad_enabled()
        self.graphs: Dict[int, Tuple] = {}
        self.saved: Optional[torch.Tensor] = None

    def extras_of(self, m: int):
        lo, hi = m * self.mb, (m + 1) * self.mb
        if self.extras is None:
            return None
        return tree_map(lambda e: e[lo:hi], self.extras)

    def call(self, leaves, x_in, m):
        """stage_fn on microbatch m: (y, [aux scalars in key order])."""
        out = self.stage_fn(_rebuild(self.stacked, list(leaves)), x_in,
                            self.extras_of(m))
        if self.aux_keys is None:
            return out, []
        y, aux = out
        return y, [aux[k] for k in self.aux_keys]

    def grad_leaves(self):
        """The stage's leaves detached, as fresh autograd leaves."""
        return [w.detach().requires_grad_(w.requires_grad)
                for w in self.leaves]

    def forward(self, x: torch.Tensor):
        P, M, s = self.P, self.M, self.s
        dtype = x.dtype
        xs = x.reshape(M, self.mb, *x.shape[1:])
        micro = (self.mb,) + tuple(x.shape[1:])
        f32 = dict(dtype=torch.float32, device=x.device)
        outputs = torch.zeros((M,) + micro, **f32)
        aux_tot = torch.zeros(len(self.aux_keys or ()), **f32)
        state = torch.zeros(micro, **f32)
        saved = []
        grad = self.keep and self.schedule == "gpipe"
        leaves = self.grad_leaves() if grad else self.leaves
        self.grad_params = leaves
        for t in range(M + P - 1):
            m = t - s
            send = torch.zeros(micro, **f32)
            if 0 <= m < M:
                x_in = xs[m] if s == 0 else state.to(dtype)
                if grad:
                    with torch.enable_grad():
                        x_in = x_in.detach().requires_grad_(True)
                        y, aux = self.call(leaves, x_in, m)
                    self.graphs[m] = (x_in, y, aux)
                else:
                    if self.keep:
                        saved.append(x_in)
                    y, aux = self.call(leaves, x_in, m)
                for j, a in enumerate(aux):
                    aux_tot[j] += a.detach().float()
                send = y.detach().float()
                if s == P - 1:
                    outputs[m] = send
            if t < M + P - 2:        # the last tick's hand-off is unread
                state = collectives.shift_many([send], self.group, 1)[0]
        if saved:
            self.saved = torch.stack(saved)
        if s != P - 1:
            outputs.zero_()
        out = collectives._sum_over(outputs, (self.group,))
        aux = collectives._sum_over(aux_tot, (self.group,)) \
            if self.aux_keys else aux_tot
        return out.to(dtype).reshape(x.shape), aux

    def backward(self, g_out: torch.Tensor, g_aux: List[torch.Tensor]):
        P, M, s = self.P, self.M, self.s
        dtype = g_out.dtype
        gs = g_out.reshape(M, self.mb, *g_out.shape[1:])
        micro = (self.mb,) + tuple(g_out.shape[1:])
        f32 = dict(dtype=torch.float32, device=g_out.device)
        dxs = torch.zeros((M,) + micro, **f32)
        dparams: List[Optional[torch.Tensor]] = [None] * len(self.leaves)
        gstate = torch.zeros(micro, **f32)
        leaves = self.grad_params if self.schedule == "gpipe" \
            else self.grad_leaves()
        wanted = [i for i, w in enumerate(leaves) if w.requires_grad]
        for u in range(M + P - 1):
            m = u - (P - 1 - s)
            send = torch.zeros(micro, **f32)
            if 0 <= m < M:
                g_in = gs[m] if s == P - 1 else gstate.to(dtype)
                if self.schedule == "gpipe":
                    x_in, y, aux = self.graphs.pop(m)
                else:
                    with torch.enable_grad():
                        x_in = self.saved[m].detach().requires_grad_(True)
                        y, aux = self.call(leaves, x_in, m)
                outs, cts = [y], [g_in]
                for a, g in zip(aux, g_aux):
                    if a.requires_grad:
                        outs.append(a)
                        cts.append(g.to(a.dtype))
                grads = torch.autograd.grad(
                    outs, [x_in] + [leaves[i] for i in wanted], cts,
                    allow_unused=True)
                for i, g in zip(wanted, grads[1:]):
                    if g is not None:
                        dparams[i] = g if dparams[i] is None \
                            else dparams[i] + g
                if grads[0] is not None:
                    send = grads[0].float()
                if s == 0:
                    dxs[m] = send
            if u < M + P - 2:
                gstate = collectives.shift_many([send], self.group, -1)[0]
        self.saved = None
        if s != 0:
            dxs.zero_()
        dx = collectives._sum_over(dxs, (self.group,))
        dparams = [torch.zeros_like(w) if d is None and w.requires_grad
                   else d for d, w in zip(dparams, self.leaves)]
        return dx.to(dtype).reshape(g_out.shape), dparams


class _Pipeline(torch.autograd.Function):
    """Inputs (run, x, *stage leaves); outputs (y, *aux scalars)."""

    @staticmethod
    def forward(ctx, run, x, *leaves):
        out, aux = run.forward(x)
        ctx.run = run
        if run.saved is not None:
            # the boundaries go through save_for_backward, where
            # saved-tensor hooks see them
            ctx.save_for_backward(run.saved)
            run.saved = None
        return (out,) + tuple(aux.unbind(0))

    @staticmethod
    def backward(ctx, g_out, *g_aux):
        run = ctx.run
        if ctx.saved_tensors:
            run.saved = ctx.saved_tensors[0]
        dx, dparams = run.backward(g_out, list(g_aux))
        ctx.run = None
        return (None, dx, *dparams)
