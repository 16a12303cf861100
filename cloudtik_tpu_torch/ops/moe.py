"""Mixture-of-experts layer: capacity-based top-k routing, dense einsums.

Counterpart of `cloudtik_tpu/ops/moe.py`: GShard/Switch routing with one
routing group per batch row (capacity per group, so a call routes by its
own sequence length: a prefill chunk, a decode step and a training row
route as the reference does at the same shape), dispatch and combine as
[B, S, E, C] tensors, and the experts as three batched einsums.  The
router and its softmax run in f32; dispatch and combine are cast to the
compute dtype before the einsums, as there.

On a mesh (parallel/sharding.py `use_mesh`) the layer issues the
collectives GSPMD derives in the reference:

* `expert` > 1: every expert rank holds the same tokens (the rules map
  `batch` to data and fsdp only) and E/n experts.  It dispatches to its
  own experts, and the combined output is a partial sum that one
  all-reduce over `expert` completes (`collectives.reduce_sum`, identity
  backward).  The tokens and the combine weights enter the experts
  through `collectives.copy_to`, whose backward sums over `expert`, so
  the router and everything before the layer get every expert's
  gradient.  The reference's docstring speaks of an all-to-all; its rules
  make the collective this all-reduce.
* the batch axes (data, fsdp): `fraction` and `mean_prob` are means over
  the global batch, reduced before their product; the z-loss is the
  global mean.  Each rank's loss differentiates its own tokens' share
  (identity backward) and the trainer sums the gradients.
* `tensor` > 1: each expert's d_ff columns are split (its `mlp` axis);
  the tokens and the combine weights enter through `copy_to` over
  `tensor` and the output is summed over it, with `expert`'s in one
  reduction; the router stays replicated.
* `seq` > 1: a routing group stays the whole row, as in the reference.
  Each rank holds S/n of a row's tokens; the capacity is the whole row's
  (`capacity(S x n)`), and in each routing round a token's slot is its
  place among the row's tokens for that expert: the local cumulative
  count plus the counts of the earlier `seq` shards (an exclusive scan of
  the per-(row, expert) counts over `seq`) plus the row's slots taken in
  earlier rounds.  Each shard's tokens fill their own slots of the whole
  buffer, so a sum over `seq` completes it (forward and backward: every
  shard's tokens read the experts' outputs of every shard's slots); each
  rank runs the experts on the whole buffer and combines its own tokens.
  The statistics are over the global batch, `seq` included.

The forward's three parts are `torch.profiler` ranges (moe.route: router,
dispatch and combine tensors, the losses; moe.dispatch and moe.combine:
the two [B, S, E, C] einsums; moe.experts: the three expert products),
which cost nothing measurable when no profiler runs
(tools/profile_torch_train.py reads them).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from cloudtik_tpu_torch.parallel import collectives, sharding
from cloudtik_tpu_torch.parallel.mesh import DATA_AXES


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    # Router auxiliary loss weights (Switch Transformer defaults).
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3

    def __post_init__(self):
        if self.top_k > self.num_experts:
            raise ValueError(
                f"top_k ({self.top_k}) must be <= num_experts "
                f"({self.num_experts}); extra routing rounds would dispatch "
                f"phantom weight-0 tokens that consume capacity slots")

    def capacity(self, tokens_per_group: int) -> int:
        """Expert buffer slots per routing group (one batch row)."""
        cap = int(math.ceil(
            self.top_k * tokens_per_group * self.capacity_factor
            / self.num_experts))
        return max(cap, 1)


def router_probs(x: torch.Tensor, w_router: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(probs, logits), both f32. x: [B,S,d]; w_router: [d,E]."""
    logits = torch.einsum("bsd,de->bse", x.float(), w_router.float())
    return torch.softmax(logits, dim=-1), logits


def _earlier_shards(counts: torch.Tensor) -> torch.Tensor:
    """The sum of `counts` [B,E] over the `seq` shards before this one (an
    exclusive scan along the ambient mesh's `seq` axis; zeros without
    one)."""
    group = sharding.axis_group("seq")
    if group is None:
        return torch.zeros_like(counts)
    every = collectives.gather_full(counts[None].contiguous(), 0, group)
    return every[:sharding.axis_rank("seq")].sum(0)


def _top_k_dispatch(probs: torch.Tensor, cfg: MoEConfig, capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grouped dispatch/combine tensors (group = batch row).

    probs: [B,S,E] f32, this rank's S tokens of each row on a `seq` mesh.
    Returns (dispatch [B,S,E,C] 0/1 f32, combine [B,S,E,C] f32, the
    per-expert dispatch counts [E] of these tokens).  Round r's tokens
    stack after round r-1's in each expert's buffer, a shard's after the
    earlier shards'; argmax takes the first expert on ties, as in the
    reference."""
    B, S, E = probs.shape
    dispatch = probs.new_zeros((B, S, E, capacity))
    combine = probs.new_zeros((B, S, E, capacity))
    remaining = probs
    used = torch.zeros((B, E), dtype=torch.long, device=probs.device)
    for _ in range(cfg.top_k):
        expert = remaining.argmax(dim=-1)                         # [B,S]
        gate = remaining.gather(-1, expert[..., None])[..., 0]    # [B,S]
        onehot = F.one_hot(expert, E).float()                     # [B,S,E]
        pos_in_expert = onehot.cumsum(dim=1) - 1.0
        before = used + _earlier_shards(onehot.sum(1).long())     # [B,E]
        pos = (pos_in_expert * onehot).sum(-1).long() \
            + before.gather(1, expert)                            # [B,S]
        keep = pos < capacity
        pos = pos.clamp(0, capacity - 1)
        slot = F.one_hot(pos, capacity).float()                   # [B,S,C]
        contrib = (onehot * keep[..., None].float())[..., None] \
            * slot[..., None, :]                                  # [B,S,E,C]
        dispatch = dispatch + contrib
        combine = combine + contrib * gate[..., None, None]
        used = used + collectives.all_reduce(
            (onehot * keep[..., None]).sum(1).long(), ("seq",))
        remaining = remaining * (1.0 - onehot)
    return dispatch, combine, dispatch.sum((0, 1, 3))


def moe_ffn(x: torch.Tensor, w_router: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, cfg: MoEConfig,
            tensor_split: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Expert SwiGLU feed-forward.

    x: [B,S,d]; w_router: [d,E]; w_gate/w_up: [E_local,d,f]; w_down:
    [E_local,f,d], where E_local is E, or E/n on an `expert` axis of n
    (this rank's experts), and f is d_ff, or this rank's d_ff/t columns
    when `tensor_split` (the experts' `mlp` dimension split over
    `tensor`: the tokens and the combine weights enter through `copy_to`
    and the output is summed over `tensor`, as over `expert`; the router
    stays replicated).  Returns (y [B,S,d] in x's dtype, metrics:
    moe_aux_loss, moe_z_loss, moe_drop_fraction)."""
    B, S, _ = x.shape
    E = cfg.num_experts
    n_seq = sharding.mesh_axis_size("seq")
    capacity = cfg.capacity(S * n_seq)  # per group (a whole batch row)
    dtype = x.dtype
    # tokens in the global batch: the batch axes split the rows evenly,
    # `seq` the rows' tokens
    stat_axes = DATA_AXES + ("seq",)
    n_tokens = B * S * math.prod(sharding.mesh_axis_size(a)
                                 for a in stat_axes)

    with record_function("moe.route"):
        probs, logits = router_probs(x, w_router)
        dispatch, combine, counts = _top_k_dispatch(probs, cfg, capacity)

        # Aux losses: load balance (Switch eq. 4) + router z-loss, over the
        # global batch: both means are reduced before their product.
        fraction = collectives.all_reduce(counts, stat_axes) / n_tokens
        mean_prob = collectives.reduce_sum(probs.sum((0, 1)),
                                           stat_axes) / n_tokens
        aux_loss = E * torch.sum(fraction * mean_prob) * cfg.aux_loss_weight
        z = torch.logsumexp(logits, dim=-1)
        z_loss = collectives.reduce_sum(
            (z ** 2).sum(), stat_axes) / n_tokens * cfg.z_loss_weight
        dispatched = collectives.all_reduce(dispatch.sum(), stat_axes)

        dispatch_c = dispatch.to(dtype)
        combine_c = combine.to(dtype)
        E_local = w_gate.shape[0]
        split = (("expert",) if E_local != E else ()) \
            + (("tensor",) if tensor_split else ())
        if split:
            x = collectives.copy_to(x, split)
            combine_c = collectives.copy_to(combine_c, split)
        if E_local != E:
            if sharding.mesh_axis_size("expert") * E_local != E:
                raise ValueError(
                    f"{E_local} local experts of {E} on an expert axis of "
                    f"{sharding.mesh_axis_size('expert')}")
            lo = sharding.axis_rank("expert") * E_local
            dispatch_c = dispatch_c[:, :, lo:lo + E_local]
            combine_c = combine_c[:, :, lo:lo + E_local]

    with record_function("moe.dispatch"):
        expert_in = torch.einsum("bsec,bsd->ebcd", dispatch_c, x)
        if n_seq > 1:
            # each shard filled its tokens' slots: the sum is the whole
            # buffer, and its gradient is every shard's
            expert_in = collectives.copy_to(
                collectives.reduce_sum(expert_in, ("seq",)), ("seq",))
    with record_function("moe.experts"):
        gate = torch.einsum("ebcd,edf->ebcf", expert_in, w_gate.to(dtype))
        up = torch.einsum("ebcd,edf->ebcf", expert_in, w_up.to(dtype))
        act = F.silu(gate) * up
        expert_out = torch.einsum("ebcf,efd->ebcd", act, w_down.to(dtype))
    with record_function("moe.combine"):
        y = torch.einsum("bsec,ebcd->bsd", combine_c, expert_out)
    if split:
        y = collectives.reduce_sum(y, split)

    metrics = {
        "moe_aux_loss": aux_loss,
        "moe_z_loss": z_loss,
        # Fraction of dispatch slots dropped (tokens over capacity).
        "moe_drop_fraction": 1.0 - dispatched / (n_tokens * cfg.top_k),
    }
    return y, metrics
