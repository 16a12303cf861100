"""AdamW with global-norm clipping and warmup schedules, as optax computes
them.

Counterpart of `cloudtik_tpu/train/optim.py`.  `make_optimizer` returns an
init/update pair over nested dicts of tensors that follows
`optax.chain(clip_by_global_norm, adamw(schedule, ...))` step by step,
casts included, not `torch.optim.AdamW`:

- clipping scales by max_norm / ||g|| only when ||g|| >= max_norm (no
  1e-6 added, unlike `torch.nn.utils.clip_grad_norm_`), with ||g|| the f32
  `global_norm` that `update` also returns for the trainer to report;
- mu = b1 mu + (1 - b1) g and nu = b2 nu + (1 - b2) g^2, bias-corrected by
  the step count; eps outside the square root;
- weight decay adds wd * p to every leaf (no mask: norm scales decay too);
- the learning rate is the schedule at the count before the increment, so
  the warmup schedules give 0.0 at the first step;
- mu is stored in `moment_dtype` (after the update used it unrounded), nu
  in the dtype it was computed in (the params' for params-dtype grads);
- a Python constant takes the dtype of the tensor it scales, as JAX's weak
  types do (`_c`), so bf16 moments and params round where optax rounds.

The trainer applies updates as p + u.to(p.dtype).  sgd, adafactor and lion
are not ported yet (ROADMAP A4).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from cloudtik_tpu_torch.tree import (Tree, tree_leaves, tree_map,
                                     tree_unflatten)

Schedule = Callable[[int], float]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip_norm: Optional[float] = 1.0
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"  # "cosine" | "constant" | "linear"
    # First-moment storage dtype ("bfloat16" halves Adam's mu memory).
    moment_dtype: Optional[str] = None


# ---------------------------------------------------------- schedules --

def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over `steps`, then end; a
    non-positive `steps` is the constant init."""
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    """optax.cosine_decay_schedule with exponent 1."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         "decay_steps!")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        decayed = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init * ((1 - alpha) * decayed + alpha)
    return schedule


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules with one boundary."""
    return lambda count: first(count) if count < boundary \
        else second(count - boundary)


def make_schedule(cfg: OptimizerConfig) -> Schedule:
    """count -> learning rate, warming up from 0.0 at count 0."""
    peak = cfg.learning_rate
    warmup = _linear(0.0, peak, cfg.warmup_steps)
    if cfg.schedule == "constant":
        return warmup
    end = peak * cfg.min_lr_ratio
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    if cfg.schedule == "linear":
        return _join(warmup, _linear(peak, end, decay_steps),
                     cfg.warmup_steps)
    alpha = 0.0 if peak == 0.0 else end / peak
    return _join(warmup, _cosine(peak, cfg.total_steps - cfg.warmup_steps,
                                 alpha), cfg.warmup_steps)


# ---------------------------------------------------------- optimizer --

def _c(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant in `like`'s dtype, as JAX's weak typing makes it
    (0.9 times a bf16 moment multiplies by bf16(0.9) = 0.8984375)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, as the JAX trainer
    reports it; one reduction per leaf, with no f32 copy of a bf16 leaf.
    optax's clip sums a bf16 leaf with f32 accumulation too but rounds each
    square and each leaf's sum to bf16, so for bf16 grads its norm may
    differ from this one by a bf16 step."""
    return torch.sqrt(sum(
        torch.square(torch.linalg.vector_norm(x, dtype=torch.float32))
        for x in tree_leaves(tree)))


class AdamW:
    """clip_by_global_norm (when set) followed by optax.adamw."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.mu_dtype = (getattr(torch, cfg.moment_dtype)
                         if cfg.moment_dtype else None)

    def init(self, params: Tree) -> Dict[str, Any]:
        return {"count": 0,
                "mu": tree_map(lambda p: torch.zeros_like(
                    p, dtype=self.mu_dtype or p.dtype), params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, grads: Tree, state: Dict[str, Any], params: Tree
               ) -> Tuple[Tree, Dict[str, Any], torch.Tensor]:
        """(updates, new state, pre-clip `global_norm` of the grads); params
        are read for the weight decay.  The clip is chosen on the device, so
        the host never waits for the norm: g / d * m with (d, m) = (||g||,
        max_norm) is optax's clipped branch, and (1, 1) leaves g exact."""
        cfg = self.cfg
        g_norm = global_norm(grads)
        if cfg.grad_clip_norm:
            keep = g_norm < cfg.grad_clip_norm
            div = torch.where(keep, 1.0, g_norm)
            mul = torch.where(keep, 1.0,
                              torch.full_like(g_norm, cfg.grad_clip_norm))
            grads = tree_map(
                lambda g: g / div.to(g.dtype) * mul.to(g.dtype), grads)
        count = state["count"] + 1
        lr = self.schedule(state["count"])
        bc1 = 1 - torch.tensor(cfg.b1, dtype=torch.float32) ** count
        bc2 = 1 - torch.tensor(cfg.b2, dtype=torch.float32) ** count

        def leaf(g, mu, nu, p):
            mu = _c(1 - cfg.b1, g) * g + _c(cfg.b1, mu) * mu
            nu = _c(1 - cfg.b2, g) * (g * g) + _c(cfg.b2, nu) * nu
            mu_hat = mu / bc1.to(device=mu.device, dtype=mu.dtype)
            nu_hat = nu / bc2.to(device=nu.device, dtype=nu.dtype)
            u = torch.sqrt(nu_hat)
            u = mu_hat / (u + _c(cfg.eps, u))
            u = u + _c(cfg.weight_decay, p) * p
            u = _c(-lr, u) * u
            return u, (mu.to(self.mu_dtype) if self.mu_dtype else mu), nu

        out = [leaf(*a) for a in zip(*(tree_leaves(t) for t in (
            grads, state["mu"], state["nu"], params)))]
        updates, mu, nu = (tree_unflatten(grads, [t[i] for t in out])
                           for i in range(3))
        return updates, {"count": count, "mu": mu, "nu": nu}, g_norm


def make_optimizer(cfg: OptimizerConfig) -> AdamW:
    if cfg.name == "adamw":
        return AdamW(cfg)
    if cfg.name in ("sgd", "adafactor", "lion"):
        raise NotImplementedError(
            f"optimizer {cfg.name!r} is not ported yet (ROADMAP A4); the "
            "port has adamw")
    raise ValueError(f"Unknown optimizer {cfg.name!r}")
