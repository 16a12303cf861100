"""AdamW, SGD with momentum, Adafactor and Lion with global-norm clipping
and warmup schedules, as optax computes them.

Counterpart of `cloudtik_tpu/train/optim.py`.  `make_optimizer` returns an
`Optimizer`, an init/update pair over nested dicts of tensors that follows
`optax.chain(clip_by_global_norm, <optimizer>(schedule, ...))` step by
step, casts included, not `torch.optim`:

- clipping scales by max_norm / ||g|| only when ||g|| >= max_norm (no
  1e-6 added, unlike `torch.nn.utils.clip_grad_norm_`), with ||g|| the f32
  `global_norm` that `update` also returns for the trainer to report;
- the learning rate is the schedule at the count before the increment, so
  the warmup schedules give 0.0 at the first step;
- a Python constant takes the dtype of the tensor it scales, as JAX's weak
  types do (`_c`), so bf16 moments and params round where optax rounds.

Per optimizer (optax's defaults as the JAX package calls them):

- adamw: mu = b1 mu + (1 - b1) g and nu = b2 nu + (1 - b2) g^2,
  bias-corrected by the step count; eps outside the square root; weight
  decay adds wd * p to every leaf (no mask: norm scales decay too); mu is
  stored in `moment_dtype` (after the update used it unrounded), nu in the
  dtype it was computed in (the params' for params-dtype grads);
- sgd: the trace g + 0.9 trace (optax.trace, no Nesterov), stored in
  `moment_dtype` after the update used it unrounded; no weight decay;
- adafactor: optax.scale_by_factored_rms (decay 1 - (count + 1)^-0.8, eps
  1e-30 added to g^2; a leaf whose second-largest axis has >= 128 entries
  keeps row and column means over its two largest axes, wherever they
  sit, picked by `np.argsort` as optax does; any other leaf a full v),
  then each leaf's update clipped to rms 1, the learning rate, times
  max(rms(p), 1e-3), and the sign flipped; no momentum, so
  `moment_dtype` changes nothing; no weight decay;
- lion: sign((1 - b1) g + b1 mu) with b1 = 0.9, then mu = b2 mu +
  (1 - b2) g with b2 = 0.99, stored in `moment_dtype`; plus wd * p.

On a mesh (train/trainer.py) each leaf is this rank's shard of a
parameter.  The trainer hands the optimizer each leaf's `LeafLayout` (its
whole shape and the process groups each dimension is split over), and
Adafactor decides factoring from the whole shape, sums its row and column
second moments over the shards along the averaged dimensions, and takes
its block-RMS clip and parameter scale over the whole leaf; the other
optimizers are elementwise and need none of it.  `state_dim` says how a
parameter dimension maps into each state tree's leaves, so the trainer
can place the state.

The states keep optax's layout: {"count", "mu", "nu"} (adamw), {"count",
"trace"} (sgd: the count is the schedule's), {"count", "v_row", "v_col",
"v"} (adafactor, with optax's (1,)-shaped placeholders where a leaf does
not use a slot), {"count", "mu"} (lion); the count is a Python int.  The
trainer applies updates as p + u.to(p.dtype).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from cloudtik_tpu_torch.tree import (Tree, tree_leaves, tree_map,
                                     tree_unflatten)

Schedule = Callable[[int], float]


@dataclasses.dataclass
class LeafLayout:
    """A parameter leaf held as a shard: its whole shape, and per split
    dimension the process groups it is split over (summing over each in
    turn sums over all of its pieces)."""

    shape: Tuple[int, ...]
    groups: Dict[int, Tuple[Any, ...]]

    def all_groups(self) -> Tuple[Any, ...]:
        return tuple(g for d in sorted(self.groups) for g in self.groups[d])


def _sum_over(x: torch.Tensor, groups) -> torch.Tensor:
    import torch.distributed as dist

    for g in groups:
        dist.all_reduce(x, group=g)
    return x


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


def _norm_accumulator(x: torch.Tensor) -> torch.dtype:
    """f32 on the card, whose reductions sum in a tree; f64 on the CPU,
    whose f32 `vector_norm` lost 5.4e-3 of a norm over 6.7e7 entries
    (XLA's reductions do not lose that)."""
    return torch.float64 if x.device.type == "cpu" else torch.float32


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, as an f32 scalar, as the
    JAX trainer reports it; one reduction per leaf, with no f32 copy of a
    bf16 leaf.  optax's clip sums a bf16 leaf with f32 accumulation too but
    rounds each square and each leaf's sum to bf16, so for bf16 grads its
    norm may differ from this one by a bf16 step."""
    return torch.sqrt(sum(
        torch.square(torch.linalg.vector_norm(x, dtype=_norm_accumulator(x)))
        for x in tree_leaves(tree))).float()


def _leafwise(fn, *trees: Tree) -> Tuple[Tree, ...]:
    """fn over the leaves of same-structured trees, matched by key as
    `tree_map` matches them, each call returning a tuple; the i-th results
    come back as the i-th tree, in the first tree's structure."""
    out = []
    tree_map(lambda *a: out.append(fn(*a)), *trees)
    return tuple(tree_unflatten(trees[0], list(col)) for col in zip(*out))


class Optimizer:
    """clip_by_global_norm (when set) followed by one optax optimizer; a
    subclass gives `init` and `_apply` (the optimizer on clipped grads at
    the step's learning rate)."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.mu_dtype = (getattr(torch, cfg.moment_dtype)
                         if cfg.moment_dtype else None)
        # set by `update_` for the length of its call: the params the
        # updates go into, and the clip's (divisor, multiplier)
        self._sink = None
        self._clip = None
        # on a mesh: a LeafLayout per leaf, in the gradients' leaf order
        self.layout: Optional[list] = None

    def init(self, params: Tree) -> Dict[str, Any]:
        raise NotImplementedError

    def state_dim(self, key: str, shape: Tuple[int, ...],
                  dim: int) -> Optional[int]:
        """The dim of state tree `key`'s leaf that parameter dim `dim` of a
        leaf of whole `shape` becomes, or None where the state leaf has no
        such dim.  Here every moment is parameter-shaped."""
        return dim

    def _apply(self, grads: Tree, state: Dict[str, Any], params: Tree,
               lr: float) -> Tuple[Tree, Dict[str, Any]]:
        raise NotImplementedError

    @torch.no_grad()
    def update(self, grads: Tree, state: Dict[str, Any], params: Tree,
               g_norm: Optional[torch.Tensor] = None
               ) -> Tuple[Tree, Dict[str, Any], torch.Tensor]:
        """(updates, new state, pre-clip `global_norm` of the grads); params
        are read for the weight decay and Adafactor's scale.  The clip is
        chosen on the device, so the host never waits for the norm: g / d
        * m with (d, m) = (||g||, max_norm) is optax's clipped branch, and
        (1, 1) leaves g exact.  `g_norm` is the global norm when the
        grads are shards of it (the sharded trainer sums the shards' squares
        over their group)."""
        cfg = self.cfg
        if g_norm is None:
            g_norm = global_norm(grads)
        if cfg.grad_clip_norm:
            keep = g_norm < cfg.grad_clip_norm
            div = torch.where(keep, 1.0, g_norm)
            mul = torch.where(keep, 1.0,
                              torch.full_like(g_norm, cfg.grad_clip_norm))
            if self._sink is None:
                grads = tree_map(
                    lambda g: g / div.to(g.dtype) * mul.to(g.dtype), grads)
            else:
                self._clip = (div, mul)
        updates, state = self._apply(grads, state, params,
                                     self.schedule(state["count"]))
        return updates, state, g_norm

    @torch.no_grad()
    def update_(self, grads: Tree, state: Dict[str, Any], params: Tree,
                g_norm: Optional[torch.Tensor] = None
                ) -> Tuple[Dict[str, Any], torch.Tensor]:
        """`update` in place, for a caller that owns params and state (the
        trainer): leaf by leaf, the update is added to the parameter and
        the new state written over the old, so one leaf's temporaries are
        live at a time instead of a second copy of the grads, the state
        and the updates (what the reference's donated buffers give).  The
        same arithmetic as `update` then `p + u`; returns (state, the
        pre-clip global norm)."""
        self._sink = params
        try:
            _, state, g_norm = self.update(grads, state, params, g_norm)
        finally:
            self._sink, self._clip = None, None
        return state, g_norm

    def _each(self, fn, *trees: Tree) -> Tuple[Tree, ...]:
        """`_leafwise` over (grads, *state trees[, params]) whose fn
        returns (update, *new state leaves); inside `update_` each leaf's
        update goes into its parameter and its new state over the old at
        once (the returned updates are then None)."""
        if self._sink is None:
            return _leafwise(fn, *trees)
        clip, outs = self._clip, []

        def one(g, *rest):
            *rest, p = rest
            if clip is not None:
                g = g / clip[0].to(g.dtype) * clip[1].to(g.dtype)
            u, *news = fn(g, *rest)
            for old, new in zip(rest, news):
                old.copy_(new)
            p.add_(u.to(p.dtype))
            outs.append(len(news))

        tree_map(one, *trees, self._sink)
        return (None,) + trees[1:1 + (outs[0] if outs else 0)]


class AdamW(Optimizer):
    """optax.adamw(schedule, b1, b2, eps, weight_decay, mu_dtype)."""

    def init(self, params: Tree) -> Dict[str, Any]:
        return {"count": 0,
                "mu": tree_map(lambda p: torch.zeros_like(
                    p, dtype=self.mu_dtype or p.dtype), params),
                "nu": tree_map(torch.zeros_like, params)}

    def _apply(self, grads, state, params, lr):
        cfg = self.cfg
        count = state["count"] + 1
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

        updates, mu, nu = self._each(leaf, grads, state["mu"], state["nu"],
                                    params)
        return updates, {"count": count, "mu": mu, "nu": nu}


class SGD(Optimizer):
    """optax.sgd(schedule, momentum=0.9, accumulator_dtype=moment_dtype)."""

    MOMENTUM = 0.9

    def init(self, params: Tree) -> Dict[str, Any]:
        return {"count": 0,
                "trace": tree_map(lambda p: torch.zeros_like(
                    p, dtype=self.mu_dtype or p.dtype), params)}

    def _apply(self, grads, state, params, lr):
        def leaf(g, t):
            t = g + _c(self.MOMENTUM, t) * t
            return (_c(-lr, t) * t,
                    t.to(self.mu_dtype) if self.mu_dtype else t)

        updates, trace = self._each(leaf, grads, state["trace"])
        return updates, {"count": state["count"] + 1, "trace": trace}


def factored_dims(shape, min_dim_size_to_factor: int = 128
                  ) -> Optional[Tuple[int, int]]:
    """optax's `_factored_dims`: (second-largest, largest) axis of a leaf
    whose second-largest axis has at least `min_dim_size_to_factor`
    entries, by `np.argsort` of the shape (so ties fall as optax's do);
    None for any other leaf and for 0-D and 1-D leaves."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(Optimizer):
    """optax.adafactor(schedule) at its defaults: factored second moments
    (decay 0.8, eps 1e-30, factor from 128 entries), block-rms clip 1.0,
    the parameter-scale multiply, no momentum, no weight decay."""

    DECAY_RATE = 0.8
    EPS = 1e-30
    MIN_DIM_SIZE_TO_FACTOR = 128
    CLIP_THRESHOLD = 1.0
    MIN_SCALE = 1e-3

    def init(self, params: Tree) -> Dict[str, Any]:
        def leaf(p):
            def zeros(shape):
                return torch.zeros(shape, dtype=p.dtype, device=p.device)
            dims = factored_dims(tuple(p.shape), self.MIN_DIM_SIZE_TO_FACTOR)
            if dims is None:
                return zeros((1,)), zeros((1,)), torch.zeros_like(p)
            d1, d0 = dims
            return (zeros(np.delete(p.shape, d0).tolist()),
                    zeros(np.delete(p.shape, d1).tolist()), zeros((1,)))

        v_row, v_col, v = _leafwise(leaf, params)
        return {"count": 0, "v_row": v_row, "v_col": v_col, "v": v}

    def state_dim(self, key, shape, dim):
        dims = factored_dims(shape, self.MIN_DIM_SIZE_TO_FACTOR)
        if key == "v":
            return dim if dims is None else None
        if dims is None:
            return None         # a (1,) placeholder
        gone = dims[1] if key == "v_row" else dims[0]
        return None if dim == gone else dim - (dim > gone)

    def _apply(self, grads, state, params, lr):
        count = state["count"]
        layouts = iter(self.layout) if self.layout is not None else None
        # decay_rate_t = 1 - (count + 1)^-0.8, in f32 as optax computes it
        decay = 1.0 - torch.tensor(count + 1, dtype=torch.float32) \
            ** -self.DECAY_RATE
        keep = 1.0 - decay

        def leaf(g, v_row, v_col, v, p):
            lay = next(layouts) if layouts is not None else None
            split = lay is not None and bool(lay.all_groups())
            shape = lay.shape if lay is not None else tuple(p.shape)

            def mean(x, x_dim, p_dim, keepdim=False):
                # over a dimension that may be split: the local sum, summed
                # over its groups, over the whole extent
                groups = lay.groups.get(p_dim, ()) if split else ()
                if not groups:
                    return x.mean(dim=x_dim, keepdim=keepdim)
                return _sum_over(x.sum(dim=x_dim, keepdim=keepdim),
                                 groups) / shape[p_dim]

            def whole_mean(x):
                if not split:
                    return torch.mean(x)
                return _sum_over(x.sum(), lay.all_groups()) / math.prod(shape)

            dt = p.dtype
            decay_t = decay.to(g.device)
            keep_t = keep.to(g.device)
            g_sqr = g * g + _c(self.EPS, g)
            dims = factored_dims(shape, self.MIN_DIM_SIZE_TO_FACTOR)
            if dims is not None:
                d1, d0 = dims
                # optax's f32 decay promotes a bf16 mean; stored in dt
                v_row = (decay_t * v_row.float() + keep_t
                         * mean(g_sqr, d0, d0).float()).to(dt)
                v_col = (decay_t * v_col.float() + keep_t
                         * mean(g_sqr, d1, d1).float()).to(dt)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_mean = mean(v_row, reduced_d1, d1, keepdim=True)
                row_factor = (v_row / row_mean) ** -0.5
                col_factor = v_col ** -0.5
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            else:
                v = (decay_t * v.float() + keep_t * g_sqr.float()).to(dt)
                u = g * v ** -0.5
            # clip_by_block_rms
            rms = torch.sqrt(whole_mean(u * u))
            u = u / torch.clamp(rms / _c(self.CLIP_THRESHOLD, rms), min=1.0)
            u = _c(lr, u) * u
            # scale_by_param_block_rms: max(rms(p), 1e-3)
            p_rms = torch.sqrt(whole_mean(p * p))
            scale = torch.where(p_rms <= _c(self.MIN_SCALE, p_rms),
                                _c(self.MIN_SCALE, p_rms), p_rms)
            u = u * scale
            return -u, v_row, v_col, v

        updates, v_row, v_col, v = self._each(
            leaf, grads, state["v_row"], state["v_col"], state["v"], params)
        return updates, {"count": count + 1, "v_row": v_row,
                         "v_col": v_col, "v": v}


class Lion(Optimizer):
    """optax.lion(schedule, b1=0.9, b2=0.99, weight_decay,
    mu_dtype=moment_dtype)."""

    B1 = 0.9
    B2 = 0.99

    def init(self, params: Tree) -> Dict[str, Any]:
        return {"count": 0,
                "mu": tree_map(lambda p: torch.zeros_like(
                    p, dtype=self.mu_dtype or p.dtype), params)}

    def _apply(self, grads, state, params, lr):
        wd = self.cfg.weight_decay

        def leaf(g, mu, p):
            u = torch.sign(_c(1 - self.B1, g) * g + _c(self.B1, mu) * mu)
            mu = _c(1 - self.B2, g) * g + _c(self.B2, mu) * mu
            u = u + _c(wd, p) * p
            return (_c(-lr, u) * u,
                    mu.to(self.mu_dtype) if self.mu_dtype else mu)

        updates, mu = self._each(leaf, grads, state["mu"], params)
        return updates, {"count": state["count"] + 1, "mu": mu}


OPTIMIZERS = {"adamw": AdamW, "sgd": SGD, "adafactor": Adafactor,
              "lion": Lion}


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    if cfg.name not in OPTIMIZERS:
        raise ValueError(f"Unknown optimizer {cfg.name!r}")
    return OPTIMIZERS[cfg.name](cfg)
