"""LoRA — low-rank adaptation of the attention projections: training and
serving.

Counterpart of `cloudtik_tpu/models/lora.py`.  An adapter is a small tree
`{target: {"a": [L, rows..., r], "b": [L, r, cols...]}}` beside the frozen
base parameters; `merge_lora` folds it into the layer weights
(`w + (a @ b) * scale`), and the gathered batched-adapter path (S-LoRA,
Punica) serves many adapters in one forward: resident adapters stack into
fixed-capacity planes `a: [L, A, rows..., r]` / `b: [L, A, r, cols...]`, and
`gathered_delta` applies each lane's pair, picked by index, next to the
base projection.  Plane slot 0 is the null adapter (all zeros, a delta of
exactly 0), so base-model requests share the program.

Training (`lora_loss_fn`, `lora_spec`) differentiates the adapters only:
the loss merges them into the frozen base inside the step, and the base
lives in the spec's closure, detached, so it never enters the trainer's
params, the optimizer state or a checkpoint (a checkpoint holds the
adapters and their optimizer state, which `serve/adapters.py`'s
`checkpoint_loader` reads back).

Here the planes are written in place (`write_adapter_slot`,
`clear_adapter_slot`), where the JAX functions return new trees, and
random draws come from a `torch.Generator`.  Not here yet:
`lora_logical_axes` (ROADMAP A7, the parallel layer).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import torch

from cloudtik_tpu_torch.device import DeviceLike, resolve_device
from cloudtik_tpu_torch.models.transformer import (
    TransformerConfig, loss_fn as base_loss_fn)

Params = Dict[str, Any]

TARGETS = ("wq", "wv")      # standard LoRA targets


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    targets: Tuple[str, ...] = TARGETS

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


# Per-target weight layouts: wq/wk/wv are (L, d, H, Dh) = rows d, cols
# (H, Dh); wo is (L, H, Dh, d) = rows (H, Dh), cols d.  The adapter pair
# is always a:(L, rows..., r), b:(L, r, cols...), merged with one einsum.
_LAYOUTS = {
    "wq": ("in_embed", "out_heads"),
    "wk": ("in_embed", "out_heads"),
    "wv": ("in_embed", "out_heads"),
    "wo": ("in_heads", "out_embed"),
}


def lora_logical_axes(cfg: TransformerConfig,
                      lora: LoRAConfig) -> Dict[str, Any]:
    """Logical axes of the adapter tree (the reference's): a's input rows
    and b's output columns carry the target's own axes, the rank none."""
    axes = {}
    for t in lora.targets:
        rows, cols = _LAYOUTS[t]
        a = ("layers", "embed", None) if rows == "in_embed" \
            else ("layers", "heads", "kv", None)
        b = ("layers", None, "heads", "kv") if cols == "out_heads" \
            else ("layers", None, "embed")
        axes[t] = {"a": a, "b": b}
    return axes


def _pair_shapes(cfg: TransformerConfig, lora: LoRAConfig, t: str,
                 lead: Tuple[int, ...]) -> Tuple[Tuple[int, ...], ...]:
    """(a, b) shapes of target `t` behind the leading axes `lead`."""
    if t not in _LAYOUTS:
        raise ValueError(f"unsupported LoRA target {t!r}; "
                         f"known: {sorted(_LAYOUTS)}")
    d, r = cfg.d_model, lora.rank
    heads = cfg.n_heads if t in ("wq", "wo") else cfg.n_kv_heads
    if _LAYOUTS[t][0] == "in_embed":
        return lead + (d, r), lead + (r, heads, cfg.head_dim)
    return lead + (heads, cfg.head_dim, r), lead + (r, d)


def init_lora_params(generator: torch.Generator, cfg: TransformerConfig,
                     lora: LoRAConfig, device: DeviceLike = None) -> Params:
    """a ~ N(0, 1/fan_in), b = 0 — adapters start as identity.  Draws
    come from `generator` (on `device`), so they differ from jax.random's."""
    dev = resolve_device(device)
    out = {}
    for t in lora.targets:
        a_shape, b_shape = _pair_shapes(cfg, lora, t, (cfg.n_layers,))
        fan_in = a_shape[1] if len(a_shape) == 3 \
            else a_shape[1] * a_shape[2]
        a = torch.randn(a_shape, generator=generator, device=dev) \
            * fan_in ** -0.5
        out[t] = {"a": a.to(cfg.param_dtype),
                  "b": torch.zeros(b_shape, dtype=cfg.param_dtype,
                                   device=dev)}
    return out


def random_lora_params(generator: torch.Generator, cfg: TransformerConfig,
                       lora: LoRAConfig, scale: float = 0.05,
                       device: DeviceLike = None) -> Params:
    """Adapter with NONZERO a and b — a distinct function, not the
    identity `init_lora_params` trains from.  Tests and the chip smoke use
    this to make per-adapter outputs actually differ."""
    params = init_lora_params(generator, cfg, lora, device)
    for t in sorted(params):
        b = params[t]["b"]
        params[t]["b"] = (torch.randn(b.shape, generator=generator,
                                      device=b.device)
                          * scale).to(b.dtype)
    return params


# -- gathered adapters --------------------------------------------------------
# All resident adapters live in fixed-capacity stacked planes, and a batched
# forward gathers each slot's pair by index, so heterogeneous-adapter
# requests share one forward.  Plane axis order is [L, A, ...]: the layer
# axis leads, as in params["layers"], and `layer_planes` slices it.

def plane_shapes(cfg: TransformerConfig, lora: LoRAConfig,
                 capacity: int) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Stacked-plane shapes for `capacity` adapter slots."""
    out = {}
    for t in lora.targets:
        a, b = _pair_shapes(cfg, lora, t, (cfg.n_layers, capacity))
        out[t] = {"a": a, "b": b}
    return out


def init_adapter_planes(cfg: TransformerConfig, lora: LoRAConfig,
                        capacity: int, device: DeviceLike = None) -> Params:
    """Zeroed stacked planes: every slot starts as the null adapter
    (delta exactly 0 — slot 0 stays that way forever)."""
    dev = resolve_device(device)
    return {t: {k: torch.zeros(s, dtype=cfg.param_dtype, device=dev)
                for k, s in pair.items()}
            for t, pair in plane_shapes(cfg, lora, capacity).items()}


def write_adapter_slot(planes: Params, slot: int, adapter: Params) -> Params:
    """Hot-load one adapter into plane slot `slot`, in place; returns
    `planes`.  The adapter tree is init_lora_params-shaped: {target: {a:
    [L, ...], b: [L, ...]}}.  Targets and shapes are checked before any
    write, so a mismatched adapter leaves the planes as they were."""
    for t, pair in adapter.items():
        if t not in planes:
            raise ValueError(f"adapter targets {sorted(adapter)} do not "
                             f"match the planes' {sorted(planes)}")
        for k in ("a", "b"):
            want = planes[t][k][:, slot].shape
            if tuple(pair[k].shape) != tuple(want):
                raise ValueError(
                    f"adapter {t}.{k} has shape {tuple(pair[k].shape)}, "
                    f"the planes take {tuple(want)}")
    for t, pair in adapter.items():
        for k in ("a", "b"):
            planes[t][k][:, slot] = pair[k].to(planes[t][k].dtype)
    return planes


def clear_adapter_slot(planes: Params, slot: int) -> Params:
    """Evict: zero a slot back to the null adapter, in place."""
    for pair in planes.values():
        pair["a"][:, slot] = 0.0
        pair["b"][:, slot] = 0.0
    return planes


def stack_adapters(adapters: Sequence[Params], cfg: TransformerConfig,
                   lora: LoRAConfig) -> Params:
    """Stack N adapter trees into [L, A, ...] planes (A = len(...))."""
    if not adapters:
        raise ValueError("need at least one adapter to stack")
    return {t: {k: torch.stack([ad[t][k] for ad in adapters], dim=1)
                for k in ("a", "b")}
            for t in adapters[0]}


def layer_planes(planes: Params, i: int) -> Params:
    """Layer i's slice of the stacked planes (views, no copy)."""
    return {t: {k: v[i] for k, v in pair.items()}
            for t, pair in planes.items()}


def gathered_delta(t: str, h: torch.Tensor, planes: Params,
                   idx: torch.Tensor, scale: float) -> torch.Tensor:
    """Per-slot low-rank delta for target `t`, one batched application.

    `h` is the projection input [B, S, d] (in_embed targets wq/wk/wv) or
    the attention output [B, S, H, Dh] (wo); `planes[t]` holds ONE layer's
    stacked pair (a: [A, rows..., r], b: [A, r, cols...], `layer_planes`);
    `idx` [B] gathers each lane's adapter.  Lanes on the null slot 0
    contribute exactly 0.  Accumulates in f32 and casts to h.dtype; the
    caller adds the result to the base projection."""
    a = planes[t]["a"][idx].float()         # [B, rows..., r]
    b = planes[t]["b"][idx].float()         # [B, r, cols...]
    if _LAYOUTS[t][0] == "in_embed":
        t1 = torch.einsum("bsd,bdr->bsr", h.float(), a)
        t2 = torch.einsum("bsr,brhk->bshk", t1, b)
    else:
        t1 = torch.einsum("bshk,bhkr->bsr", h.float(), a)
        t2 = torch.einsum("bsr,brd->bsd", t1, b)
    return (t2 * scale).to(h.dtype)


def merge_lora(base_layers: Params, lora_params: Params,
               lora: LoRAConfig) -> Params:
    """Layers tree with effective weights w + (a@b)*scale (new tensors for
    the targets; every other leaf is the base's own)."""
    merged = dict(base_layers)
    for t, adapter in lora_params.items():
        a = adapter["a"].float()
        b = adapter["b"].float()
        if _LAYOUTS[t][0] == "in_embed":
            delta = torch.einsum("ldr,lrhk->ldhk", a, b)
        else:
            delta = torch.einsum("lhkr,lrd->lhkd", a, b)
        merged[t] = base_layers[t] + (delta * lora.scale).to(
            base_layers[t].dtype)
    return merged


def lora_loss_fn(lora_params: Params, base_params: Params,
                 batch: Dict[str, torch.Tensor], cfg: TransformerConfig,
                 lora: LoRAConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The transformer loss on the base with the adapters merged in; only
    `lora_params` carry gradients."""
    params = dict(base_params)
    params["layers"] = merge_lora(base_params["layers"], lora_params, lora)
    return base_loss_fn(params, batch, cfg)


def lora_spec(base_params: Params, cfg: TransformerConfig,
              lora: LoRAConfig):
    """ModelSpec training only the adapters.  The base is held detached
    (views of the caller's tensors, no copy, no gradient) and must lie on
    the trainer's device."""
    from cloudtik_tpu_torch.train.trainer import ModelSpec
    from cloudtik_tpu_torch.tree import tree_map

    base = tree_map(lambda p: p.detach(), base_params)
    return ModelSpec(
        init=lambda gen, device: init_lora_params(gen, cfg, lora, device),
        loss_fn=lambda p, batch: lora_loss_fn(p, base, batch, cfg, lora),
        logical_axes=lora_logical_axes(cfg, lora),
        # frozen base: the backward computes activation grads only (~2N),
        # not weight grads, 4N in all against full training's 6N
        flops_per_token=cfg.flops_per_token() * 4.0 / 6.0,
    )
