"""Decoder-only transformer (Llama-family), dense, in PyTorch: forward,
remat and the chunked training loss.

Counterpart of `cloudtik_tpu/models/transformer.py`.  Parameters are the
same nested dict with the same stacked `[L, ...]` layer layout and key
names as the JAX `init_params` (so `convert.params_from_jax` is a plain
copy); the layers run as a Python loop over that stack.  Attention
dispatches to the Hopper flash kernels on the card (ops/attention.py).
Matmuls take bf16 operands; RMSNorm, RoPE and the softmax run in f32.

MoE layers (`n_experts > 1`) run `ops/moe.py`'s routed experts in place
of the dense MLP, and `hidden_states` returns their router losses averaged
over the layers.  On a mesh (parallel/sharding.py `use_mesh`) the model
reads its seq shard's global positions, attention takes the ring over
`seq`, `loss_fn` normalises by the global count of valid labels, and a
stacked leaf split over `fsdp` is gathered layer by layer where the layer
reads it (parallel/fsdp.py).

The `tensor` axis is Megatron's split, with the collectives GSPMD derives
from the reference's placements issued here: each rank holds its H/t heads
of wq/wk/wv/wo and its d_ff/t columns of the MLP (an expert's too), the
normed input enters a split block through `collectives.copy_to` (its
gradient summed over `tensor`) and the block's output is a partial sum
completed by `collectives.reduce_sum`.  RMSNorm and the router stay
replicated and get equal gradients on every tensor rank.  A block whose
weights did not divide runs whole on every rank.  The vocab splits too:
the embedding is a masked local lookup summed over `tensor`, and the loss
a vocab-parallel log-softmax (`_chunk_stats_split`).  The `pipe` axis runs
the layer stack as a pipeline (parallel/pipeline.py) in
`hidden_states`.  JAX's checkpoint names become the layer split of
`_remat_layer`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cloudtik_tpu_torch.device import DeviceLike, resolve_device
from cloudtik_tpu_torch.ops.attention import attention
from cloudtik_tpu_torch.ops.moe import MoEConfig, moe_ffn
from cloudtik_tpu_torch.parallel import collectives, fsdp, sharding
from cloudtik_tpu_torch.parallel.mesh import TOKEN_AXES
from cloudtik_tpu_torch.parallel.pipeline import (pipe_axis_size,
                                                  pipeline_apply)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 11_008
    max_seq_len: int = 4096
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16        # activation/compute dtype
    param_dtype: torch.dtype = torch.float32   # master param dtype
    tie_embeddings: bool = False
    # Fields marked "(not read)" are kept so that the presets and their
    # overrides carry over from the JAX package; the port does not read
    # them (the layers are a Python loop, not a scan).
    remat: bool = True                 # recompute layers in the backward
    remat_policy: str = "save_attn"    # "save_attn" | "full" | "dots"
    scan_unroll: int = 1               # (not read)
    attention_impl: Optional[str] = None  # None=auto, "flash",
    #                                       "reference", "ring"
    # n_experts > 1 turns every MLP into a routed MoE block (ops/moe.py)
    n_experts: int = 1
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    # on a pipe mesh: microbatches a step (0 = the stage count) and the
    # schedule, "gpipe" or "1f1b" (parallel/pipeline.py)
    pipeline_microbatches: int = 0
    pipeline_schedule: str = "gpipe"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 1

    def moe_config(self) -> MoEConfig:
        return MoEConfig(num_experts=self.n_experts, top_k=self.moe_top_k,
                         capacity_factor=self.moe_capacity_factor)

    def flops_per_token(self) -> float:
        """Approximate training FLOPs per token (fwd+bwd), 6N_active.

        Counts matmul params (incl. the lm-head projection; for MoE the
        top-k experts and the router) plus the attention score/value
        matmuls; the embedding gather and MoE's dispatch and combine
        einsums are not counted, as in the reference.
        """
        n_params = self.num_params(include_embed=False, active_only=True)
        n_params += self.d_model * self.vocab_size  # lm head (tied or not)
        attn = 12 * self.n_layers * self.d_model * self.max_seq_len
        return 6 * n_params + attn

    def num_params(self, include_embed: bool = True,
                   active_only: bool = False) -> int:
        d, f, L = self.d_model, self.d_ff, self.n_layers
        n_ffn = (min(self.moe_top_k, self.n_experts) if active_only
                 else self.n_experts)
        per_layer = (
            d * self.n_heads * self.head_dim            # wq
            + 2 * d * self.n_kv_heads * self.head_dim   # wk, wv
            + self.n_heads * self.head_dim * d          # wo
            + n_ffn * 3 * d * f                          # gate, up, down
            + (d * self.n_experts if self.is_moe else 0)  # router
            + 2 * d)                                     # norms
        total = L * per_layer + d                        # final norm
        if include_embed:
            total += self.vocab_size * d
            if not self.tie_embeddings:
                total += d * self.vocab_size
        return total


# The JAX package's presets, same names and values.  tpu_1b is the
# single-card flagship; tiny is for tests.
PRESETS: Dict[str, TransformerConfig] = {
    "llama2_7b": TransformerConfig(),
    "tpu_1b": TransformerConfig(
        vocab_size=32_000, d_model=2048, n_layers=16, n_heads=16,
        n_kv_heads=16, d_ff=5504, max_seq_len=2048),
    "tpu_120m": TransformerConfig(
        vocab_size=32_000, d_model=768, n_layers=12, n_heads=12,
        n_kv_heads=12, d_ff=2048, max_seq_len=1024),
    "tiny": TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128, remat=False),
    "tpu_70b": TransformerConfig(
        vocab_size=32_000, d_model=8192, n_layers=80, n_heads=64,
        n_kv_heads=8, d_ff=28_672, max_seq_len=4096),
    "tpu_405b": TransformerConfig(
        vocab_size=128_256, d_model=16_384, n_layers=126, n_heads=128,
        n_kv_heads=8, d_ff=53_248, max_seq_len=8192),
    "tpu_moe_8x1b": TransformerConfig(
        vocab_size=32_000, d_model=2048, n_layers=16, n_heads=16,
        n_kv_heads=16, d_ff=5504, max_seq_len=2048, n_experts=8),
    "tiny_moe": TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128, remat=False, n_experts=4),
}


def config(name: str, **overrides) -> TransformerConfig:
    return dataclasses.replace(PRESETS[name], **overrides)


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def param_logical_axes(cfg: TransformerConfig) -> Params:
    """Tree (same structure as params) of logical-axis tuples."""
    layers = {
        "wq": ("layers", "embed", "heads", "kv"),
        "wk": ("layers", "embed", "heads", "kv"),
        "wv": ("layers", "embed", "heads", "kv"),
        "wo": ("layers", "heads", "kv", "embed"),
        "ln_attn": ("layers", "norm"),
        "ln_mlp": ("layers", "norm"),
    }
    if cfg.is_moe:
        layers.update({
            "w_router": ("layers", "embed", None),
            "w_gate": ("layers", "expert", "embed", "mlp"),
            "w_up": ("layers", "expert", "embed", "mlp"),
            "w_down": ("layers", "expert", "mlp", "embed"),
        })
    else:
        layers.update({
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        })
    axes = {
        "embed": ("vocab", "embed"),
        "layers": layers,
        "final_norm": ("norm",),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def init_params(generator: torch.Generator, cfg: TransformerConfig,
                device: DeviceLike = None) -> Params:
    """Same shapes and dtypes as the JAX `init_params`: truncated normal in
    [-2, 2] times fan_in**-0.5, in `param_dtype`.  Draws come from
    `generator` (on `device`), so they differ from jax.random's."""
    dev = resolve_device(device)
    d, f = cfg.d_model, cfg.d_ff
    H, Hkv, Dh, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers

    def dense_init(shape, fan_in):
        w = torch.empty(shape, device=dev, dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return (w * (fan_in ** -0.5)).to(cfg.param_dtype)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=cfg.param_dtype)

    params = {"embed": dense_init((cfg.vocab_size, d), 1)}
    params["layers"] = {
        "wq": dense_init((L, d, H, Dh), d),
        "wk": dense_init((L, d, Hkv, Dh), d),
        "wv": dense_init((L, d, Hkv, Dh), d),
        "wo": dense_init((L, H, Dh, d), H * Dh),
        "ln_attn": ones((L, d)),
        "ln_mlp": ones((L, d)),
    }
    if cfg.is_moe:
        E = cfg.n_experts
        params["layers"].update({
            "w_router": dense_init((L, d, E), d),
            "w_gate": dense_init((L, E, d, f), d),
            "w_up": dense_init((L, E, d, f), d),
            "w_down": dense_init((L, E, f, d), f),
        })
    else:
        params["layers"].update({
            "w_gate": dense_init((L, d, f), d),
            "w_up": dense_init((L, d, f), d),
            "w_down": dense_init((L, f, d), f),
        })
    params["final_norm"] = ones((d,))
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((d, cfg.vocab_size), d)
    return params


def layer_params(params: Params, i: int) -> Params:
    """Layer i's slice of the stacked layer parameters (views, no copy);
    a stack with leaves split over `fsdp` gives a `LazyLayer`, which
    gathers each leaf's slice where the layer reads it."""
    return _stack_layer(params["layers"], i)


def _stack_layer(layers: Params, i: int) -> Params:
    if fsdp.has_shards(layers):
        return fsdp.LazyLayer(layers, i)
    return {k: w[i] for k, w in layers.items()}


def _stack_depth(layers: Params) -> int:
    """Layers in a stack (this rank's stage on a pipe mesh)."""
    w = next(iter(layers.values()))
    return (w.local if isinstance(w, fsdp.LayerShards) else w).shape[0]


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _rms_norm(x: torch.Tensor, scale: torch.Tensor,
              eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * scale.float()).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """Rotary embedding, half-split (not interleaved), in f32.
    x: [B, S, H, Dh]; positions: [B, S]."""
    Dh = x.shape[-1]
    half = Dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


TENSOR = ("tensor",)


def _vocab_start(v_local: int) -> int:
    """The first vocab row of this rank's slice over `tensor`."""
    return sharding.axis_rank("tensor") * v_local


def _embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                  cfg: TransformerConfig) -> torch.Tensor:
    """Token embedding lookup.  With the vocab split over `tensor` (this
    rank holds V/t rows), each rank looks up the tokens in its slice, zero
    elsewhere, and the sum over `tensor` completes the rows: the
    reference's one-hot contraction, whose every output is one product
    with 1.0, gives the same values.  The gradient (identity through the
    sum) lands on each rank's own rows."""
    V = embed.shape[0]
    if V == cfg.vocab_size:
        return embed[tokens].to(cfg.dtype)
    local = tokens - _vocab_start(V)
    mine = (local >= 0) & (local < V)
    rows = embed[local.clamp(0, V - 1)].to(cfg.dtype)
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return collectives.reduce_sum(rows, TENSOR)


def _proj(h: torch.Tensor, w: torch.Tensor,
          cfg: TransformerConfig) -> torch.Tensor:
    """h [..., d] x w [d, *out] -> [..., *out] in cfg.dtype."""
    w = w.to(cfg.dtype)
    out = h @ w.reshape(w.shape[0], -1)
    return out.reshape(*h.shape[:-1], *w.shape[1:])


def _ffn(h: torch.Tensor, layer: Params, cfg: TransformerConfig
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The MLP block: dense SwiGLU, or MoE's routed experts with their
    router losses.  With its d_ff columns split over `tensor` the input
    enters through `copy_to` and the output is summed over `tensor` (in
    `moe_ffn` for the experts)."""
    w_gate = layer["w_gate"]
    split = w_gate.shape[-1] != cfg.d_ff
    if cfg.is_moe:
        return moe_ffn(h, layer["w_router"], w_gate, layer["w_up"],
                       layer["w_down"], cfg.moe_config(),
                       tensor_split=split)
    if split:
        h = collectives.copy_to(h, TENSOR)
    gate = _proj(h, w_gate, cfg)
    up = _proj(h, layer["w_up"], cfg)
    down = _proj(F.silu(gate) * up, layer["w_down"], cfg)
    return (collectives.reduce_sum(down, TENSOR) if split else down), {}


def _mlp(h: torch.Tensor, layer: Params,
         cfg: TransformerConfig) -> torch.Tensor:
    """The MLP block's output (generation and serving drop the router
    losses)."""
    return _ffn(h, layer, cfg)[0]


def _local_kv(cfg: TransformerConfig, wq: torch.Tensor, wk: torch.Tensor,
              wv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """wk, wv for this rank's q heads when wq is split over `tensor`.

    Split alike (n_kv_heads divides t), each rank's kv heads are the ones
    its q heads read.  Kept whole (it does not), each rank takes the kv
    heads of its q heads h by h // group, through `copy_to` so that the
    whole leaf's gradient sums every rank's share."""
    H_loc, Hkv = wq.shape[-2], wk.shape[-2]
    if Hkv != cfg.n_kv_heads:
        return wk, wv
    group = cfg.n_heads // cfg.n_kv_heads
    h0 = sharding.axis_rank("tensor") * H_loc
    wk = collectives.copy_to(wk, TENSOR)
    wv = collectives.copy_to(wv, TENSOR)
    if H_loc % group == 0 or group % H_loc == 0:
        lo = h0 // group
        n = max(H_loc // group, 1)
        return wk[..., lo:lo + n, :], wv[..., lo:lo + n, :]
    idx = torch.div(torch.arange(h0, h0 + H_loc, device=wk.device), group,
                    rounding_mode="floor")
    return wk.index_select(-2, idx), wv.index_select(-2, idx)


def _attn_inputs(cfg: TransformerConfig, x: torch.Tensor, layer: Params,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The layer up to attention: post-RoPE q, k, v, [B, S, heads, Dh]
    (this rank's heads when they are split over `tensor`)."""
    h = _rms_norm(x, layer["ln_attn"], cfg.norm_eps)
    wq, wk, wv = layer["wq"], layer["wk"], layer["wv"]
    if wq.shape[-2] != cfg.n_heads:
        h = collectives.copy_to(h, TENSOR)
        wk, wv = _local_kv(cfg, wq, wk, wv)
    q = _rope(_proj(h, wq, cfg), positions, cfg.rope_theta)
    k = _rope(_proj(h, wk, cfg), positions, cfg.rope_theta)
    v = _proj(h, wv, cfg)
    return q, k, v


def _attend(cfg: TransformerConfig, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    # BHSD views for the kernel, which takes the strides as they are
    o = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  causal=True, implementation=cfg.attention_impl)
    return o.transpose(1, 2)  # back to [B, S, H, Dh]


def _layer_out(cfg: TransformerConfig, x: torch.Tensor, o: torch.Tensor,
               layer: Params
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The layer after attention: output projection, residual, MLP; with
    the MoE router losses (empty when dense)."""
    B, S, d = x.shape
    wo = layer["wo"]
    out = o.reshape(B, S, -1) @ wo.to(cfg.dtype).reshape(-1, d)
    if wo.shape[0] != cfg.n_heads:      # this rank's heads: a partial sum
        out = collectives.reduce_sum(out, TENSOR)
    x = x + out
    h = _rms_norm(x, layer["ln_mlp"], cfg.norm_eps)
    down, aux = _ffn(h, layer, cfg)
    return x + down, aux


def _layer(cfg: TransformerConfig, x: torch.Tensor, layer: Params,
           positions: torch.Tensor
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    q, k, v = _attn_inputs(cfg, x, layer, positions)
    return _layer_out(cfg, x, _attend(cfg, q, k, v), layer)


def _checkpoint(fn, *args):
    # the layers draw no random numbers: no RNG state to keep
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _remat_layer(cfg: TransformerConfig, x: torch.Tensor, layer: Params,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One layer under `cfg.remat_policy` (JAX: `_remat_policy`).

    save_attn: keeps the post-RoPE q, k, v, o and lse (JAX's names
      attn_qkv / attn_out / attn_lse) and recomputes the rest.  The layer
      runs as two checkpointed parts around an attention call that sits
      outside any checkpoint, so its autograd Function saves (q, k, v, o,
      lse) and the backward pass never re-runs the forward kernel; the
      checkpoints also keep their inputs (the layer input x, and o).
    full: recomputes the whole layer, the attention forward included.
    dots: no recomputation.  It saves more than JAX's "dots with no batch
      dims" policy (every activation, not only the matmul outputs); the
      gradients are the same.
    """
    policy = cfg.remat_policy
    if policy == "save_attn":
        q, k, v = _checkpoint(functools.partial(_attn_inputs, cfg), x,
                              layer, positions)
        o = _attend(cfg, q, k, v)
        return _checkpoint(functools.partial(_layer_out, cfg), x, o, layer)
    if policy == "full":
        return _checkpoint(functools.partial(_layer, cfg), x, layer,
                           positions)
    if policy == "dots":
        return _layer(cfg, x, layer, positions)
    raise ValueError(f"unknown remat_policy {policy!r}")


def hidden_states(
    params: Params,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens [B, S] int -> final-norm hidden states [B, S, d] + aux (the
    MoE router losses, each the mean over the layers; empty when dense).
    On a seq-sharded mesh tokens are this rank's slice of the sequence and
    the default positions are its global ones.  On a pipe mesh the stack
    runs as a pipeline of `cfg.pipeline_microbatches` (default: the stage
    count) under `cfg.pipeline_schedule`; positions ride with each
    microbatch, and MoE's losses are the mean over layers and microbatches
    of per-microbatch statistics, as in the reference."""
    B, S = tokens.shape
    if positions is None:
        start = sharding.axis_rank("seq") * S
        positions = (start + torch.arange(S, device=tokens.device)
                     ).expand(B, S)
    x = _embed_lookup(params["embed"], tokens, cfg)
    n_stages = pipe_axis_size()
    if n_stages > 1:
        n_micro = cfg.pipeline_microbatches or n_stages
        aux_init = dict.fromkeys(MOE_AUX, 0.0) if cfg.is_moe else None
        result = pipeline_apply(
            functools.partial(_stage, cfg), params["layers"], x,
            n_microbatches=n_micro, extras=positions, aux_init=aux_init,
            schedule=cfg.pipeline_schedule)
        if cfg.is_moe:
            x, aux_sum = result
            aux = {k: v / (cfg.n_layers * n_micro)
                   for k, v in aux_sum.items()}
        else:
            x, aux = result, {}
        return _rms_norm(x, params["final_norm"], cfg.norm_eps), aux
    layer_fn = _remat_layer if cfg.remat and torch.is_grad_enabled() \
        else _layer
    per_layer = []
    for i in range(cfg.n_layers):
        x, aux = layer_fn(cfg, x, layer_params(params, i), positions)
        per_layer.append(aux)
    aux = {k: torch.stack([a[k] for a in per_layer]).mean()
           for k in per_layer[0]} if per_layer and per_layer[0] else {}
    return _rms_norm(x, params["final_norm"], cfg.norm_eps), aux


MOE_AUX = ("moe_aux_loss", "moe_z_loss", "moe_drop_fraction")


def _stage(cfg: TransformerConfig, layers: Params, x: torch.Tensor,
           positions: torch.Tensor):
    """One pipeline stage: its layers over one microbatch; with MoE, the
    router losses summed over them.  Remat is chosen per call: the 1F1B
    forward runs under no_grad and its backward recomputes with grad."""
    layer_fn = _remat_layer if cfg.remat and torch.is_grad_enabled() \
        else _layer
    per_layer = []
    for i in range(_stack_depth(layers)):
        x, aux = layer_fn(cfg, x, _stack_layer(layers, i), positions)
        per_layer.append(aux)
    if not cfg.is_moe:
        return x
    return x, {k: torch.stack([a[k] for a in per_layer]).float().sum()
               for k in MOE_AUX}


def _lm_head(params: Params, cfg: TransformerConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def logits_f32(x: torch.Tensor, params: Params,
               cfg: TransformerConfig) -> torch.Tensor:
    """The logits product: cfg.dtype operands, f32 output.  JAX asks XLA
    for bf16 x bf16 with f32 output (preferred_element_type); a torch bf16
    matmul rounds its output to bf16, so the product runs in f32 on the
    operands already rounded to cfg.dtype, which is the same arithmetic."""
    head = _lm_head(params, cfg).to(cfg.dtype)
    return x.float() @ head.float()


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    positions: Optional[torch.Tensor] = None,
    return_aux: bool = False,
):
    """tokens [B, S] int -> logits [B, S, vocab] (f32).  Runs where the
    parameters and tokens lie."""
    x, aux = hidden_states(params, tokens, cfg, positions)
    logits = logits_f32(x, params, cfg)
    if return_aux:
        return logits, aux
    return logits


def _chunk_size(S: int, target: int = 512) -> int:
    """Largest divisor of S that is <= target (sequence-chunked loss).

    Falls back to a single chunk when S has no divisor of at least 64, as
    the JAX package does."""
    if S <= target:
        return S
    for c in range(target, 63, -1):
        if S % c == 0:
            return c
    return S


def _chunk_stats_split(x: torch.Tensor, labels: torch.Tensor,
                       head: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`_chunk_stats` with the vocab split over `tensor`: head is this
    rank's [d, V/t] columns, so its logits are [B, C, V/t].

    The log-softmax takes the max over the whole vocab (all-reduced, no
    gradient) and the sum of exps over `tensor` (`reduce_sum`, identity
    backward: every rank holds the whole loss and its cotangent); the
    token's shifted logit is picked on the rank that holds it and summed
    over `tensor`, which is the reference's one-hot contraction.  x came
    through `copy_to`, so its gradient sums the vocab slices.  Accuracy's
    argmax is the reference's, the first index over the whole vocab: the
    largest value over the ranks, the lowest global index on ties."""
    logits = x.float() @ head
    V = logits.shape[-1]
    v0 = _vocab_start(V)
    valid = labels != -100
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    m = collectives.all_reduce(logits.detach().amax(-1), TENSOR, op="max")
    shifted = logits - m[..., None]
    total = collectives.reduce_sum(shifted.exp().sum(-1), TENSOR)
    local = safe - v0
    mine = (local >= 0) & (local < V)
    picked = shifted.gather(-1, local.clamp(0, V - 1)[..., None].long())
    picked = torch.where(mine, picked[..., 0], torch.zeros_like(m))
    token_logp = collectives.reduce_sum(picked, TENSOR) - torch.log(total)
    best, where = logits.detach().max(-1)
    top = collectives.all_reduce(best, TENSOR, op="max")
    index = torch.where(best == top, where + v0,
                        torch.full_like(where, torch.iinfo(where.dtype).max))
    argmax = collectives.all_reduce(index, TENSOR, op="min")
    correct = (argmax == labels) & valid
    return -(token_logp * valid).sum(), valid.sum(), correct.sum()


def _chunk_stats(x: torch.Tensor, labels: torch.Tensor, head: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(summed nll, valid tokens, correct tokens) of one sequence chunk.
    head: the lm head rounded to cfg.dtype, held in f32 (`logits_f32`)."""
    logits = x.float() @ head
    valid = labels != -100
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits, dim=-1)
    token_logp = logp.gather(-1, safe[..., None].long())[..., 0]
    correct = (logits.argmax(dim=-1) == labels) & valid
    return -(token_logp * valid).sum(), valid.sum(), correct.sum()


def loss_fn(
    params: Params,
    batch: Dict[str, torch.Tensor],
    cfg: TransformerConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal LM loss.  batch: tokens [B, S], labels [B, S] (-100 = ignore),
    on the parameters' device.  Returns (loss, {"loss", "n_tokens",
    "accuracy"}, and for MoE the router losses and "loss_with_aux", the
    loss plus both router losses, which is what is returned to
    differentiate), the metrics detached.

    On a mesh the batch is this rank's shard: the loss is the global
    sum of the nll over the global count of valid labels (summed over the
    data, fsdp and seq axes; never a mean of per-rank means, since masked
    labels make the counts differ).  Its backward is each rank's own
    share, and the trainer sums the gradients over those axes.

    The cross entropy runs over sequence chunks (`_chunk_size`), each under
    a checkpoint, so the full [B, S, vocab] f32 logits are never resident
    (2 GB at B=8, S=2048) and each chunk's logits are recomputed in the
    backward pass, as in the JAX package.
    """
    x, aux = hidden_states(params, batch["tokens"], cfg)
    head = _lm_head(params, cfg).to(cfg.dtype).float()
    stats = _chunk_stats
    if head.shape[-1] != cfg.vocab_size:    # the vocab split over tensor
        stats = _chunk_stats_split
        x = collectives.copy_to(x, TENSOR)
    labels = batch["labels"]
    S = x.shape[1]
    C = _chunk_size(S)
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    n_valid = torch.zeros((), dtype=torch.int64, device=x.device)
    n_correct = torch.zeros((), dtype=torch.int64, device=x.device)
    for c0 in range(0, S, C):
        args = (x[:, c0:c0 + C], labels[:, c0:c0 + C], head)
        if torch.is_grad_enabled():
            nll, nv, nc = _checkpoint(stats, *args)
        else:
            nll, nv, nc = stats(*args)
        loss_sum = loss_sum + nll
        n_valid = n_valid + nv
        n_correct = n_correct + nc
    n_valid = torch.clamp(collectives.all_reduce(n_valid, TOKEN_AXES), min=1)
    n_correct = collectives.all_reduce(n_correct, TOKEN_AXES)
    loss = collectives.reduce_sum(loss_sum, TOKEN_AXES) / n_valid
    metrics = {"loss": loss.detach(), "n_tokens": n_valid,
               "accuracy": n_correct / n_valid}
    if aux:
        metrics.update({k: v.detach() for k, v in aux.items()})
        loss = loss + aux["moe_aux_loss"] + aux["moe_z_loss"]
        metrics["loss_with_aux"] = loss.detach()
    return loss, metrics
