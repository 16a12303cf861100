"""Decoder-only transformer (Llama-family), dense, in PyTorch: forward,
remat and the chunked training loss.

Counterpart of `cloudtik_tpu/models/transformer.py`.  Parameters are the
same nested dict with the same stacked `[L, ...]` layer layout and key
names as the JAX `init_params` (so `convert.params_from_jax` is a plain
copy); the layers run as a Python loop over that stack.  Attention
dispatches to the Hopper flash kernels on the card (ops/attention.py).
Matmuls take bf16 operands; RMSNorm, RoPE and the softmax run in f32.

Not here yet: MoE (`n_experts > 1`) and the pipeline come with the
parallel slice.  JAX's sharding constraints have no counterpart on one
card; its checkpoint names become the layer split of `_remat_layer`.
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
    # them (the layers are a Python loop, not a scan; MoE and the pipeline
    # come with the parallel slice).
    remat: bool = True                 # recompute layers in the backward
    remat_policy: str = "save_attn"    # "save_attn" | "full" | "dots"
    scan_unroll: int = 1               # (not read)
    attention_impl: Optional[str] = None  # None=auto, "flash", "reference"
    n_experts: int = 1                 # > 1 (MoE) raises
    moe_top_k: int = 2                 # (not read)
    moe_capacity_factor: float = 1.25  # (not read)
    pipeline_microbatches: int = 0     # (not read)
    pipeline_schedule: str = "gpipe"   # (not read)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 1

    def flops_per_token(self) -> float:
        """Approximate training FLOPs per token (fwd+bwd), 6N_active.

        Counts matmul params (incl. the lm-head projection) plus the
        attention score/value matmuls; embedding gather excluded.
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


def _check_dense(cfg: TransformerConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError(
            "MoE layers are not ported yet (parallel slice)")


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: TransformerConfig,
                device: DeviceLike = None) -> Params:
    """Same shapes and dtypes as the JAX `init_params`: truncated normal in
    [-2, 2] times fan_in**-0.5, in `param_dtype`.  Draws come from
    `generator` (on `device`), so they differ from jax.random's."""
    _check_dense(cfg)
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
        "w_gate": dense_init((L, d, f), d),
        "w_up": dense_init((L, d, f), d),
        "w_down": dense_init((L, f, d), f),
    }
    params["final_norm"] = ones((d,))
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((d, cfg.vocab_size), d)
    return params


def layer_params(params: Params, i: int) -> Params:
    """Layer i's slice of the stacked layer parameters (views, no copy)."""
    return {k: w[i] for k, w in params["layers"].items()}


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


def _embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                  cfg: TransformerConfig) -> torch.Tensor:
    """Token embedding gather (the one-hot path of the JAX package is for
    vocab-sharded meshes and comes with the parallel slice)."""
    return embed[tokens].to(cfg.dtype)


def _proj(h: torch.Tensor, w: torch.Tensor,
          cfg: TransformerConfig) -> torch.Tensor:
    """h [..., d] x w [d, *out] -> [..., *out] in cfg.dtype."""
    w = w.to(cfg.dtype)
    out = h @ w.reshape(w.shape[0], -1)
    return out.reshape(*h.shape[:-1], *w.shape[1:])


def _mlp(h: torch.Tensor, layer: Params,
         cfg: TransformerConfig) -> torch.Tensor:
    """Dense SwiGLU."""
    gate = _proj(h, layer["w_gate"], cfg)
    up = _proj(h, layer["w_up"], cfg)
    return _proj(F.silu(gate) * up, layer["w_down"], cfg)


def _attn_inputs(cfg: TransformerConfig, x: torch.Tensor, layer: Params,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The layer up to attention: post-RoPE q, k, v, [B, S, heads, Dh]."""
    h = _rms_norm(x, layer["ln_attn"], cfg.norm_eps)
    q = _rope(_proj(h, layer["wq"], cfg), positions, cfg.rope_theta)
    k = _rope(_proj(h, layer["wk"], cfg), positions, cfg.rope_theta)
    v = _proj(h, layer["wv"], cfg)
    return q, k, v


def _attend(cfg: TransformerConfig, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    # BHSD views for the kernel, which takes the strides as they are
    o = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  causal=True, implementation=cfg.attention_impl)
    return o.transpose(1, 2)  # back to [B, S, H, Dh]


def _layer_out(cfg: TransformerConfig, x: torch.Tensor, o: torch.Tensor,
               layer: Params) -> torch.Tensor:
    """The layer after attention: output projection, residual, MLP."""
    B, S, d = x.shape
    wo = layer["wo"].to(cfg.dtype)
    x = x + o.reshape(B, S, -1) @ wo.reshape(-1, d)
    h = _rms_norm(x, layer["ln_mlp"], cfg.norm_eps)
    return x + _mlp(h, layer, cfg)


def _layer(cfg: TransformerConfig, x: torch.Tensor, layer: Params,
           positions: torch.Tensor) -> torch.Tensor:
    q, k, v = _attn_inputs(cfg, x, layer, positions)
    return _layer_out(cfg, x, _attend(cfg, q, k, v), layer)


def _checkpoint(fn, *args):
    # the layers draw no random numbers: no RNG state to keep
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _remat_layer(cfg: TransformerConfig, x: torch.Tensor, layer: Params,
                 positions: torch.Tensor) -> torch.Tensor:
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
    """tokens [B, S] int -> final-norm hidden states [B, S, d] + aux
    (empty: aux carries MoE router losses, not ported yet)."""
    _check_dense(cfg)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = _embed_lookup(params["embed"], tokens, cfg)
    layer_fn = _remat_layer if cfg.remat and torch.is_grad_enabled() \
        else _layer
    for i in range(cfg.n_layers):
        x = layer_fn(cfg, x, layer_params(params, i), positions)
    return _rms_norm(x, params["final_norm"], cfg.norm_eps), {}


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
    "accuracy"}), the metrics detached.

    The cross entropy runs over sequence chunks (`_chunk_size`), each under
    a checkpoint, so the full [B, S, vocab] f32 logits are never resident
    (2 GB at B=8, S=2048) and each chunk's logits are recomputed in the
    backward pass, as in the JAX package.
    """
    x, _ = hidden_states(params, batch["tokens"], cfg)
    head = _lm_head(params, cfg).to(cfg.dtype).float()
    labels = batch["labels"]
    S = x.shape[1]
    C = _chunk_size(S)
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    n_valid = torch.zeros((), dtype=torch.int64, device=x.device)
    n_correct = torch.zeros((), dtype=torch.int64, device=x.device)
    for c0 in range(0, S, C):
        args = (x[:, c0:c0 + C], labels[:, c0:c0 + C], head)
        if torch.is_grad_enabled():
            nll, nv, nc = _checkpoint(_chunk_stats, *args)
        else:
            nll, nv, nc = _chunk_stats(*args)
        loss_sum = loss_sum + nll
        n_valid = n_valid + nv
        n_correct = n_correct + nc
    n_valid = torch.clamp(n_valid, min=1)
    loss = loss_sum / n_valid
    metrics = {"loss": loss.detach(), "n_tokens": n_valid,
               "accuracy": n_correct / n_valid}
    return loss, metrics
