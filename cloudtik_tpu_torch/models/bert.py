"""BERT encoder in PyTorch: masked-LM pretraining and a classification head.

Counterpart of `cloudtik_tpu/models/bert.py`: the same `BertConfig` and
presets, the same nested parameter dict with the stacked `[L, ...]` layer
layout and key names (so `convert.params_from_jax` is a plain copy),
bidirectional attention (causal=False), learned positions, post-LN GELU
blocks and a pooled classification path.  The layers run as a Python loop
over the stack; attention dispatches to the Hopper flash kernels on the
card (ops/attention.py: bf16 with head_dim 64 takes them), as the
reference's reaches its Pallas kernel.

Behaviours kept from the reference: the embedding sum (token, position,
type row 0 when no `type_ids`) runs in the param dtype and is cast to
`cfg.dtype` before the embedding LayerNorm; LayerNorm computes in f32
with eps 1e-12 and casts after the scale and bias; GELU is the tanh form;
the MLM head is an f32 product tied to the token embedding and does not
add `mlm_bias`, although `init_params` makes it.

Remat differs in what it keeps, not in what it computes: the reference
checkpoints each layer under `dots_with_no_batch_dims_saveable` (it keeps
the projection matmuls' outputs and recomputes the rest, the attention
kernel's forward included).  Here a layer runs as two checkpointed parts
around an attention call outside any checkpoint, as the transformer's
`save_attn` does: attention keeps q, k, v, o and lse and never re-runs its
forward kernel, and the projections are recomputed in the backward pass.

On a mesh (`param_logical_axes`, the reference's tree) a rank holds its
rows of the batch and reads every parameter whole: the stack's fsdp
shards are gathered one layer at a time where the layer reads them
(`layer_params` gives a `fsdp.LazyLayer`, as the transformer's does), and
the trainer gathers every other split before the loss.  A `seq` rank reads
whole sequences (the reference's activation constraints on `seq` are the
port's checked no-ops).  The MLM loss is the global sum of the nll over
the global count of valid labels, never a mean of per-rank means; the
classifier's is a mean over the global batch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from cloudtik_tpu_torch.device import DeviceLike, resolve_device
from cloudtik_tpu_torch.models.transformer import _checkpoint, _stack_layer
from cloudtik_tpu_torch.ops.attention import attention
from cloudtik_tpu_torch.parallel import collectives
from cloudtik_tpu_torch.parallel.mesh import DATA_AXES
from cloudtik_tpu_torch.parallel.sharding import with_sharding_constraint

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30_522
    d_model: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    d_ff: int = 4096
    max_seq_len: int = 512
    type_vocab_size: int = 2
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    num_labels: int = 0          # >0 adds a classification head
    attention_impl: Optional[str] = None  # None=auto, "flash", "reference"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def num_params(self) -> int:
        d, f, L = self.d_model, self.d_ff, self.n_layers
        per_layer = 4 * d * d + 2 * d * f + 9 * d  # qkv+o, ffn, norms+bias
        embed = (self.vocab_size + self.max_seq_len
                 + self.type_vocab_size) * d
        return L * per_layer + embed + 2 * d

    def flops_per_token(self) -> float:
        n = self.num_params() - self.vocab_size * self.d_model
        attn = 12 * self.n_layers * self.d_model * self.max_seq_len
        return 6 * n + attn


# The JAX package's presets, same names and values.
PRESETS: Dict[str, BertConfig] = {
    "bert_large": BertConfig(),
    "bert_base": BertConfig(d_model=768, n_layers=12, n_heads=12,
                            d_ff=3072),
    "tiny": BertConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                       d_ff=128, max_seq_len=128, remat=False),
}


def config(name: str, **overrides) -> BertConfig:
    return dataclasses.replace(PRESETS[name], **overrides)


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def param_logical_axes(cfg: BertConfig) -> Params:
    """The reference's logical axes, leaf for leaf (the stack on
    `layers`)."""
    layers = {
        "wq": ("layers", "embed", "heads", "kv"),
        "wk": ("layers", "embed", "heads", "kv"),
        "wv": ("layers", "embed", "heads", "kv"),
        "wo": ("layers", "heads", "kv", "embed"),
        "bq": ("layers", "heads", "kv"),
        "bk": ("layers", "heads", "kv"),
        "bv": ("layers", "heads", "kv"),
        "bo": ("layers", "norm"),
        "ln1_scale": ("layers", "norm"),
        "ln1_bias": ("layers", "norm"),
        "w_ff1": ("layers", "embed", "mlp"),
        "b_ff1": ("layers", "mlp"),
        "w_ff2": ("layers", "mlp", "embed"),
        "b_ff2": ("layers", "norm"),
        "ln2_scale": ("layers", "norm"),
        "ln2_bias": ("layers", "norm"),
    }
    axes: Params = {
        "embed": ("vocab", "embed"),
        "pos_embed": (None, "embed"),
        "type_embed": (None, "embed"),
        "embed_ln_scale": ("norm",),
        "embed_ln_bias": ("norm",),
        "layers": layers,
        "mlm_dense": ("embed", "embed"),
        "mlm_bias": ("norm",),
        "mlm_ln_scale": ("norm",),
        "mlm_ln_bias": ("norm",),
        "mlm_out_bias": ("vocab",),
    }
    if cfg.num_labels:
        axes["pooler"] = ("embed", "embed")
        axes["pooler_bias"] = ("norm",)
        axes["cls"] = ("embed", None)
        axes["cls_bias"] = (None,)
    return axes


def init_params(generator: torch.Generator, cfg: BertConfig,
                device: DeviceLike = None) -> Params:
    """Same shapes and dtypes as the JAX `init_params`: BERT's N(0, 0.02)
    truncated at two standard deviations (not fan-in scaled), zero biases,
    unit LayerNorm scales, in `param_dtype`.  Draws come from `generator`
    (on `device`), so they differ from jax.random's."""
    dev = resolve_device(device)
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    H, Dh = cfg.n_heads, cfg.head_dim
    pdt = cfg.param_dtype

    def dense(shape):
        w = torch.empty(shape, device=dev, dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return (w * 0.02).to(pdt)

    def zeros(shape):
        return torch.zeros(shape, device=dev, dtype=pdt)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=pdt)

    layers = {
        "wq": dense((L, d, H, Dh)),
        "wk": dense((L, d, H, Dh)),
        "wv": dense((L, d, H, Dh)),
        "wo": dense((L, H, Dh, d)),
        "bq": zeros((L, H, Dh)),
        "bk": zeros((L, H, Dh)),
        "bv": zeros((L, H, Dh)),
        "bo": zeros((L, d)),
        "ln1_scale": ones((L, d)),
        "ln1_bias": zeros((L, d)),
        "w_ff1": dense((L, d, f)),
        "b_ff1": zeros((L, f)),
        "w_ff2": dense((L, f, d)),
        "b_ff2": zeros((L, d)),
        "ln2_scale": ones((L, d)),
        "ln2_bias": zeros((L, d)),
    }
    params: Params = {
        "embed": dense((cfg.vocab_size, d)),
        "pos_embed": dense((cfg.max_seq_len, d)),
        "type_embed": dense((cfg.type_vocab_size, d)),
        "embed_ln_scale": ones((d,)),
        "embed_ln_bias": zeros((d,)),
        "layers": layers,
        "mlm_dense": dense((d, d)),
        "mlm_bias": zeros((d,)),
        "mlm_ln_scale": ones((d,)),
        "mlm_ln_bias": zeros((d,)),
        "mlm_out_bias": zeros((cfg.vocab_size,)),
    }
    if cfg.num_labels:
        params["pooler"] = dense((d, d))
        params["pooler_bias"] = zeros((d,))
        params["cls"] = dense((d, cfg.num_labels))
        params["cls_bias"] = zeros((cfg.num_labels,))
    return params


def layer_params(params: Params, i: int) -> Params:
    """Layer i's slice of the stacked layer parameters (views, no copy);
    a stack with leaves split over `fsdp` gives a `LazyLayer`, which
    gathers each leaf's slice where the layer reads it."""
    return _stack_layer(params["layers"], i)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def _dense(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           cfg: BertConfig) -> torch.Tensor:
    """h [..., k] x w [k, *out] + b [*out], in cfg.dtype."""
    w = w.to(cfg.dtype)
    out = h @ w.reshape(w.shape[0], -1)
    return out.reshape(*h.shape[:-1], *w.shape[1:]) + b.to(cfg.dtype)


def _attn_inputs(cfg: BertConfig, x: torch.Tensor, layer: Params
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v [B, S, H, Dh] with their biases."""
    q = with_sharding_constraint(_dense(x, layer["wq"], layer["bq"], cfg),
                                 "batch", "seq", "heads", None)
    return (q, _dense(x, layer["wk"], layer["bk"], cfg),
            _dense(x, layer["wv"], layer["bv"], cfg))


def _attend(cfg: BertConfig, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    # BHSD views for the kernel, which takes the strides as they are
    o = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  causal=False, implementation=cfg.attention_impl)
    return o.transpose(1, 2)  # back to [B, S, H, Dh]


def _layer_out(cfg: BertConfig, x: torch.Tensor, o: torch.Tensor,
               layer: Params) -> torch.Tensor:
    """The layer after attention: output projection, residual, LN, FFN,
    residual, LN."""
    B, S, d = x.shape
    attn = _dense(o.reshape(B, S, -1), layer["wo"].reshape(-1, d),
                  layer["bo"], cfg)
    x = _layer_norm(x + attn, layer["ln1_scale"], layer["ln1_bias"],
                    cfg.norm_eps)
    h = _dense(x, layer["w_ff1"], layer["b_ff1"], cfg)
    h = F.gelu(h, approximate="tanh")
    h = with_sharding_constraint(h, "batch", "seq", "mlp")
    h = _dense(h, layer["w_ff2"], layer["b_ff2"], cfg)
    x = _layer_norm(x + h, layer["ln2_scale"], layer["ln2_bias"],
                    cfg.norm_eps)
    return with_sharding_constraint(x, "batch", "seq", None)


def _layer(cfg: BertConfig, x: torch.Tensor, layer: Params) -> torch.Tensor:
    return _layer_out(cfg, x, _attend(cfg, *_attn_inputs(cfg, x, layer)),
                      layer)


def _remat_layer(cfg: BertConfig, x: torch.Tensor,
                 layer: Params) -> torch.Tensor:
    """One layer as two checkpointed parts around an attention call that
    sits outside any checkpoint (the module docstring says why)."""
    q, k, v = _checkpoint(functools.partial(_attn_inputs, cfg), x, layer)
    o = _attend(cfg, q, k, v)
    return _checkpoint(functools.partial(_layer_out, cfg), x, o, layer)


def encode(params: Params, tokens: torch.Tensor, cfg: BertConfig,
           type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, S] int -> hidden [B, S, d] (cfg.dtype), on the
    parameters' device."""
    S = tokens.shape[1]
    x = params["embed"][tokens]
    x = x + params["pos_embed"][:S][None]
    if type_ids is not None:
        x = x + params["type_embed"][type_ids]
    else:
        x = x + params["type_embed"][0][None, None]
    x = _layer_norm(x.to(cfg.dtype), params["embed_ln_scale"],
                    params["embed_ln_bias"], cfg.norm_eps)
    x = with_sharding_constraint(x, "batch", "seq", None)
    layer_fn = _remat_layer if cfg.remat and torch.is_grad_enabled() \
        else _layer
    for i in range(cfg.n_layers):
        x = layer_fn(cfg, x, layer_params(params, i))
    return x


def mlm_logits(params: Params, hidden: torch.Tensor,
               cfg: BertConfig) -> torch.Tensor:
    """Masked-LM head tied to the token embedding, in f32: [..., d] ->
    [..., V].  `mlm_bias` is not added, as in the reference."""
    h = hidden.float() @ params["mlm_dense"].float()
    h = F.gelu(h, approximate="tanh")
    h = _layer_norm(h, params["mlm_ln_scale"], params["mlm_ln_bias"],
                    cfg.norm_eps)
    return h @ params["embed"].float().T + params["mlm_out_bias"].float()


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: BertConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MLM objective.  batch: tokens [B, S] and either the gathered layout
    mlm_positions [B, P] + mlm_labels [B, P] (the vocab projection runs on
    the P positions only) or labels [B, S]; -100 labels are ignored;
    optional type_ids [B, S].  Returns (loss, {"loss", "mlm_accuracy"}),
    the metrics detached.  On a mesh the batch is this rank's rows and
    the loss the global sum over the global count."""
    hidden = encode(params, batch["tokens"], cfg, batch.get("type_ids"))
    if "mlm_positions" in batch:
        positions = batch["mlm_positions"]                 # [B, P]
        labels = batch["mlm_labels"]                       # [B, P]
        hidden = torch.gather(hidden, 1, positions[..., None].expand(
            -1, -1, hidden.shape[-1]))                     # [B, P, d]
    else:
        labels = batch["labels"]
    logits = mlm_logits(params, hidden, cfg)
    valid = labels != -100
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits, dim=-1)
    token_logp = logp.gather(-1, safe[..., None])[..., 0]
    n_valid = torch.clamp(collectives.all_reduce(valid.sum(), DATA_AXES),
                          min=1)
    loss = collectives.reduce_sum(-(token_logp * valid).sum(),
                                  DATA_AXES) / n_valid
    correct = (logits.argmax(dim=-1) == labels) & valid
    return loss, {"loss": loss.detach(),
                  "mlm_accuracy": collectives.all_reduce(
                      correct.sum(), DATA_AXES) / n_valid}


def classify_loss_fn(params: Params, batch: Dict[str, torch.Tensor],
                     cfg: BertConfig
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sequence classification (the fine-tune path; needs num_labels > 0).
    batch: tokens [B, S], labels [B], optional type_ids."""
    hidden = encode(params, batch["tokens"], cfg, batch.get("type_ids"))
    pooled = torch.tanh(hidden[:, 0].float() @ params["pooler"].float()
                        + params["pooler_bias"].float())
    logits = pooled @ params["cls"].float() + params["cls_bias"].float()
    labels = batch["labels"]
    logp = torch.log_softmax(logits, dim=-1)
    loss = collectives.batch_mean(-logp.gather(-1, labels[:, None]))
    return loss, {"loss": loss.detach(),
                  "accuracy": collectives.batch_mean(
                      (logits.argmax(dim=-1) == labels).float())}
