"""DLRM in PyTorch: the deep learning recommendation model.

Counterpart of `cloudtik_tpu/models/dlrm.py`: the same `DLRMConfig`,
presets, parameter counts and flop count, and the same parameter tree
(one stacked embedding tensor `[T, rows, dim]`, bottom and top MLPs as
lists of `{kernel, bias}`), so `convert.params_from_jax` is a plain copy.
Bottom MLP -> pairwise dot interaction over [dense + T] feature vectors
(the upper triangle, row-major as `jnp.triu_indices`) -> top MLP, in the
compute dtype.

Kept from the reference on purpose:

* The stacked table is cast to the compute dtype and then gathered, so in
  bf16 the backward's scatter-add runs on bf16 cotangents, as JAX's does.
* The gradient of the table is dense (the index's backward accumulates
  into a full-size tensor): AdamW on a sparse row gradient would leave
  the moments of untouched rows undecayed, a different optimizer.

On a mesh (`param_logical_axes`, the reference's tree) a rank holds its
rows of the batch.  The stacked tables, split over (expert, vocab, embed),
are gathered whole before the lookup (the trainer's gather; ranks along
`expert` read the same rows), where GSPMD shards the lookup itself; the
loss and accuracy are means over the global batch
(`collectives.batch_mean`), and the reference's batch constraints are the
port's checked no-ops.

Not ported: `embedding_backend()`, which probes a TPU embedding library.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from cloudtik_tpu_torch.device import DeviceLike, resolve_device
from cloudtik_tpu_torch.parallel import collectives
from cloudtik_tpu_torch.parallel.sharding import with_sharding_constraint

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    num_tables: int = 26                  # criteo sparse features
    rows_per_table: int = 100_000         # hashed vocabulary per feature
    embed_dim: int = 128
    num_dense: int = 13                   # criteo dense features
    bottom_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def num_params(self) -> int:
        n = self.num_tables * self.rows_per_table * self.embed_dim
        d_in = self.num_dense
        for d_out in self.bottom_mlp:
            n += d_in * d_out + d_out
            d_in = d_out
        d_in = self.interaction_dim()
        for d_out in self.top_mlp:
            n += d_in * d_out + d_out
            d_in = d_out
        return n

    def interaction_dim(self) -> int:
        f = self.num_tables + 1           # sparse features + dense vector
        return self.bottom_mlp[-1] + (f * (f - 1)) // 2

    def flops_per_example(self) -> float:
        """fwd+bwd (3x fwd) MLP FLOPs; embedding gathers are
        bandwidth-bound and excluded (standard DLRM accounting)."""
        flops = 0.0
        d_in = self.num_dense
        for d_out in self.bottom_mlp:
            flops += 2 * d_in * d_out
            d_in = d_out
        f = self.num_tables + 1
        flops += 2 * f * f * self.embed_dim       # interaction matmul
        d_in = self.interaction_dim()
        for d_out in self.top_mlp:
            flops += 2 * d_in * d_out
            d_in = d_out
        return 3.0 * flops


PRESETS: Dict[str, DLRMConfig] = {
    "criteo_terabyte": DLRMConfig(),
    "tiny": DLRMConfig(num_tables=4, rows_per_table=100, embed_dim=16,
                       num_dense=4, bottom_mlp=(32, 16),
                       top_mlp=(32, 16, 1)),
}


def config(name: str, **overrides) -> DLRMConfig:
    return dataclasses.replace(PRESETS[name], **overrides)


def param_logical_axes(cfg: DLRMConfig) -> Params:
    """The reference's logical axes: the table stack on (expert, vocab,
    embed), the MLPs on (embed, mlp)."""
    def mlp_axes(n):
        return [{"kernel": ("embed", "mlp"), "bias": ("mlp",)}
                for _ in range(n)]

    return {
        "embeddings": ("expert", "vocab", "embed"),
        "bottom": mlp_axes(len(cfg.bottom_mlp)),
        "top": mlp_axes(len(cfg.top_mlp)),
    }


def init_params(generator: torch.Generator, cfg: DLRMConfig,
                device: DeviceLike = None) -> Params:
    """Same tree, shapes and dtypes as the JAX `init_params`; draws come
    from `generator` (on `device`), so they differ from jax.random's."""
    dev = resolve_device(device)
    pdt = cfg.param_dtype

    def normal(shape, scale):
        w = torch.empty(shape, device=dev, dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return (w * scale).to(pdt)

    def mlp(d_in, widths):
        out = []
        for d_out in widths:
            out.append({"kernel": normal((d_in, d_out), (2.0 / d_in) ** 0.5),
                        "bias": torch.zeros((d_out,), device=dev,
                                            dtype=pdt)})
            d_in = d_out
        return out

    return {
        "embeddings": normal(
            (cfg.num_tables, cfg.rows_per_table, cfg.embed_dim),
            cfg.embed_dim ** -0.5),
        "bottom": mlp(cfg.num_dense, cfg.bottom_mlp),
        "top": mlp(cfg.interaction_dim(), cfg.top_mlp),
    }


def _mlp(x: torch.Tensor, layers, dtype, final_linear: bool) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = x @ layer["kernel"].to(dtype) + layer["bias"].to(dtype)
        if not (final_linear and i == len(layers) - 1):
            x = torch.relu(x)
    return x


def gather_embed(tables: torch.Tensor,
                 sparse_ids: torch.Tensor) -> torch.Tensor:
    """[T, R, D] tables at per-table ids [B, T] -> [B, T, D]: row
    ids[b, t] of table t.  Its backward scatter-adds into a dense
    [T, R, D] gradient in the tables' dtype."""
    T = tables.shape[0]
    tidx = torch.arange(T, device=tables.device)
    return tables[tidx[None, :], sparse_ids.long()]


def forward(params: Params, dense: torch.Tensor, sparse_ids: torch.Tensor,
            cfg: DLRMConfig) -> torch.Tensor:
    """dense [B, num_dense] f32; sparse_ids [B, T] int -> logits [B] f32."""
    dt = cfg.dtype
    d = _mlp(dense.to(dt), params["bottom"], dt, final_linear=False)
    d = with_sharding_constraint(d, "batch", None)

    # one gather over the stacked tables, cast first as the reference does
    e = gather_embed(params["embeddings"].to(dt), sparse_ids)   # [B,T,D]
    e = with_sharding_constraint(e, "batch", None, None)

    # pairwise dot interaction over [dense + T] feature vectors
    feats = torch.cat([d[:, None, :], e], dim=1)                # [B,F,D]
    inter = torch.einsum("bfd,bgd->bfg", feats, feats)          # [B,F,F]
    F_ = feats.shape[1]
    iu, ju = torch.triu_indices(F_, F_, 1, device=feats.device)
    inter_flat = inter[:, iu, ju]                               # [B,F(F-1)/2]

    top_in = torch.cat([d, inter_flat.to(dt)], dim=-1)
    out = _mlp(top_in, params["top"], dt, final_linear=True)
    return out[..., 0].float()


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: DLRMConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Click prediction.  batch: dense [B,num_dense], sparse_ids [B,T],
    labels [B] in {0,1} (this rank's rows on a mesh); the metrics
    detached."""
    logits = forward(params, batch["dense"], batch["sparse_ids"], cfg)
    labels = batch["labels"].float()
    loss = collectives.batch_mean(
        torch.clamp(logits, min=0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits))))
    preds = (logits > 0).float()
    return loss, {"loss": loss.detach(),
                  "accuracy": collectives.batch_mean(
                      (preds == labels).float())}
