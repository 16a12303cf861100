"""GraphSAGE node-representation model in PyTorch.

Counterpart of `cloudtik_tpu/models/graphsage.py`: the same config,
presets and parameter tree (`layers` as a list of `{w, b}`, `out`), so
`convert.params_from_jax` is a plain copy.  The graph arrives as a
static-shape padded adjacency table: `neighbors [N, K]` indices
(self-index padding) with a bool validity mask, sampled to a fixed
fan-out on the host.  A layer is mean-aggregate-then-project,
h' = relu([h | mean h_neigh] @ W + b), then an L2 normalisation.

Kept from the reference: the neighbour mean accumulates in f32 and is cast
back to the model dtype; the normalisation is `rsqrt(sum + 1e-12)` in f32.
Supervised node classification (`loss_fn`, over `train_mask`) and
unsupervised link prediction (`link_pred_loss`, sampled negatives).

On a mesh (`param_logical_axes`, the reference's tree) a rank holds its
rows of the block (features, neighbours, labels, masks; link prediction's
edges), while `neighbors` index rows of the whole block.  Each layer
gathers `h` over the batch axes in the order `data.local_batch` cuts rows
(`collectives.gather_rows`, whose backward sums every rank's use of a row
back to the rank that holds it), reads the neighbour rows from the whole
`h` and computes its own rows; link prediction reads its edges' ends from
the gathered embeddings.  The train-mask denominator, the link loss's mean
and `auc_proxy` over all pairs are global.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from cloudtik_tpu_torch.device import DeviceLike, resolve_device
from cloudtik_tpu_torch.parallel import collectives
from cloudtik_tpu_torch.parallel.mesh import DATA_AXES

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GraphSAGEConfig:
    in_dim: int = 128
    hidden_dim: int = 256
    num_layers: int = 3
    num_classes: int = 16
    max_degree: int = 10             # padded neighbor fan-out
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def flops_per_node(self) -> float:
        f, d = 0.0, self.in_dim
        for _ in range(self.num_layers):
            f += 2 * (2 * d) * self.hidden_dim
            d = self.hidden_dim
        f += 2 * d * self.num_classes
        return 3.0 * f


PRESETS = {
    "graphsage": GraphSAGEConfig(),
    "tiny": GraphSAGEConfig(in_dim=8, hidden_dim=16, num_layers=2,
                            num_classes=4, max_degree=4),
}


def config(name: str, **overrides) -> GraphSAGEConfig:
    return dataclasses.replace(PRESETS[name], **overrides)


def param_logical_axes(cfg: GraphSAGEConfig) -> Params:
    """The reference's logical axes: (embed, mlp) layers, an (embed,
    vocab) classifier."""
    return {
        "layers": [{"w": ("embed", "mlp"), "b": ("mlp",)}
                   for _ in range(cfg.num_layers)],
        "out": {"w": ("embed", "vocab"), "b": ("vocab",)},
    }


def init_params(generator: torch.Generator, cfg: GraphSAGEConfig,
                device: DeviceLike = None) -> Params:
    """Same tree, shapes and dtypes as the JAX `init_params`; draws come
    from `generator` (on `device`), so they differ from jax.random's."""
    dev = resolve_device(device)
    pdt = cfg.param_dtype

    def dense(i, o):
        w = torch.empty((i, o), device=dev, dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return {"w": (w * (2.0 / i) ** 0.5).to(pdt),
                "b": torch.zeros((o,), device=dev, dtype=pdt)}

    layers: List[Params] = []
    d = cfg.in_dim
    for _ in range(cfg.num_layers):
        layers.append(dense(2 * d, cfg.hidden_dim))
        d = cfg.hidden_dim
    return {"layers": layers, "out": dense(d, cfg.num_classes)}


def _aggregate(h: torch.Tensor, neighbors: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean of valid neighbor states.  h [N, D], neighbors [N, K] int,
    mask [N, K] bool -> [N, D] (f32 accumulation, h's dtype out)."""
    gathered = h[neighbors.long()].float()                  # [N, K, D]
    m = mask.float()[..., None]
    total = (gathered * m).sum(dim=1)
    count = torch.clamp(m.sum(dim=1), min=1.0)
    return (total / count).to(h.dtype)


def embed(params: Params, features: torch.Tensor, neighbors: torch.Tensor,
          mask: torch.Tensor, cfg: GraphSAGEConfig) -> torch.Tensor:
    """-> node embeddings [N, hidden] (model dtype): this rank's rows on a
    mesh, each layer's neighbours read from every rank's."""
    h = features.to(cfg.dtype)
    for layer in params["layers"]:
        agg = _aggregate(collectives.gather_rows(h), neighbors, mask)
        z = torch.cat([h, agg], dim=-1)
        h = z @ layer["w"].to(cfg.dtype) + layer["b"].to(cfg.dtype)
        h = torch.relu(h)
        # L2-normalise (the SAGE convention) in f32
        h32 = h.float()
        h = (h32 * torch.rsqrt((h32 * h32).sum(-1, keepdim=True)
                               + 1e-12)).to(cfg.dtype)
    return h


def forward(params: Params, features: torch.Tensor, neighbors: torch.Tensor,
            mask: torch.Tensor, cfg: GraphSAGEConfig) -> torch.Tensor:
    """-> class logits [N, num_classes] f32."""
    h = embed(params, features, neighbors, mask, cfg)
    out = params["out"]
    return (h @ out["w"].to(cfg.dtype)).float() + out["b"].float()


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: GraphSAGEConfig) -> Tuple[torch.Tensor,
                                           Dict[str, torch.Tensor]]:
    """Supervised node classification.  batch: features [N,F],
    neighbors [N,K] int, neighbor_mask [N,K] bool, labels [N] int,
    train_mask [N] bool; the metrics detached."""
    logits = forward(params, batch["features"], batch["neighbors"],
                     batch["neighbor_mask"], cfg)
    labels = batch["labels"].long()
    tmask = batch["train_mask"].float()
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, labels[:, None])[:, 0]
    denom = torch.clamp(collectives.all_reduce(tmask.sum(), DATA_AXES),
                        min=1.0)
    loss = collectives.reduce_sum((ce * tmask).sum(), DATA_AXES) / denom
    acc = collectives.all_reduce(
        ((logits.argmax(-1) == labels).float() * tmask).sum(),
        DATA_AXES) / denom
    return loss, {"loss": loss.detach(), "accuracy": acc.detach()}


def link_pred_loss(params: Params, batch: Dict[str, torch.Tensor],
                   cfg: GraphSAGEConfig) -> Tuple[torch.Tensor, Dict]:
    """Unsupervised link prediction: positive pairs score high, sampled
    negatives low.  batch adds src [E], dst [E], neg_dst [E] node
    indices."""
    h = collectives.gather_rows(embed(
        params, batch["features"], batch["neighbors"],
        batch["neighbor_mask"], cfg)).float()
    src = h[batch["src"].long()]
    pos = (src * h[batch["dst"].long()]).sum(-1)
    neg = (src * h[batch["neg_dst"].long()]).sum(-1)
    logits = torch.cat([pos, neg])
    targets = torch.cat([torch.ones_like(pos), torch.zeros_like(neg)])
    loss = collectives.batch_mean(
        torch.clamp(logits, min=0) - logits * targets
        + torch.log1p(torch.exp(-torch.abs(logits))))
    # over every pair of the global batch's edges
    pos_all = collectives.gather_rows(pos.detach())
    neg_all = collectives.gather_rows(neg.detach())
    auc_proxy = (pos_all[:, None] > neg_all[None, :]).float().mean()
    return loss, {"loss": loss.detach(), "auc_proxy": auc_proxy}
