"""FSDP's gather-on-use for the stacked layer parameters.

The trainer keeps each parameter as this rank's shard.  A leaf of the
`[L, ...]` layer stack with a dimension the model does not read split
(over `fsdp`, or over `tensor` where that is not a Megatron dimension)
becomes a `LayerShards`;
the model's layer loop reads it through `LazyLayer` (what the
transformer's and BERT's `layer_params` return for such a stack; a spec
names its stacks in `ModelSpec.layer_stacks`), which gathers one layer's
slice where the layer reads it.  Inside a checkpointed layer
the gather runs again in the backward pass, so no gathered layer outlives
its use; the gradient comes back reduce-scattered to the shard
(`collectives.gather_dim`).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Tuple

import torch

from cloudtik_tpu_torch.parallel.collectives import gather_dim


class LayerShards:
    """A stacked `[L, ...]` leaf held as this rank's shard.  `gathers`
    lists the (dim, group, summed) all-gathers that make one layer whole,
    in order (dims of the stacked leaf, never 0, the layer axis; a
    dimension split over two mesh axes gathers over the inner one first);
    `summed` is `gather_dim`'s gradient mode."""

    def __init__(self, local: torch.Tensor, gathers: Tuple):
        self.local, self.gathers = local, tuple(gathers)

    def layer(self, i: int) -> torch.Tensor:
        w = self.local[i]
        for dim, group, summed in self.gathers:
            w = gather_dim(w, dim - 1, group, summed)
        return w


class LazyLayer(Mapping):
    """Layer i of a stack whose leaves are tensors or `LayerShards`; a
    key's tensor is made (and gathered) each time it is read."""

    def __init__(self, layers: Dict[str, Any], i: int):
        self._layers, self._i = layers, i

    def __getitem__(self, key: str) -> torch.Tensor:
        w = self._layers[key]
        return w.layer(self._i) if isinstance(w, LayerShards) \
            else w[self._i]

    def __iter__(self):
        return iter(self._layers)

    def __len__(self) -> int:
        return len(self._layers)


def has_shards(layers: Dict[str, Any]) -> bool:
    return any(isinstance(w, LayerShards) for w in layers.values())
