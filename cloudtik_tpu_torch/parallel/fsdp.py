"""FSDP's gather-on-use for the stacked layer parameters.

The trainer keeps each parameter as this rank's shard.  A leaf of the
`[L, ...]` layer stack that is split over `fsdp` becomes a `LayerShards`;
the model's layer loop reads it through `LazyLayer` (what
`models/transformer.layer_params` returns for such a stack), which gathers
one layer's slice where the layer reads it.  Inside a checkpointed layer
the gather runs again in the backward pass, so no gathered layer outlives
its use; the gradient comes back reduce-scattered to the shard
(`collectives.gather_dim`).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict

import torch

from cloudtik_tpu_torch.parallel.collectives import gather_dim


class LayerShards:
    """A stacked `[L, ...]` leaf held as this rank's shard along `dim`
    (never 0, the layer axis) over `group`."""

    def __init__(self, local: torch.Tensor, dim: int, group):
        self.local, self.dim, self.group = local, dim, group

    def layer(self, i: int) -> torch.Tensor:
        return gather_dim(self.local[i], self.dim - 1, self.group)


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
