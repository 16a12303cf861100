"""Carry parameter trees between the JAX package and the port.

The port keeps the stacked `[L, ...]` layer layout and the key names of
`cloudtik_tpu.models.transformer.init_params` (`wq [L,d,H,Dh]`,
`wo [L,H,Dh,d]`, `w_gate [L,d,f]`, ...), so a conversion is a copy with no
transposes.  The JAX side hands over numpy leaves
(`jax.tree.map(np.asarray, params)`); nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from cloudtik_tpu_torch.device import DeviceLike, resolve_device
from cloudtik_tpu_torch.tree import tree_map


def _leaf_to_torch(a: Any, device: torch.device,
                   dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.array(a)   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        # numpy's bfloat16 comes from ml_dtypes; torch reads its bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree: Any, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dicts and lists of numpy arrays -> the same tree of tensors
    on `device` (cast to `dtype` when given, else each leaf's own dtype)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_to_torch(a, dev, dtype), tree)


def params_to_numpy(tree: Any) -> Any:
    """The inverse: a tree of tensors -> the same tree of numpy arrays
    (`jax.tree.map(jnp.asarray, ...)` takes it back to JAX).  numpy has no
    bfloat16 of its own, so bf16 leaves come back as float32, exactly."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(leaf, tree)
