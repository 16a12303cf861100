"""Carry parameter trees between the JAX package and the port.

The port keeps the stacked `[L, ...]` layer layout and the key names of
`cloudtik_tpu.models.transformer.init_params` (`wq [L,d,H,Dh]`,
`wo [L,H,Dh,d]`, `w_gate [L,d,f]`, ...), so a conversion is a copy with no
transposes.  The JAX side hands over numpy leaves
(`jax.tree.map(np.asarray, params)`); nothing here imports JAX.
`opt_state_from_jax` carries optax's AdamW state over to the port
optimizer's.
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


def _adam_state(tree: Any) -> Optional[Any]:
    """The node of an optax state tree that holds count, mu and nu: a
    `ScaleByAdamState` namedtuple, or the dict orbax's metadata gives it."""
    fields = getattr(tree, "_fields", None)
    if fields is not None and {"count", "mu", "nu"} <= set(fields):
        return tree._asdict()
    if isinstance(tree, dict) and {"count", "mu", "nu"} <= set(tree):
        return tree
    children = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def opt_state_from_jax(tree: Any, device: DeviceLike = None) -> Any:
    """optax's `chain(clip_by_global_norm, adamw)` state (or `adamw`'s
    alone), with numpy leaves, -> the port AdamW's {"count", "mu", "nu"}:
    `ScaleByAdamState`'s moments as tensors in their own dtypes (a bf16 mu
    stays bf16) and its int32 count as a Python int.  The schedule's count
    beside it must be the same step."""
    adam = _adam_state(tree)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the "
                         "optimizer state")
    count = int(np.asarray(adam["count"]))

    def counts(node):
        fields = getattr(node, "_fields", None)
        if fields is not None:
            node = node._asdict()
        if isinstance(node, dict):
            return ([int(np.asarray(node["count"]))] if "count" in node
                    else []) + [c for k, v in node.items()
                                if k not in ("count", "mu", "nu")
                                for c in counts(v)]
        if isinstance(node, (list, tuple)):
            return [c for v in node for c in counts(v)]
        return []

    if set(counts(tree)) != {count}:
        raise ValueError(f"optimizer state counts disagree: "
                         f"{counts(tree)}")
    return {"count": count, "mu": params_from_jax(adam["mu"], device),
            "nu": params_from_jax(adam["nu"], device)}
