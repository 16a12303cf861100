"""Carry parameter trees between the JAX package and the port.

The port keeps the stacked `[L, ...]` layer layout and the key names of
`cloudtik_tpu.models.transformer.init_params` (`wq [L,d,H,Dh]`,
`wo [L,H,Dh,d]`, `w_gate [L,d,f]`, ...), so a conversion is a copy with no
transposes.  The JAX side hands over numpy leaves
(`jax.tree.map(np.asarray, params)`); nothing here imports JAX.
`opt_state_from_jax` carries the optax state of any of the four
optimizers (AdamW, SGD, Adafactor, Lion) over to the port optimizer's.
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


# The node of each optimizer's optax state, by its fields, in the order
# they are looked for (ScaleByAdamState's fields hold ScaleByLionState's).
STATE_NODES = (
    ("ScaleByAdamState", ("count", "mu", "nu")),
    ("FactoredState", ("count", "v_row", "v_col", "v")),
    ("TraceState", ("trace",)),
    ("ScaleByLionState", ("count", "mu")),
)
# the fields that hold parameter-shaped trees
_STATE_TREES = {f for _, fields in STATE_NODES for f in fields} - {"count"}


def _as_dict(node: Any) -> Optional[dict]:
    """A namedtuple's or a dict's fields (orbax's metadata gives a
    namedtuple as a dict), else None."""
    if getattr(node, "_fields", None) is not None:
        return node._asdict()
    return node if isinstance(node, dict) else None


def _find_state(tree: Any, fields) -> Optional[dict]:
    """The first node of an optax state tree that holds all `fields`."""
    node = _as_dict(tree)
    if node is not None and set(fields) <= set(node):
        return node
    children = node.values() if node is not None else (
        tree if isinstance(tree, (list, tuple)) else ())
    for child in children:
        found = _find_state(child, fields)
        if found is not None:
            return found
    return None


def _counts(tree: Any) -> list:
    """Every `count` in an optax state tree (the optimizer's and the
    schedule's), outside the parameter-shaped subtrees."""
    node = _as_dict(tree)
    if node is not None:
        own = [int(np.asarray(node["count"]))] if "count" in node else []
        return own + [c for k, v in node.items()
                      if k != "count" and k not in _STATE_TREES
                      for c in _counts(v)]
    if isinstance(tree, (list, tuple)):
        return [c for v in tree for c in _counts(v)]
    return []


def opt_state_from_jax(tree: Any, device: DeviceLike = None) -> Any:
    """optax's `chain(clip_by_global_norm, <optimizer>)` state (or the
    optimizer's alone), with numpy leaves, -> the port optimizer's state:
    {"count", "mu", "nu"} from `ScaleByAdamState`, {"count", "v_row",
    "v_col", "v"} from `FactoredState` (optax's placeholders kept),
    {"count", "trace"} from `TraceState` or {"count", "mu"} from
    `ScaleByLionState`; the trees as tensors in their own dtypes (a bf16
    mu stays bf16), the int32 count as a Python int.  Every count in the
    tree (the schedule's beside the optimizer's) must be the same step."""
    for _, fields in STATE_NODES:
        node = _find_state(tree, fields)
        if node is not None:
            break
    else:
        raise ValueError(
            "no optimizer state in the tree: looked for "
            + ", ".join(f"{name} {fields}" for name, fields in STATE_NODES))
    counts = _counts(tree)
    if len(set(counts)) != 1:
        raise ValueError(f"optimizer state counts disagree or are "
                         f"missing: {counts}")
    out = {"count": counts[0]}
    out.update((k, params_from_jax(node[k], device))
               for k in fields if k != "count")
    return out
