"""The weights of a run, drawn on the card from the run's seed.

Every leaf of the port's parameter layout has a generator of its own,
seeded from (seed, leaf), so one call a leaf draws it in the dtype it is
served or trained in, and any leaf can be drawn again alone (the
reference reads a leaf's starting value so, after the program's state is
gone).  Projections are normal times fan_in**-0.5, the embedding normal,
norm scales 1 + 0.1 normal (so a norm that drops its scale is seen).
"""

from typing import Dict, Tuple

import torch

# (leaf, stacked over layers, fan_in key) in the port's layout
LEAVES = (("embed", False, None), ("wq", True, "d"), ("wk", True, "d"),
          ("wv", True, "d"), ("wo", True, "hd"), ("ln_attn", True, "norm"),
          ("ln_mlp", True, "norm"), ("w_gate", True, "d"),
          ("w_up", True, "d"), ("w_down", True, "f"),
          ("final_norm", False, "norm"), ("lm_head", False, "d"))


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def leaf_shape(t: Dict, name: str) -> Tuple[int, ...]:
    d, f, L, V = t["d_model"], t["d_ff"], t["n_layers"], t["vocab_size"]
    H, Hkv = t["n_heads"], t["n_kv_heads"]
    Dh = d // H
    return {"embed": (V, d), "wq": (L, d, H, Dh), "wk": (L, d, Hkv, Dh),
            "wv": (L, d, Hkv, Dh), "wo": (L, H, Dh, d), "ln_attn": (L, d),
            "ln_mlp": (L, d), "w_gate": (L, d, f), "w_up": (L, d, f),
            "w_down": (L, f, d), "final_norm": (d,),
            "lm_head": (d, V)}[name]


def make_leaf(t: Dict, name: str, seed: int, device, dtype) -> torch.Tensor:
    index = [n for n, _, _ in LEAVES].index(name)
    _, _, fan = LEAVES[index]
    gen = torch.Generator(device=device).manual_seed(seed * 64 + index)
    w = torch.randn(leaf_shape(t, name), generator=gen, device=device,
                    dtype=dtype)
    if fan == "norm":
        return w.mul_(0.1).add_(1.0)
    if fan is not None:
        fan_in = {"d": t["d_model"], "hd": t["d_model"],
                  "f": t["d_ff"]}[fan]
        w.mul_(fan_in ** -0.5)
    return w


def make_params(t: Dict, seed: int, device, dtype) -> Dict:
    """The whole tree in the port's layout (`models/transformer.py`)."""
    params: Dict = {"layers": {}}
    for name, stacked, _ in LEAVES:
        if name == "lm_head" and t.get("tie_embeddings"):
            continue
        w = make_leaf(t, name, seed, device, dtype)
        (params["layers"] if stacked else params)[name] = w
    return params


# ------------------------------------------------------------- adapters --
# LoRA pairs in the port's layout (models/lora.py): for a target whose
# input is the embedding (wq, wk, wv), a [L, d, r] and b [L, r, heads, Dh].

def adapter_shape(t: Dict, lora: Dict, path: str) -> Tuple[int, ...]:
    target, part = path.split(".")
    d, L, r = t["d_model"], t["n_layers"], lora["rank"]
    heads = t["n_heads"] if target == "wq" else t["n_kv_heads"]
    if target not in ("wq", "wk", "wv"):
        raise ValueError(f"adapters on {target} are not drawn here")
    return (L, d, r) if part == "a" else (L, r, heads, d // t["n_heads"])


def adapter_paths(lora: Dict):
    return [f"{target}.{part}" for target in lora["targets"]
            for part in ("a", "b")]


def make_adapter_leaf(t: Dict, lora: Dict, path: str, seed: int, device,
                      dtype) -> torch.Tensor:
    """a normal times d**-0.5; b normal times `b_std` (an adapter part way
    through its training, so that every factor has a gradient)."""
    index = 32 + adapter_paths(lora).index(path)
    gen = torch.Generator(device=device).manual_seed(seed * 64 + index)
    w = torch.randn(adapter_shape(t, lora, path), generator=gen,
                    device=device, dtype=dtype)
    std = t["d_model"] ** -0.5 if path.endswith(".a") else lora["b_std"]
    return w.mul_(std)


def make_adapters(t: Dict, lora: Dict, seed: int, device, dtype) -> Dict:
    out: Dict = {}
    for path in adapter_paths(lora):
        target, part = path.split(".")
        out.setdefault(target, {})[part] = make_adapter_leaf(
            t, lora, path, seed, device, dtype)
    return out
