"""Model FLOPs and bytes of the decoder the configurations describe.

Counted from the configuration's published sizes (the `transformer`
section of a config file), never from the program: `matmul_params` are
the projections a token passes through, the LM head included and the
embedding gather not.  Attention counts the causal pairs at the lengths
the traffic really has, not the configuration's longest context.
"""

from typing import Dict


def layer_params(t: Dict) -> int:
    d, f = t["d_model"], t["d_ff"]
    dh = d // t["n_heads"]
    return (d * t["n_heads"] * dh + 2 * d * t["n_kv_heads"] * dh
            + t["n_heads"] * dh * d + 3 * d * f)


def matmul_params(t: Dict) -> int:
    """The weights a token's forward multiplies by: every layer's and the
    LM head's."""
    return t["n_layers"] * layer_params(t) + t["d_model"] * t["vocab_size"]


def all_params(t: Dict) -> int:
    d = t["d_model"]
    embed = t["vocab_size"] * d
    norms = t["n_layers"] * 2 * d + d
    head = 0 if t.get("tie_embeddings") else d * t["vocab_size"]
    return t["n_layers"] * layer_params(t) + embed + norms + head


def train_flops_per_token(t: Dict, seq_len: int,
                          weight_grads: bool = True) -> float:
    """Forward and backward of one token of a causal sequence of
    `seq_len`: 6 N (4 N when the projections take no weight gradients, a
    frozen base under adapters), plus the attention products: forward
    2 * 2 * d * S / 2 a layer on average over a causal row, three times
    over for forward and backward: 6 * S * d a layer."""
    n = matmul_params(t)
    dense = (6 if weight_grads else 4) * n
    attn = 6 * seq_len * t["d_model"] * t["n_layers"]
    return float(dense + attn)


def forward_flops(t: Dict, position: int) -> float:
    """One token's forward at absolute position `position` (it attends
    over position + 1 keys): 2 N plus 4 * d * (position + 1) a layer."""
    return float(2 * matmul_params(t)
                 + 4 * t["d_model"] * (position + 1) * t["n_layers"])


def kv_bytes_per_token(t: Dict, elem_bytes: int = 2) -> int:
    """K and V of one token over every layer."""
    dh = t["d_model"] // t["n_heads"]
    return 2 * t["n_layers"] * t["n_kv_heads"] * dh * elem_bytes


def decode_step_bytes(t: Dict, lengths, elem_bytes: int = 2) -> float:
    """The least a decode step over lanes at context `lengths` reads and
    writes: every layer's weights and the LM head once, one embedding row
    a lane, each lane's K/V over its context (the new token's written),
    and the f32 logits."""
    d, V = t["d_model"], t["vocab_size"]
    n_lanes = len(lengths)
    weights = elem_bytes * (matmul_params(t) + n_lanes * d
                            + t["n_layers"] * 2 * d + d)
    kv = kv_bytes_per_token(t, elem_bytes) * sum(n + 1 for n in lengths)
    logits = 4 * n_lanes * V
    return float(weights + kv + logits)
