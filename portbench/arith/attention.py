"""Least times of the flash kernels B1-B3 for the work their inputs need.

Frozen copies of `chip_smoke.py`'s `live_pairs`, `attention_bound` and
`attention_bwd_bound`: unmasked (q, kv) pairs only, each input read once,
each output written once, against the H100 SXM's peaks.
"""

from portbench.arith.peaks import H100_BF16_FLOPS, H100_BYTES_PER_S


def live_pairs(S: int, Skv: int, causal: bool) -> int:
    """Unmasked (q, kv) pairs of one head: causal under absolute
    positions, row q sees min(q + 1, Skv) keys."""
    if not causal:
        return S * Skv
    n = min(S, Skv)
    return n * (n + 1) // 2 + max(S - Skv, 0) * Skv


def fwd_bound(B: int, H: int, Hkv: int, S: int, D: int, causal: bool = True,
              Skv: int = 0, elem_bytes: int = 2) -> dict:
    """B1's bound: {"bound_ms", "bound_by", "flops", "bytes"}."""
    Skv = Skv or S
    flops = 4 * B * H * live_pairs(S, Skv, causal) * D
    nbytes = (elem_bytes * (2 * B * H * S * D + 2 * B * Hkv * Skv * D)
              + 4 * B * H * S)
    return _bound(flops, nbytes)


def bwd_bounds(B: int, H: int, Hkv: int, S: int, D: int, causal: bool = True,
               Skv: int = 0, elem_bytes: int = 2) -> dict:
    """B2's ("dq") and B3's ("dkv") bounds: dq 3 products (6 * pairs * D
    flops a head), dk/dv 4 products (8 * pairs * D); inputs q, k, v, do and
    lse and delta in f32 read once, each output written once."""
    Skv = Skv or S
    pairs = live_pairs(S, Skv, causal)
    q_elems = B * H * S * D
    kv_elems = B * Hkv * Skv * D
    stats = 2 * 4 * B * H * S
    inputs = elem_bytes * (2 * q_elems + 2 * kv_elems) + stats
    out = {}
    for name, per_pair, written in (("dq", 6, q_elems),
                                    ("dkv", 8, 2 * kv_elems)):
        out[name] = _bound(per_pair * B * H * pairs * D,
                           inputs + elem_bytes * written)
    return out


def _bound(flops: float, nbytes: float) -> dict:
    t_ops = flops / H100_BF16_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}
