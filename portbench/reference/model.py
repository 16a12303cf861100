"""The decoder in float32: Mistral-7B's layer equations.

RMSNorm, half-split RoPE (theta from the configuration), grouped-query
causal attention (query head h reads key/value head h // (H / Hkv)),
SwiGLU, untied embedding and head, no biases, no sliding window.  Weights
come in the port's stacked layout ({"embed", "layers": {name: [L, ...]},
"final_norm", "lm_head"}, wq [L, d, H, Dh], wo [L, H, Dh, d]) as the
harness made them; any dtype is read as float32.

`quant` (default none) rounds both operands of every matrix product: the
control puts the reference in the program's place a precision lower.
"""

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]
Q_BLOCK = 1024          # attention's query rows a block


def set_exact() -> None:
    """float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _q(x: torch.Tensor, quant: Quant) -> torch.Tensor:
    return x if quant is None else quant(x)


def mm(a: torch.Tensor, b: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    return _q(a, quant) @ _q(b, quant)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    var = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x [S, heads, Dh] at absolute positions [S]; the two halves of each
    head rotate together (not interleaved)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              quant: Quant = None) -> torch.Tensor:
    """Causal attention of one sequence: q [S, H, Dh], k/v [S, Hkv, Dh]
    -> [S, H, Dh], query rows in blocks of Q_BLOCK."""
    S, H, Dh = q.shape
    group = H // k.shape[1]
    kh = k.repeat_interleave(group, dim=1).transpose(0, 1)    # [H, S, Dh]
    vh = v.repeat_interleave(group, dim=1).transpose(0, 1)
    qh = q.transpose(0, 1)
    out = []
    for r0 in range(0, S, Q_BLOCK):
        r1 = min(r0 + Q_BLOCK, S)
        s = mm(qh[:, r0:r1], kh[:, :r1].transpose(1, 2), quant) * Dh ** -0.5
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        cols = torch.arange(r1, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        out.append(mm(torch.softmax(s, dim=-1), vh[:, :r1], quant))
    return torch.cat(out, dim=1).transpose(0, 1)


def layer(t: Dict, w: Dict[str, torch.Tensor], x: torch.Tensor,
          positions: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """One decoder layer over one sequence x [S, d] (float32)."""
    S, d = x.shape
    H, Hkv = t["n_heads"], t["n_kv_heads"]
    Dh = d // H
    h = rms_norm(x, w["ln_attn"], t["norm_eps"])
    q = mm(h, w["wq"].float().reshape(d, H * Dh), quant).view(S, H, Dh)
    k = mm(h, w["wk"].float().reshape(d, Hkv * Dh), quant).view(S, Hkv, Dh)
    v = mm(h, w["wv"].float().reshape(d, Hkv * Dh), quant).view(S, Hkv, Dh)
    q = rope(q, positions, t["rope_theta"])
    k = rope(k, positions, t["rope_theta"])
    o = attention(q, k, v, quant).reshape(S, H * Dh)
    x = x + mm(o, w["wo"].float().reshape(H * Dh, d), quant)
    h = rms_norm(x, w["ln_mlp"], t["norm_eps"])
    gate = mm(h, w["w_gate"].float(), quant)
    up = mm(h, w["w_up"].float(), quant)
    return x + mm(F.silu(gate) * up, w["w_down"].float(), quant)


def layer_weights(params: Dict, i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in params["layers"].items()}


def head(params: Dict, t: Dict) -> torch.Tensor:
    return params["embed"].T if t.get("tie_embeddings") else params["lm_head"]
