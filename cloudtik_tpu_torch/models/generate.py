"""KV-cache autoregressive generation for the flagship transformer.

Counterpart of the static-cache path of `cloudtik_tpu/models/generate.py`:

* one cache [L, B, max_len, Hkv, Dh] per call, written in place at the
  current length (the JAX version returns new arrays; here `forward_step`
  updates the cache it is given and returns it);
* prefill runs the prompt in one forward against the cache, then one token
  per step, a Python loop over the layers and the steps;
* GQA: the cache stays at n_kv_heads; queries see repeated kv heads only
  inside `_attend`;
* sampling: greedy (`argmax`), temperature, or top-k through
  `torch.multinomial` with the caller's `torch.Generator` (it cannot
  reproduce jax.random draws; greedy output is bit-comparable).

Not here yet: the LoRA branch and the paged helpers, which come with the
serving-engine slice, and MoE layers.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from cloudtik_tpu_torch.device import DeviceLike, resolve_device
from cloudtik_tpu_torch.models.transformer import (
    TransformerConfig, _check_dense, _embed_lookup, _mlp, _proj,
    _rms_norm, _rope, layer_params, logits_f32)

Params = Dict[str, Any]
_NEG = -1e30


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Dict[str, Any]:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "length": 0,
    }


def _attend(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
            start: int, cfg: TransformerConfig) -> torch.Tensor:
    """q [B,S,H,Dh] vs cache k/v [B,T,Hkv,Dh]; query s may see cache
    positions <= start + s.  Returns [B,S,H,Dh] (f32 accumulate)."""
    B, S, H, Dh = q.shape
    T = ck.shape[1]
    groups = H // ck.shape[2]
    ck = ck.repeat_interleave(groups, dim=2)
    cv = cv.repeat_interleave(groups, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(),
                          ck.float()) * (Dh ** -0.5)
    t_pos = torch.arange(T, device=q.device)[None, None, None, :]
    s_pos = start + torch.arange(S, device=q.device)[None, None, :, None]
    scores = torch.where(t_pos <= s_pos, scores,
                         torch.full_like(scores, _NEG))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, cv.float())
    return out.to(q.dtype)


def _layer_step(cfg: TransformerConfig, x: torch.Tensor, layer: Params,
                ck: torch.Tensor, cv: torch.Tensor,
                start: int) -> torch.Tensor:
    """One layer over S new tokens at absolute position `start`.
    ck/cv [B, max_len, Hkv, Dh] are written in place at [start, start+S)."""
    B, S, d = x.shape
    if start + S > ck.shape[1]:
        raise ValueError(f"cache of length {ck.shape[1]} cannot take "
                         f"{S} tokens at position {start}")
    positions = start + torch.arange(S, device=x.device).expand(B, S)
    h = _rms_norm(x, layer["ln_attn"], cfg.norm_eps)
    q = _rope(_proj(h, layer["wq"], cfg), positions, cfg.rope_theta)
    k = _rope(_proj(h, layer["wk"], cfg), positions, cfg.rope_theta)
    v = _proj(h, layer["wv"], cfg)
    ck[:, start:start + S] = k.to(ck.dtype)
    cv[:, start:start + S] = v.to(cv.dtype)
    o = _attend(q, ck, cv, start, cfg)
    wo = layer["wo"].to(cfg.dtype)
    x = x + o.reshape(B, S, -1) @ wo.reshape(-1, d)
    h = _rms_norm(x, layer["ln_mlp"], cfg.norm_eps)
    return x + _mlp(h, layer, cfg)


def forward_step(params: Params, tokens: torch.Tensor,
                 cache: Dict[str, Any], cfg: TransformerConfig
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run S new tokens through all layers against the cache.
    tokens [B, S] -> (logits [B, S, vocab] f32, cache).  The cache is
    updated IN PLACE (k/v written at its length, length advanced) and
    returned for symmetry with the JAX signature."""
    _check_dense(cfg)
    start = cache["length"]
    x = _embed_lookup(params["embed"], tokens, cfg)
    for i in range(cfg.n_layers):
        x = _layer_step(cfg, x, layer_params(params, i), cache["k"][i],
                        cache["v"][i], start)
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache["length"] = start + tokens.shape[1]
    return logits_f32(x, params, cfg), cache


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            temperature: float, top_k: int) -> torch.Tensor:
    """logits [B, V] -> token ids [B] (int64)."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, _NEG),
                             logits)
    probs = F.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).squeeze(-1)


@torch.no_grad()
def generate(params: Params, prompt: torch.Tensor, cfg: TransformerConfig,
             *, max_new_tokens: int = 32, temperature: float = 0.0,
             top_k: int = 0, eos_id: Optional[int] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """prompt [B, S] int -> generated tokens [B, max_new_tokens] (int64;
    positions after EOS are padded with eos_id when given).  Runs where the
    parameters and the prompt lie; `generator` (default: seeded 0 on the
    prompt's device) drives temperature / top-k sampling."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got "
                         f"{max_new_tokens}")
    B, S = prompt.shape
    if generator is None and temperature > 0.0:
        generator = torch.Generator(device=prompt.device).manual_seed(0)
    cache = init_cache(cfg, B, S + max_new_tokens, prompt.device)
    logits, cache = forward_step(params, prompt, cache, cfg)
    tok = _sample(logits[:, -1, :], generator, temperature, top_k)
    done = (tok == eos_id) if eos_id is not None \
        else torch.zeros(B, dtype=torch.bool, device=prompt.device)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = forward_step(params, tok[:, None], cache, cfg)
        tok = _sample(logits[:, -1, :], generator, temperature, top_k)
        if eos_id is not None:
            tok = torch.where(done, torch.full_like(tok, eos_id), tok)
            done = done | (tok == eos_id)
        out.append(tok)
    return torch.stack(out, dim=1)
