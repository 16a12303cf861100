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

The paged helpers (`init_block_pool`, `gather_paged_cache`,
`paged_prefill_chunk`, `paged_verify`, `copy_block`) are the device half of
the serving engine's block pool (serve/engine.py, serve/kvcache.py); they
update the pools in place.  `gather_block_planes` / `scatter_block_planes`
move a request's raw blocks out of one pool and into another (KV-block
migration, serve/migration.py).  `draft_propose` is the draft half of
speculative decoding, and `lora=` applies the gathered batched-adapter
delta (models/lora.py) next to the base projections.  MoE layers route
each call by its own length (ops/moe.py: capacity per batch row), as the
reference's shape-generic `moe_ffn` does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from cloudtik_tpu_torch.device import DeviceLike, resolve_device
from cloudtik_tpu_torch.models import lora as LO
from cloudtik_tpu_torch.models.transformer import (
    TransformerConfig, _embed_lookup, _mlp, _proj,
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


def _qkv(cfg: TransformerConfig, h: torch.Tensor, layer: Params,
         lora=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pre-RoPE projections of the normed input h, each with its
    lane's gathered LoRA delta when `lora` = (layer_planes, idx, scale)
    is given: applied next to the base projection, exactly where a merged
    weight would have acted."""
    q = _proj(h, layer["wq"], cfg)
    k = _proj(h, layer["wk"], cfg)
    v = _proj(h, layer["wv"], cfg)
    if lora is not None:
        planes, idx, scale = lora
        if "wq" in planes:
            q = q + LO.gathered_delta("wq", h, planes, idx, scale)
        if "wk" in planes:
            k = k + LO.gathered_delta("wk", h, planes, idx, scale)
        if "wv" in planes:
            v = v + LO.gathered_delta("wv", h, planes, idx, scale)
    return q, k, v


def _attn_out(cfg: TransformerConfig, o: torch.Tensor, layer: Params,
              lora=None) -> torch.Tensor:
    """o [B,S,H,Dh] through wo, plus the lane's `wo` delta if adapted."""
    d = layer["wo"].shape[-1]
    out = o.reshape(*o.shape[:2], -1) \
        @ layer["wo"].to(cfg.dtype).reshape(-1, d)
    if lora is not None and "wo" in lora[0]:
        planes, idx, scale = lora
        out = out + LO.gathered_delta("wo", o, planes, idx, scale)
    return out


def _layer_step(cfg: TransformerConfig, x: torch.Tensor, layer: Params,
                ck: torch.Tensor, cv: torch.Tensor,
                start: int, lora=None) -> torch.Tensor:
    """One layer over S new tokens at absolute position `start`.
    ck/cv [B, max_len, Hkv, Dh] are written in place at [start, start+S).
    `lora` is the gathered batched-adapter triple (layer_planes, idx,
    scale) (models/lora.py)."""
    B, S, _ = x.shape
    if start + S > ck.shape[1]:
        raise ValueError(f"cache of length {ck.shape[1]} cannot take "
                         f"{S} tokens at position {start}")
    positions = start + torch.arange(S, device=x.device).expand(B, S)
    h = _rms_norm(x, layer["ln_attn"], cfg.norm_eps)
    q, k, v = _qkv(cfg, h, layer, lora)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    ck[:, start:start + S] = k.to(ck.dtype)
    cv[:, start:start + S] = v.to(cv.dtype)
    o = _attend(q, ck, cv, start, cfg)
    x = x + _attn_out(cfg, o, layer, lora)
    h = _rms_norm(x, layer["ln_mlp"], cfg.norm_eps)
    return x + _mlp(h, layer, cfg)


def forward_step(params: Params, tokens: torch.Tensor,
                 cache: Dict[str, Any], cfg: TransformerConfig, lora=None
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run S new tokens through all layers against the cache.
    tokens [B, S] -> (logits [B, S, vocab] f32, cache).  The cache is
    updated IN PLACE (k/v written at its length, length advanced) and
    returned for symmetry with the JAX signature.

    `lora` enables the gathered batched-adapter path: {"planes": {target:
    {a: [L, A, ...], b: [L, A, ...]}}, "idx": [B] int, "scale": float} —
    N heterogeneous adapters in one forward."""
    start = cache["length"]
    x = _embed_lookup(params["embed"], tokens, cfg)
    for i in range(cfg.n_layers):
        layer_lora = None if lora is None else (
            LO.layer_planes(lora["planes"], i), lora["idx"], lora["scale"])
        x = _layer_step(cfg, x, layer_params(params, i), cache["k"][i],
                        cache["v"][i], start, layer_lora)
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


# -- paged KV cache -----------------------------------------------------------
# The serving engine keeps one pool of fixed-size blocks per layer and a
# block table per request (serve/kvcache.py holds the host-side
# bookkeeping).  These helpers are the device half: gather a table into the
# contiguous layout the attention math expects, run the same forward_step
# against it, scatter the written blocks back.  Unused table entries point
# at the reserved null block 0, so every gather/scatter index is valid and
# the garbage it moves is masked by the causal `t <= position` test.


def init_block_pool(cfg: TransformerConfig, num_blocks: int,
                    block_size: int, device: DeviceLike = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V pools [L, num_blocks, block_size, Hkv, Dh], zeroed.  Zeros, not
    `torch.empty`: unallocated table slots gather block 0, whose softmax
    weight is exactly 0, but 0 x NaN is NaN in `probs @ V`, so every block
    must hold finite values."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=dev),
            torch.zeros(shape, dtype=cfg.dtype, device=dev))


def gather_paged_cache(kp: torch.Tensor, vp: torch.Tensor,
                       table: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One request's logical KV sequence, gathered contiguous.

    kp/vp [L, N, bs, Hkv, Dh], table [M] int -> k/v [L, 1, M*bs, Hkv, Dh]
    where logical position p lives at (table[p // bs], p % bs)."""
    L, _N, bs, H, D = kp.shape
    M = table.shape[0]
    return (kp[:, table].reshape(L, 1, M * bs, H, D),
            vp[:, table].reshape(L, 1, M * bs, H, D))


def paged_prefill_chunk(params: Params, kp: torch.Tensor, vp: torch.Tensor,
                        table: torch.Tensor, tokens: torch.Tensor,
                        start: int, cfg: TransformerConfig, lora=None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run one prompt chunk against a paged pool (chunked prefill).

    tokens [1, C] at absolute positions [start, start+C); earlier positions
    (a previous chunk, or prefix-cache blocks reused from another request)
    are read straight out of the pool, which makes chunked prefill and
    prefix reuse the same code path.  Returns (kp, vp, logits [1, C,
    vocab]), the pools updated in place.  The scatter writes back every
    gathered block: blocks outside the chunk's range carry their original
    values, and duplicate null-block entries race only over garbage.

    The gathered plane carries C tokens of zero scratch beyond the table's
    capacity: C is the PADDED chunk width, so start+C may overrun the table
    (a bucket wider than the remaining capacity), and `_layer_step` refuses
    a write past its cache.  Only padding tokens can sit past the capacity;
    they land in the scratch, which the write-back drops.  `lora` as in
    `forward_step`.
    """
    L, _N, bs, H, D = kp.shape
    M = table.shape[0]
    C = tokens.shape[1]
    ck, cv = gather_paged_cache(kp, vp, table)
    scratch = ck.new_zeros((L, 1, C, H, D))
    cache = {"k": torch.cat([ck, scratch], dim=2),
             "v": torch.cat([cv, scratch], dim=2), "length": int(start)}
    logits, cache = forward_step(params, tokens, cache, cfg, lora=lora)
    kp[:, table] = cache["k"][:, 0, :M * bs].reshape(L, M, bs, H, D)
    vp[:, table] = cache["v"][:, 0, :M * bs].reshape(L, M, bs, H, D)
    return kp, vp, logits


def paged_verify(params: Params, kp: torch.Tensor, vp: torch.Tensor,
                 table: torch.Tensor, tokens: torch.Tensor, start: int,
                 cfg: TransformerConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Speculative-decoding verify: ONE target forward over a request's
    proposed positions (Leviathan et al., ICML'23; Chen et al., 2023).

    tokens [1, C] are the request's pending token followed by the draft's
    proposals, at absolute positions [start, start+C).  The logits at
    position i are the target's distribution AFTER consuming
    tokens[:i+1], so their greedy argmax is exactly what token-by-token
    decode would have produced: the caller accepts the longest proposal
    prefix matching them and always takes the target's own token at the
    first mismatch (or the bonus token on full acceptance).

    The same gather -> forward_step -> scatter path as chunked prefill,
    scratch tail included: a window whose padding overruns the table
    lands in scratch.  The write-back rewrites every table block, so the
    caller copies any shared block in the window first; rejected
    positions are the caller's to rewind (stale K/V past the accepted
    cursor is masked, and overwritten before it can be attended).
    """
    return paged_prefill_chunk(params, kp, vp, table, tokens, start, cfg)


def draft_propose(params: Params, token: torch.Tensor, cache: Dict[str, Any],
                  cfg: TransformerConfig, k: int
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """k greedy draft tokens: the draft half of speculative decoding.

    `token` is the request's pending token as a 0-d tensor on the cache's
    device; returns (proposals [k], cache), the cache updated in place:
    proposal i's K/V is written at cache position length+i, the layout the
    verify re-derives on the target side.  The k single-token forwards
    keep each next token on the device (no host sync inside the loop;
    the caller reads the proposals once)."""
    toks = []
    tok = token.reshape(1, 1)
    for _ in range(k):
        logits, cache = forward_step(params, tok, cache, cfg)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        toks.append(tok)
    return torch.cat(toks, dim=1)[0], cache


def copy_block(kp: torch.Tensor, vp: torch.Tensor, src: int, dst: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device-side block copy, in place (the copy-on-write half: the pool
    decides WHEN via needs_copy, this moves the bytes)."""
    kp[:, dst] = kp[:, src]
    vp[:, dst] = vp[:, src]
    return kp, vp


def gather_block_planes(kp: torch.Tensor, vp: torch.Tensor,
                        table: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pull a table's raw block planes out of the pool (KV-block export:
    migration serializes them at block granularity).

    kp/vp [L, N, bs, Hkv, Dh], table [M] int -> k/v [L, M, bs, Hkv, Dh],
    exactly the table's blocks (no padding: the reference pads only so
    that XLA compiles one program).  Each is a view of a block-major copy
    ([M, L, ...] in memory), so block j's planes `k[:, j]` are contiguous
    and serialize without another copy."""
    return (kp.transpose(0, 1)[table].transpose(0, 1),
            vp.transpose(0, 1)[table].transpose(0, 1))


def scatter_block_planes(kp: torch.Tensor, vp: torch.Tensor,
                         table: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write exported block planes into a (different) pool, in place: the
    KV import half of migration.  table [M] int, k/v [L, M, bs, Hkv, Dh]
    on the pool's device, cast to the pool's dtype as the reference's
    `astype` does.  The caller passes only the blocks to write (a prefix
    reused in this pool is not rewritten), and never the null block 0:
    `init_block_pool` keeps every block finite, and nothing is padded onto
    block 0 here."""
    kp[:, table] = k.to(kp.dtype)
    vp[:, table] = v.to(vp.dtype)
    return kp, vp


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
