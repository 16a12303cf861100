"""Latent-diffusion UNet in PyTorch: the SDXL-family training config.

Counterpart of `cloudtik_tpu/models/diffusion.py`: the same `UNetConfig`,
presets and `flops_per_image`, the same nested parameter tree (NHWC
activations, HWIO kernels, lists of block dicts per stage, the same key
names), so `convert.params_from_jax` is a plain copy.  Epsilon-prediction
MSE under a cosine noise schedule, bf16 compute on f32 params.

What the JAX code does, the port does:

* `_group_norm` normalises with the population variance over (H, W, the
  group's channels) in f32 and casts after the scale (there is no bias).
* `timestep_embedding` puts the cosines before the sines.
* The 2x upsample is `jax.image.resize(..., "nearest")`, whose half-pixel
  rule maps output i to input i // 2: `repeat_interleave(2)` on H and W.
* The stride-2 downsample pads as XLA's SAME does (ops/conv.py), and the
  up path concatenates `[x, skip]` in that order.
* Attention is non-causal with the default scale, through the port's
  `attention` auto rule.  `sdxl_mini` has 8 heads at widths 640 and 1280,
  head dims 80 and 160, which the Hopper flash kernel does not take (it
  takes 64 and 128, as the reference's Pallas kernel takes multiples of
  128): every attention block runs the plain path, as on the reference.

On a mesh (`param_logical_axes`, the reference's tree) a rank holds its
rows of the batch; GroupNorm works per sample, so only the loss is a mean
over the global batch (`collectives.batch_mean`).  The reference's batch
constraint on the stem's output is the port's checked no-op.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from cloudtik_tpu_torch.device import DeviceLike, resolve_device
from cloudtik_tpu_torch.ops.attention import attention
from cloudtik_tpu_torch.ops.conv import (conv_kernel_axes,
                                         conv_kernel_init, conv_nhwc)
from cloudtik_tpu_torch.parallel import collectives
from cloudtik_tpu_torch.parallel.sharding import with_sharding_constraint

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4                   # latent channels
    image_size: int = 64                   # latent HxW
    base_width: int = 320
    width_mults: Tuple[int, ...] = (1, 2, 4)
    blocks_per_stage: int = 2
    attn_stages: Tuple[int, ...] = (1, 2)  # stages with self-attention
    n_heads: int = 8
    time_dim: int = 1280
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    norm_groups: int = 32

    def stage_width(self, stage: int) -> int:
        return self.base_width * self.width_mults[stage]

    def flops_per_image(self) -> float:
        """fwd+bwd (3x fwd) conv+attn FLOPs at the config's latent size
        (the reference's count: the down path's, doubled for the up
        path)."""
        flops = 0.0
        size = self.image_size
        widths = [self.stage_width(s) for s in range(len(self.width_mults))]
        c_in = self.in_channels
        for s, w in enumerate(widths):
            for _ in range(self.blocks_per_stage):
                flops += 2 * 9 * c_in * w * size * size
                flops += 2 * 9 * w * w * size * size
                c_in = w
                if s in self.attn_stages:
                    flops += 8 * w * w * size * size      # qkv+o proj
                    flops += 4 * (size * size) ** 2 * w   # attn matmuls
            if s < len(widths) - 1:
                size //= 2
        return 3.0 * 2 * flops                            # down + up path


PRESETS: Dict[str, UNetConfig] = {
    "sdxl_mini": UNetConfig(),
    "tiny": UNetConfig(in_channels=3, image_size=16, base_width=32,
                       width_mults=(1, 2), blocks_per_stage=1,
                       attn_stages=(1,), n_heads=4, time_dim=64,
                       norm_groups=8),
}


def config(name: str, **overrides) -> UNetConfig:
    return dataclasses.replace(PRESETS[name], **overrides)


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def _resblock_axes(has_skip: bool = False) -> Dict[str, Any]:
    axes = {
        "conv0": conv_kernel_axes(), "conv1": conv_kernel_axes(),
        "norm0": ("norm",), "norm1": ("norm",),
        "time_proj": ("embed", "norm"), "time_bias": ("norm",),
    }
    if has_skip:
        axes["skip"] = conv_kernel_axes()
    return axes


def _attn_axes() -> Dict[str, Any]:
    return {"wqkv": ("embed", None), "wo": (None, "embed"),
            "norm": ("norm",)}


def param_logical_axes(cfg: UNetConfig) -> Params:
    """The reference's logical axes, leaf for leaf."""
    n_stages = len(cfg.width_mults)
    widths = [cfg.stage_width(s) for s in range(n_stages)]

    def stage_axes(s, c_in):
        blocks = []
        for b_i in range(cfg.blocks_per_stage):
            ci = c_in if b_i == 0 else widths[s]
            b = {"res": _resblock_axes(has_skip=ci != widths[s])}
            if s in cfg.attn_stages:
                b["attn"] = _attn_axes()
            blocks.append(b)
        return blocks

    down, c = [], widths[0]
    for s in range(n_stages):
        down.append(stage_axes(s, c))
        c = widths[s]
    up = []
    for s in reversed(range(n_stages)):
        up.append(stage_axes(s, c + widths[s]))
        c = widths[s]
    return {
        "time_mlp0": ("embed", "mlp"), "time_mlp1": ("mlp", "embed"),
        "stem": conv_kernel_axes(),
        "down": down,
        "downsample": [conv_kernel_axes() for _ in range(n_stages - 1)],
        "mid": {"res": _resblock_axes(has_skip=False),
                "attn": _attn_axes()},
        "up": up,
        "upsample": [conv_kernel_axes() for _ in range(n_stages - 1)],
        "out_norm": ("norm",),
        "out_conv": conv_kernel_axes(),
    }


def init_params(generator: torch.Generator, cfg: UNetConfig,
                device: DeviceLike = None) -> Params:
    """Same tree, shapes and dtypes as the JAX `init_params`; draws come
    from `generator` (on `device`), so they differ from jax.random's."""
    dev = resolve_device(device)
    pdt = cfg.param_dtype

    def conv(kh, kw, ci, co):
        return conv_kernel_init(generator, kh, kw, ci, co, pdt, device=dev)

    def dense(ci, co):
        w = torch.empty((ci, co), device=dev, dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return (w * ci ** -0.5).to(pdt)

    def ones(c):
        return torch.ones((c,), device=dev, dtype=pdt)

    def resblock(c_in, c_out):
        b = {"conv0": conv(3, 3, c_in, c_out),
             "conv1": conv(3, 3, c_out, c_out),
             "norm0": ones(c_in), "norm1": ones(c_out),
             "time_proj": dense(cfg.time_dim, c_out),
             "time_bias": torch.zeros((c_out,), device=dev, dtype=pdt)}
        if c_in != c_out:
            b["skip"] = conv(1, 1, c_in, c_out)
        return b

    def attnblock(c):
        return {"wqkv": dense(c, 3 * c), "wo": dense(c, c), "norm": ones(c)}

    def stage(s, c_in, c_out):
        blocks = []
        for b in range(cfg.blocks_per_stage):
            blk = {"res": resblock(c_in if b == 0 else c_out, c_out)}
            if s in cfg.attn_stages:
                blk["attn"] = attnblock(c_out)
            blocks.append(blk)
        return blocks

    n_stages = len(cfg.width_mults)
    widths = [cfg.stage_width(s) for s in range(n_stages)]
    params: Params = {
        "time_mlp0": dense(cfg.time_dim, cfg.time_dim),
        "time_mlp1": dense(cfg.time_dim, cfg.time_dim),
        "stem": conv(3, 3, cfg.in_channels, widths[0]),
        "down": [], "downsample": [], "up": [], "upsample": [],
        "mid": {"res": resblock(widths[-1], widths[-1]),
                "attn": attnblock(widths[-1])},
        "out_norm": ones(widths[0]),
        "out_conv": conv(3, 3, widths[0], cfg.in_channels),
    }
    c = widths[0]
    for s in range(n_stages):
        params["down"].append(stage(s, c, widths[s]))
        c = widths[s]
        if s < n_stages - 1:
            params["downsample"].append(conv(3, 3, c, c))
    for s in reversed(range(n_stages)):
        # up blocks take the skip concat: c + widths[s] channels
        params["up"].append(stage(s, c + widths[s], widths[s]))
        c = widths[s]
        if s > 0:
            params["upsample"].append(conv(3, 3, c, c))
    return params


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of diffusion timesteps. t: [B] -> [B, dim],
    the cosines first."""
    half = dim // 2
    log_max = torch.log(torch.tensor(10_000.0, device=t.device))
    freqs = torch.exp(-log_max * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _group_norm(x: torch.Tensor, scale: torch.Tensor, groups: int,
                eps: float = 1e-5) -> torch.Tensor:
    """NHWC GroupNorm with the population variance, in f32, scaled and
    then cast back to x's dtype."""
    B, H, W, C = x.shape
    g = min(groups, C)
    x32 = x.float().reshape(B, H, W, g, C // g)
    var, mean = torch.var_mean(x32, dim=(1, 2, 4), correction=0,
                               keepdim=True)
    out = ((x32 - mean) * torch.rsqrt(var + eps)).reshape(B, H, W, C)
    return (out * scale.float()).to(x.dtype)


def _resblock(x, p, temb, cfg):
    h = _group_norm(x, p["norm0"], cfg.norm_groups)
    h = conv_nhwc(F.silu(h), p["conv0"], dtype=cfg.dtype)
    t = F.silu(temb) @ p["time_proj"].to(cfg.dtype) \
        + p["time_bias"].to(cfg.dtype)
    h = h + t[:, None, None, :]
    h = _group_norm(h, p["norm1"], cfg.norm_groups)
    h = conv_nhwc(F.silu(h), p["conv1"], dtype=cfg.dtype)
    skip = x if x.shape[-1] == h.shape[-1] else conv_nhwc(
        x, p["skip"], dtype=cfg.dtype)
    return skip + h


def _attnblock(x, p, cfg):
    B, H, W, C = x.shape
    h = _group_norm(x, p["norm"], cfg.norm_groups)
    flat = h.reshape(B, H * W, C)
    qkv = flat @ p["wqkv"].to(cfg.dtype)
    q, k, v = torch.split(qkv, C, dim=-1)
    Dh = C // cfg.n_heads

    def heads(a):                         # [B, S, C] -> [B, H, S, Dh]
        return a.reshape(B, H * W, cfg.n_heads, Dh).transpose(1, 2)

    o = attention(heads(q), heads(k), heads(v), causal=False)
    o = o.transpose(1, 2).reshape(B, H * W, C)
    out = o @ p["wo"].to(cfg.dtype)
    return x + out.reshape(B, H, W, C)


def _stage(x, blocks, temb, cfg):
    for blk in blocks:
        x = _resblock(x, blk["res"], temb, cfg)
        if "attn" in blk:
            x = _attnblock(x, blk["attn"], cfg)
    return x


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC 2x nearest upsample: output (i, j) reads input (i // 2,
    j // 2), as `jax.image.resize(..., "nearest")` does."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def forward(params: Params, latents: torch.Tensor, timesteps: torch.Tensor,
            cfg: UNetConfig) -> torch.Tensor:
    """Predict noise.  latents [B,H,W,C] f32, timesteps [B] -> eps (f32)."""
    temb = timestep_embedding(timesteps, cfg.time_dim).to(cfg.dtype)
    temb = F.silu(temb @ params["time_mlp0"].to(cfg.dtype))
    temb = temb @ params["time_mlp1"].to(cfg.dtype)

    x = conv_nhwc(latents, params["stem"], dtype=cfg.dtype)
    x = with_sharding_constraint(x, "batch", None, None, None)
    skips: List[torch.Tensor] = []
    n_stages = len(cfg.width_mults)
    for s in range(n_stages):
        x = _stage(x, params["down"][s], temb, cfg)
        skips.append(x)
        if s < n_stages - 1:
            x = conv_nhwc(x, params["downsample"][s], stride=2,
                          dtype=cfg.dtype)

    x = _resblock(x, params["mid"]["res"], temb, cfg)
    x = _attnblock(x, params["mid"]["attn"], cfg)

    for i, s in enumerate(reversed(range(n_stages))):
        x = torch.cat([x, skips[s]], dim=-1)
        x = _stage(x, params["up"][i], temb, cfg)
        if s > 0:
            x = upsample_nearest_2x(x)
            x = conv_nhwc(x, params["upsample"][i], dtype=cfg.dtype)

    x = _group_norm(x, params["out_norm"], cfg.norm_groups)
    return conv_nhwc(F.silu(x), params["out_conv"], dtype=cfg.dtype).float()


def cosine_alpha_bar(t: torch.Tensor, s: float = 0.008) -> torch.Tensor:
    """Cosine schedule cumulative signal level; t in [0, 1]."""
    return torch.cos((t + s) / (1 + s) * math.pi / 2) ** 2


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: UNetConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Epsilon-prediction MSE.  batch: latents [B,H,W,C] f32, noise
    [B,H,W,C] f32, t [B] f32 in [0,1) (this rank's rows on a mesh)."""
    latents, noise, t = batch["latents"], batch["noise"], batch["t"]
    ab = cosine_alpha_bar(t)[:, None, None, None]
    noisy = torch.sqrt(ab) * latents + torch.sqrt(1 - ab) * noise
    pred = forward(params, noisy, t * 1000.0, cfg)
    loss = collectives.batch_mean(torch.square(pred - noise))
    return loss, {"loss": loss.detach()}
