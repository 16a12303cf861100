"""ResNet (v1.5) in PyTorch: the backbone of the port's detectors.

Counterpart of `cloudtik_tpu/models/resnet.py`.  NHWC activations, HWIO
kernels and the same parameter tree (stages are lists of block dicts), so
`convert.params_from_jax` is a plain copy.  What the JAX code does, the
port does:

* `_batch_norm` always normalises with the batch's own statistics over
  (N, H, W) in f32, at inference too (the JAX module docstring speaks of
  moving stats; the code has none), so `nn.BatchNorm2d` in eval mode would
  be wrong.
* The max-pool is 3x3 stride 2 with XLA's SAME padding filled with -inf,
  (0, 1) at an even size, not the (1, 1) of `F.max_pool2d(padding=1)`.
* Block 0 of every stage has a projection shortcut; v1.5 puts the stride
  on the 3x3 conv.

`loss_fn` is the classifier's training loss: the mean NLL of the f32
logits, with `accuracy` beside it.

On a mesh (`param_logical_axes`, the reference's tree) a rank holds its
rows of the batch.  BN takes its statistics over the global batch, as
GSPMD computes JAX's: two passes, each a sum over the batch axes in the
forward and in the backward (`torch.nn.SyncBatchNorm`'s gradient), and
the loss and accuracy are global means (`collectives.batch_mean`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from cloudtik_tpu_torch.device import DeviceLike, resolve_device
from cloudtik_tpu_torch.ops.conv import (
    conv_kernel_axes, conv_kernel_init, conv_nhwc, pad_same_nchw)
from cloudtik_tpu_torch.parallel import collectives, sharding
from cloudtik_tpu_torch.parallel.mesh import DATA_AXES

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 1000
    image_size: int = 224
    stage_blocks: Tuple[int, ...] = (3, 4, 6, 3)     # resnet50
    stage_widths: Tuple[int, ...] = (256, 512, 1024, 2048)
    stem_width: int = 64
    bottleneck: bool = True
    groups: int = 1                  # ResNeXt cardinality (grouped 3x3)
    width_per_group: int = 64        # ResNeXt bottleneck width basis
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    norm_eps: float = 1e-5

    def flops_per_image(self) -> float:
        """Approximate fwd+bwd FLOPs per image (3x forward)."""
        return 3.0 * _forward_flops(self)


PRESETS: Dict[str, ResNetConfig] = {
    "resnet50": ResNetConfig(),
    "resnet18": ResNetConfig(stage_blocks=(2, 2, 2, 2),
                             stage_widths=(64, 128, 256, 512),
                             bottleneck=False),
    "resnet34": ResNetConfig(stage_blocks=(3, 4, 6, 3),
                             stage_widths=(64, 128, 256, 512),
                             bottleneck=False),
    "tiny": ResNetConfig(num_classes=10, image_size=32,
                         stage_blocks=(1, 1), stage_widths=(64, 128),
                         stem_width=16),
    "resnext50_32x4d": ResNetConfig(groups=32, width_per_group=4),
    "resnext101_32x16d": ResNetConfig(stage_blocks=(3, 4, 23, 3),
                                      groups=32, width_per_group=16),
}


def _mid_width(cfg: ResNetConfig, width: int) -> int:
    """Bottleneck inner width (torchvision formula): planes scaled by
    width_per_group/64, times cardinality."""
    return int((width // 4) * cfg.width_per_group / 64.0) * cfg.groups


def config(name: str, **overrides) -> ResNetConfig:
    return dataclasses.replace(PRESETS[name], **overrides)


def _forward_flops(cfg: ResNetConfig) -> float:
    """2 * MACs of every conv + the fc, at the config's image size."""
    flops = 0.0
    size = cfg.image_size // 2                       # stem stride 2
    flops += 2 * (7 * 7 * 3 * cfg.stem_width) * size * size
    size //= 2                                       # maxpool
    c_in = cfg.stem_width
    for stage, (n_blocks, width) in enumerate(
            zip(cfg.stage_blocks, cfg.stage_widths)):
        stride = 1 if stage == 0 else 2
        for block in range(n_blocks):
            s = stride if block == 0 else 1
            out_size = size // s
            if cfg.bottleneck:
                mid = _mid_width(cfg, width)
                flops += 2 * (c_in * mid) * out_size ** 2            # 1x1
                flops += 2 * (9 * mid * mid // cfg.groups) \
                    * out_size ** 2                                  # 3x3
                flops += 2 * (mid * width) * out_size ** 2           # 1x1
            else:
                flops += 2 * (9 * c_in * width) * out_size ** 2
                flops += 2 * (9 * width * width) * out_size ** 2
            if block == 0:
                flops += 2 * (c_in * width) * out_size ** 2          # proj
            c_in = width
            size = out_size
    flops += 2 * c_in * cfg.num_classes
    return flops


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def _block_axes(bottleneck: bool) -> Dict[str, Any]:
    n_convs = 3 if bottleneck else 2
    axes: Dict[str, Any] = {}
    for i in range(n_convs):
        axes[f"conv{i}"] = conv_kernel_axes()
        axes[f"scale{i}"] = ("norm",)
        axes[f"bias{i}"] = ("norm",)
    return axes


def param_logical_axes(cfg: ResNetConfig) -> Params:
    """The reference's logical axes, leaf for leaf: conv kernels' rows on
    `conv_in`, columns on `conv_out`, the classifier on (embed, vocab)."""
    axes: Dict[str, Any] = {
        "stem": {"conv": conv_kernel_axes(), "scale": ("norm",),
                 "bias": ("norm",)},
        "fc": {"kernel": ("embed", "vocab"), "bias": ("vocab",)},
    }
    for stage, n_blocks in enumerate(cfg.stage_blocks):
        blocks = []
        for block in range(n_blocks):
            b = _block_axes(cfg.bottleneck)
            if block == 0:
                b["proj"] = conv_kernel_axes()
                b["proj_scale"] = ("norm",)
                b["proj_bias"] = ("norm",)
            blocks.append(b)
        axes[f"stage{stage}"] = blocks
    return axes


def init_params(generator: torch.Generator, cfg: ResNetConfig,
                device: DeviceLike = None) -> Params:
    """Same tree, shapes and dtypes as the JAX `init_params`; draws come
    from `generator` (on `device`), so they differ from jax.random's."""
    dev = resolve_device(device)
    pdt = cfg.param_dtype

    def conv(kh, kw, ci, co, groups=1):
        return conv_kernel_init(generator, kh, kw, ci, co, pdt,
                                groups=groups, device=dev)

    def norm_pair(c):
        return (torch.ones((c,), dtype=pdt, device=dev),
                torch.zeros((c,), dtype=pdt, device=dev))

    scale, bias = norm_pair(cfg.stem_width)
    params: Params = {"stem": {"conv": conv(7, 7, 3, cfg.stem_width),
                               "scale": scale, "bias": bias}}
    c_in = cfg.stem_width
    for stage, (n_blocks, width) in enumerate(
            zip(cfg.stage_blocks, cfg.stage_widths)):
        blocks: List[Params] = []
        for block in range(n_blocks):
            b: Params = {}
            if cfg.bottleneck:
                mid = _mid_width(cfg, width)
                shapes = [(1, 1, c_in, mid, 1),
                          (3, 3, mid, mid, cfg.groups),
                          (1, 1, mid, width, 1)]
            else:
                shapes = [(3, 3, c_in, width, 1), (3, 3, width, width, 1)]
            for i, (kh, kw, ci, co, g) in enumerate(shapes):
                b[f"conv{i}"] = conv(kh, kw, ci, co, g)
                b[f"scale{i}"], b[f"bias{i}"] = norm_pair(co)
            if block == 0:
                b["proj"] = conv(1, 1, c_in, width)
                b["proj_scale"], b["proj_bias"] = norm_pair(width)
            blocks.append(b)
            c_in = width
        params[f"stage{stage}"] = blocks
    fc = torch.empty((c_in, cfg.num_classes), dtype=torch.float32,
                     device=dev)
    torch.nn.init.trunc_normal_(fc, 0.0, 1.0, -2.0, 2.0, generator=generator)
    params["fc"] = {
        "kernel": (fc * c_in ** -0.5).to(pdt),
        "bias": torch.zeros((cfg.num_classes,), dtype=pdt, device=dev),
    }
    return params


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _global_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the batch axes, forward and backward: every rank's
    loss reads the sum, so each rank's share of its gradient is summed
    back to every rank's rows (`reduce_sum` alone would leave each its
    own share)."""
    return collectives.copy_to(collectives.reduce_sum(x, DATA_AXES),
                               DATA_AXES)


def _batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Per-batch statistics over (N, H, W) in f32 (train-mode BN), as the
    JAX code computes them at inference too; on a mesh over the global
    batch, in two passes as `jnp.var` takes them."""
    x32 = x.float()
    if collectives.groups_for(DATA_AXES):
        n = x32.numel() // x32.shape[-1] * math.prod(
            sharding.mesh_axis_size(a) for a in DATA_AXES)
        mean = _global_sum(x32.sum(dim=(0, 1, 2), keepdim=True)) / n
        var = _global_sum((x32 - mean).square().sum(
            dim=(0, 1, 2), keepdim=True)) / n
    else:
        mean = x32.mean(dim=(0, 1, 2), keepdim=True)
        var = x32.var(dim=(0, 1, 2), unbiased=False, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    out = normed * scale.float() + bias.float()
    return out.to(x.dtype)


def _block(x: torch.Tensor, b: Params, cfg: ResNetConfig,
           stride: int) -> torch.Tensor:
    shortcut = x
    n_convs = 3 if cfg.bottleneck else 2
    h = x
    for i in range(n_convs):
        # v1.5: the stride lives on the 3x3 conv
        s = stride if (i == (1 if cfg.bottleneck else 0)) else 1
        g = cfg.groups if (cfg.bottleneck and i == 1) else 1
        h = conv_nhwc(h, b[f"conv{i}"], stride=s, dtype=cfg.dtype, groups=g)
        h = _batch_norm(h, b[f"scale{i}"], b[f"bias{i}"], cfg.norm_eps)
        if i < n_convs - 1:
            h = torch.relu(h)
    if "proj" in b:
        shortcut = conv_nhwc(shortcut, b["proj"], stride=stride,
                             dtype=cfg.dtype)
        shortcut = _batch_norm(shortcut, b["proj_scale"], b["proj_bias"],
                               cfg.norm_eps)
    return torch.relu(h + shortcut)


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max-pool of NHWC x with XLA's SAME padding at -inf."""
    xc = x.permute(0, 3, 1, 2)
    xc = pad_same_nchw(xc, 3, 3, 2, value=float("-inf"))
    return F.max_pool2d(xc, 3, 2).permute(0, 2, 3, 1)


def forward_features(params: Params, images: torch.Tensor,
                     cfg: ResNetConfig,
                     last_stage: Optional[int] = None) -> List[torch.Tensor]:
    """images [B, H, W, 3] -> per-stage feature maps (NHWC, model dtype);
    stage i has stride 4*2^i relative to the input.  `last_stage` stops
    after that stage (XLA drops the unread stages under `jit`; eager torch
    would run them), so the list holds stages 0..last_stage."""
    last = len(cfg.stage_blocks) - 1 if last_stage is None else last_stage
    x = conv_nhwc(images, params["stem"]["conv"], stride=2, dtype=cfg.dtype)
    x = _batch_norm(x, params["stem"]["scale"], params["stem"]["bias"],
                    cfg.norm_eps)
    x = _max_pool_same(torch.relu(x))
    feats: List[torch.Tensor] = []
    for stage in range(last + 1):
        stride = 1 if stage == 0 else 2
        for block, b in enumerate(params[f"stage{stage}"]):
            x = _block(x, b, cfg, stride if block == 0 else 1)
        feats.append(x)
    return feats


def forward(params: Params, images: torch.Tensor,
            cfg: ResNetConfig) -> torch.Tensor:
    """images [B, H, W, 3] -> logits [B, num_classes] (f32)."""
    x = forward_features(params, images, cfg)[-1]
    x = x.mean(dim=(1, 2)).float()                    # global avg pool
    fc = params["fc"]
    return x @ fc["kernel"].float() + fc["bias"].float()


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ResNetConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: images [B, H, W, 3] f32, labels [B] int (this rank's rows
    on a mesh); the metrics detached."""
    logits = forward(params, batch["images"], cfg)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits, dim=-1)
    loss = collectives.batch_mean(-logp.gather(-1, labels[:, None]))
    return loss, {
        "loss": loss.detach(),
        "accuracy": collectives.batch_mean(
            (logits.argmax(-1) == labels).float()),
    }
